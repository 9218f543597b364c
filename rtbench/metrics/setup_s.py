"""Seconds from the process's start to the start of the window: imports,
the kernels' build or load, the weights, m_theta, the warm-up serve."""


def read(ctx):
    return ctx["setup_s"]
