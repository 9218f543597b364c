"""Policy and admission: the host seconds the engine timed around m_theta's
scoring and ``policy.admit`` (``scheduler_overhead_s``), as a share of the
window's wall seconds (%)."""


def read(ctx):
    return 100.0 * ctx["result"]["scheduler_overhead_s"] / ctx["wall_s"]
