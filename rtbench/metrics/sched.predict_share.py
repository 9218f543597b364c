"""Policy and admission (core/predictor.py): the wall seconds of the
engine's ``host.predict`` phase, m_theta scoring the whole schedule at
the serve's start, as a share of the window's wall seconds (%).  It is
the scoring part of ``sched.overhead_share``.  None without the phase's
spans (a program that records none)."""


def read(ctx):
    s = [d for n, d in ctx["spans"] if n == "host.predict"]
    return 100.0 * sum(s) / ctx["wall_s"] if s else None
