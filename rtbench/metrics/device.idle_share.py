"""Device (H100): the share of the profiled serve in which no kernel, copy
or fill ran on the card: 1 less the union of the profiler's device
intervals over the window's length (%)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
