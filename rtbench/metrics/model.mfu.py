"""Model: the FLOPs the served requests need (counting.request_work) over
the window's wall seconds, as a share of the H100's 989 TFLOP/s (%)."""


def read(ctx):
    return (100.0 * ctx["work"]["model_flops"] / ctx["wall_s"]
            / ctx["peak_flops"])
