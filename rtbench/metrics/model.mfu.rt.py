"""Model: the FLOPs the served requests need (counting.request_work) over
the seconds of every measured dispatch (the ``prefill.ragged``,
``decode.window`` and ``bulk_batch`` spans, a bulk batch's divided by the
persona's ``cpu_slowdown``), as a share of the H100's 989 TFLOP/s (%).
Needs the traced run's spans."""

DISPATCH = ("prefill.ragged", "decode.window")


def read(ctx):
    s = sum(d for n, d in ctx["spans"] if n in DISPATCH)
    s += sum(d for n, d in ctx["spans"]
             if n == "bulk_batch") / ctx["cpu_slowdown"]
    if not s:
        return None
    return 100.0 * ctx["work"]["model_flops"] / s / ctx["peak_flops"]
