"""Engine loop (serving/engine.py, serving/pipeline.py): the share of the
window's wall seconds outside every measured dispatch (%): 1 less the sum
of the ``prefill.ragged``, ``decode.window`` and ``bulk_batch`` spans over
the wall.  A bulk batch's span is its measured seconds times the persona's
``cpu_slowdown`` (the bulk lane's emulation); it counts here divided by
that factor, as the seconds it held the card.  Needs the traced run's
``Observability`` spans."""

DISPATCH = ("prefill.ragged", "decode.window")


def read(ctx):
    if not ctx["spans"]:
        return None
    charged = sum(d for n, d in ctx["spans"] if n in DISPATCH)
    charged += sum(d for n, d in ctx["spans"]
                   if n == "bulk_batch") / ctx["cpu_slowdown"]
    return 100.0 * (1.0 - charged / ctx["wall_s"])
