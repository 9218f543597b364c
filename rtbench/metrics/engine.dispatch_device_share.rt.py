"""Engine loop (serving/engine.py, serving/pipeline.py): the share of the
dispatch seconds the engine charges to its clock that the card spent on
the dispatches (%): the summed ``device.*`` spans over the summed
``prefill.ragged`` and ``decode.window`` spans plus the ``bulk_batch``
spans divided by the persona's ``cpu_slowdown`` (as ``model.mfu.rt``
counts them).  A device span runs from a CUDA timing event captured as
the dispatch graph's first node to the readback's completion event.  The
rest of a charged ``dt`` is the host's: before the graph starts, the
decode window's block-table extension (its ``dt`` starts ahead of it),
the static input copies and the graph launch; after the readback, the
completion worker's handoff to the serve loop.  None without the device
spans (on the CPU, or a program that records none)."""

DISPATCH = ("prefill.ragged", "decode.window")


def read(ctx):
    dev = [d for n, d in ctx["spans"] if n.startswith("device.")]
    charged = sum(d for n, d in ctx["spans"] if n in DISPATCH)
    charged += sum(d for n, d in ctx["spans"]
                   if n == "bulk_batch") / ctx["cpu_slowdown"]
    if not dev or not charged:
        return None
    return 100.0 * sum(dev) / charged
