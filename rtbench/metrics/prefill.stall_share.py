"""Chunk plan (prefill/scheduler.py): engine-clock seconds of fused
prefills that ran while decode slots waited (``prefill_stall_s``), as a
share of the engine clock's span (%)."""


def read(ctx):
    span = ctx["clock_end_s"]
    return 100.0 * ctx["result"]["prefill_stall_s"] / span if span else None
