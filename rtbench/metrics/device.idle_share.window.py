"""Device (H100): the share of the window's wall seconds in which the
card ran none of the engine's dispatches: 1 less the summed ``device.*``
spans over the wall (%).  Each span is one dispatch's interval on the
card, from a CUDA timing event captured as its graph's first node to the
readback's completion event, put on the wall clock; dispatches run one
after another on the engine's stream, so the spans do not overlap.  Read
on the unprofiled window itself, beside ``device.idle_share``'s profiled
replay.  The host's input copies and graph launch fall outside the
spans, but a gap inside a replay counts as busy, so this is a lower
bound of the card's idle share.  None without the spans (on the CPU, or
a program that records none)."""


def read(ctx):
    busy = [d for n, d in ctx["spans"] if n.startswith("device.")]
    if not busy:
        return None
    return 100.0 * (1.0 - sum(busy) / ctx["wall_s"])
