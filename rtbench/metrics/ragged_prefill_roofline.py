"""Kernels (kernels/ragged_chunked_prefill.py, csrc/ragged_chunked_prefill.cu):
the least time the card could take for the prompt attention that the
requests of the traced run's profiled serve need (counting: each prompt
token's query against the keys at and before it, without the bucket's
padding; q, the output and the new keys and values moved once), over the
fused prefill kernel's summed device time in that serve
(``ragged_prefill_kernel``, from the profiler), as a share (%)."""

import counting


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = tr["kernel_s"]["ragged_prefill_kernel"]
    w = tr["work"]
    if not t or not w["prefill_flops"]:
        return None
    return 100.0 * counting.bound_s(w["prefill_bytes"],
                                    w["prefill_flops"]) / t
