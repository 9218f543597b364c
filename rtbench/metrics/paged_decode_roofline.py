"""Kernels (kernels/paged_decode_attention.py, csrc/paged_decode_attention.cu):
the least time the card could take for the paged decode attention that
the requests of the traced run's profiled serve need (counting: each
fed-back token's query against its live keys and values, read once;
bound_s at 989 TFLOP/s and 3.35 TB/s), over the kernel's summed device
time in that serve (``paged_decode_split_kernel`` +
``paged_decode_combine_kernel``, from the profiler), as a share (%)."""

import counting


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = (tr["kernel_s"]["paged_decode_split_kernel"]
         + tr["kernel_s"]["paged_decode_combine_kernel"])
    w = tr["work"]
    if not t or not w["decode_flops"]:
        return None
    return 100.0 * counting.bound_s(w["decode_bytes"], w["decode_flops"]) / t
