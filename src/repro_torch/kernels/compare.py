"""The one rule that holds a kernel's output against its plain version.

A kernel and its plain version both compute in float32 and round once to
the output dtype (bf16 on the serving path); only their order of
summation differs.  So an element may land one bf16 ulp apart, and one ulp
is at most 2^-7 of the element's magnitude.  An element is held within

    RTOL * (|plain| + mean |plain|),    RTOL = 2^-5,

four times that worst gap.  The mean term lets an element near zero,
whose own ulp is tiny, differ as much as a typical element of the same
output may.  The limit scales with what is compared: attention over a few
thousand keys gives outputs of ~0.03, RMSNorm outputs reach ~5.
"""

from __future__ import annotations

import torch

RTOL = 2.0 ** -5


def compare(out: torch.Tensor, plain: torch.Tensor):
    """``(max abs err, share)``: ``share`` is the largest ratio of an
    element's error to its limit, so ``share <= 1`` holds the output to
    the rule; a non-finite output gives ``inf``."""
    o, r = out.float(), plain.float()
    if o.shape != r.shape:
        raise ValueError(f"shapes {tuple(o.shape)} and {tuple(r.shape)}")
    if o.numel() == 0:
        return 0.0, 0.0
    if not torch.isfinite(o).all():
        return float("inf"), float("inf")
    err = (o - r).abs()
    limit = RTOL * (r.abs() + r.abs().mean())
    ratio = torch.where(limit > 0, err / limit.clamp(min=1e-38),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(err.max()), float(ratio.max())


def within(out: torch.Tensor, plain: torch.Tensor) -> bool:
    """Whether ``out`` holds to the rule against ``plain``."""
    return compare(out, plain)[1] <= 1.0
