"""Fused RMSNorm: the hand-written CUDA kernel and its plain version.

Port of ``repro.kernels.rmsnorm.rms_norm`` (the Pallas TPU kernel
``_rms_kernel``): every row of ``x (..., D)`` becomes
``x * rsqrt(mean(x^2) + eps) * (1 + w)``, reduced and scaled in float32
and cast to x's dtype.

Dispatch: a CUDA tensor launches the kernel in ``csrc/rms_norm.cu`` (x and
w each bf16 or float32) or raises; a CPU tensor takes the plain version
(``ref.rms_norm_ref``).  ``launches`` counts kernel launches.

``add_rms_norm`` is the paged model path's residual add and the norm after
it in one launch (``rtlm_add_rms_norm``: ``x + y`` rounded as torch's add,
then the norm of that sum), dispatched as ``rms_norm`` is.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from ._build import F, I, P
from .ref import rms_norm_ref

NAME = "rms_norm"
SOURCE = "src/repro_torch/csrc/rms_norm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:30"

launches = 0

_self = sys.modules[__name__]
_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, weight) -> None:
    D = x.shape[-1]
    if tuple(weight.shape) != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} for x "
                         f"{tuple(x.shape)}")
    _build.check_tensors((("x", x, _DTYPES), ("weight", weight, _DTYPES)))


def rms_norm(x, weight, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D); weight (D,).  Returns x's shape and dtype."""
    if not _build.on_card(x):
        return rms_norm_ref(x, weight, eps)
    _check(x, weight)
    D = x.shape[-1]
    out = torch.empty_like(x)
    _build.launch(_self, "rtlm_rms_norm", [P, P, P, I, I, I, I, F],
                  x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                  x.numel() // D if D else 0, D,
                  int(x.dtype == torch.bfloat16),
                  int(weight.dtype == torch.bfloat16), eps, device=x.device)
    return out


def add_rms_norm(x, y, weight, eps: float = 1e-6):
    """x, y (..., D) of one dtype; weight (D,).  Returns ``(s, out)``: the
    sum ``s = x + y`` and ``out = rms_norm(s)``, both of x's shape and
    dtype."""
    if not _build.on_card(x):
        s = x + y
        return s, rms_norm_ref(s, weight, eps)
    _check(x, weight)
    if y.shape != x.shape:
        raise ValueError(f"y {tuple(y.shape)} for x {tuple(x.shape)}")
    _build.check_tensors((("x", x, x.dtype), ("y", y, x.dtype)))
    D = x.shape[-1]
    s, out = torch.empty_like(x), torch.empty_like(x)
    _build.launch(_self, "rtlm_add_rms_norm", [P, P, P, P, P, I, I, I, I, F],
                  x.data_ptr(), y.data_ptr(), weight.data_ptr(),
                  s.data_ptr(), out.data_ptr(), x.numel() // D if D else 0,
                  D, int(x.dtype == torch.bfloat16),
                  int(weight.dtype == torch.bfloat16), eps, device=x.device)
    return s, out
