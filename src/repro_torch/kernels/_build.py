"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/lib<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source, the shared header and the compiler flags, so
an edited source rebuilds and an unchanged one is reused.  The libraries
expose a plain C interface (no PyTorch headers: ``nvcc`` takes seconds, not
minutes).  Nothing is compiled at import time: ``load`` builds on first
use, and ``build`` compiles several libraries with one ``nvcc`` process
each, all started together.  A missing ``nvcc`` or a failed compile raises.

The launch protocol every wrapper shares is here too: ``on_card`` sends a
CPU tensor to the plain version and refuses other devices,
``check_tensors`` holds the kernel's arguments to one device, their types
and contiguity, and ``launch`` calls a library's symbol on the current
stream, raises on a CUDA error and counts the launch in the wrapper's
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
COMMON = ("attn_common.cuh", "mma_attn.cuh", "prefill_attn.cuh",
          "rtlm_api.cuh", "split_decode.cuh", "wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + COMMON:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all in parallel.  Returns seconds per library
    (0.0 for one already built).  The ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    seconds = {n: 0.0 for n in names if n not in todo}
    if not todo:
        return seconds
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}, see "
                          f"{out.with_suffix('.log')}:\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.rtlm_error_string.argtypes = [ctypes.c_int]
        lib.rtlm_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


DTypes = Union[torch.dtype, Tuple[torch.dtype, ...]]


def check_tensors(specs: Sequence[Tuple[str, torch.Tensor, DTypes]]) -> None:
    """Each ``(name, tensor, dtype or dtypes)`` on the first one's device,
    of a dtype the kernel takes, and contiguous."""
    device = specs[0][1].device
    for name, t, dt in specs:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, {specs[0][0]} on "
                             f"{device}")
        allowed = dt if isinstance(dt, tuple) else (dt,)
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {t.dtype}, the kernel takes "
                            + " or ".join(str(a) for a in allowed))
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


#: the head dims the tensor-core attention kernels are compiled for
#: (csrc/mma_attn.cuh): a head dim is zero-padded up to the next one
HEAD_DIMS = (32, 64, 128, 256)


def padded_head_dim(D: int) -> int:
    """The compile-time width the tensor-core attention kernels pad head
    dim ``D`` to; raises for a ``D`` they do not take (their 16-byte
    copies need a multiple of 8)."""
    if D > 0 and D % 8 == 0:
        for p in HEAD_DIMS:
            if D <= p:
                return p
    raise ValueError(f"head dim {D}: the tensor-core attention kernels take "
                     f"a multiple of 8 up to {HEAD_DIMS[-1]}")


def check_aligned(specs: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Each tensor starts on a 16-byte boundary (16-byte copies)."""
    for name, t in specs:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` returns, without
    building a Stream object for every launch (the decode loop is
    host-bound, one launch per layer and step)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


#: (library, symbol) -> the ctypes function, its argument types set once
_symbols: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def launch(module: ModuleType, symbol: str, argtypes: Sequence, *args,
           device: torch.device) -> None:
    """Call ``symbol`` of the library of ``module.NAME`` with ``args`` and
    the current stream of ``device`` as its last argument, raise if it
    returns a CUDA error code, and add one to ``module.launches``."""
    key = (module.NAME, symbol)
    fn = _symbols.get(key)
    if fn is None:
        fn = getattr(load(module.NAME), symbol)
        fn.argtypes = [*argtypes, P]
        fn.restype = ctypes.c_int
        _symbols[key] = fn
    rc = fn(*args, current_stream(device))
    if rc != 0:
        msg = load(module.NAME).rtlm_error_string(rc).decode()
        raise RuntimeError(f"{module.NAME}: CUDA error {rc} ({msg})")
    module.launches += 1
