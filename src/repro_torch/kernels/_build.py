"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/lib<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source, the shared header and the compiler flags, so
an edited source rebuilds and an unchanged one is reused.  The libraries
expose a plain C interface (no PyTorch headers: ``nvcc`` takes seconds, not
minutes).  Nothing is compiled at import time: ``load`` builds on first
use, and ``build`` compiles several libraries with one ``nvcc`` process
each, all started together.  A missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
COMMON = ("attn_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.rtlm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
