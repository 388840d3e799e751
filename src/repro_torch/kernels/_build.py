"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so one ``nvcc`` call per source takes seconds. Sources build at first use
into ``build/repro_torch/`` at the root of the checkout, one shared library
per source, named by a hash of the source and the flags — an edited source
gets a fresh library, an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from repro_torch import compat

__all__ = ["KERNELS", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load"]

KERNELS = ("window_score", "segment_sum")
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/src/repro_torch/kernels/_build.py -> <checkout>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's diagnostics of the last build in this process (-Xptxas -v
# reports registers, shared memory and spills per kernel).
BUILD_LOGS: Dict[str, str] = {}


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per name
    (0.0 for a library that was already built). Raises on any failure."""
    names = list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "repro_torch: nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin); the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; raises on a card that is not sm_90. The handle is cached for
    the life of the process."""
    lib = _LIBS.get(name)
    if lib is None:
        if compat.cuda_available() and not compat.is_sm90():
            raise RuntimeError(
                "repro_torch: the kernels are built for sm_90a (Hopper); "
                f"device 0 has compute capability {compat.device_capability()}"
            )
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
