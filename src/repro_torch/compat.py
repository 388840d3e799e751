"""Capability probes and device resolution for the port.

The counterpart of the JAX package's ``compat`` probes: instead of asking
whether Pallas lowers, the port asks whether there is a CUDA device, whether
it is Hopper (sm_90), and whether ``nvcc`` is present to build the kernels in
``csrc/``. Nothing here runs at import time beyond reading ``torch``'s own
state.

:func:`resolve_device` is the single place an entry point turns its
``device=`` argument into a ``torch.device``: ``None`` means ``cuda``, and
asking for ``cuda`` where there is none raises — an entry point never carries
on quietly on the CPU.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Union

import torch

__all__ = [
    "cuda_available",
    "device_capability",
    "is_sm90",
    "nvcc_path",
    "resolve_device",
]

_CUDA_HOME_NVCC = "/usr/local/cuda/bin/nvcc"


def cuda_available() -> bool:
    return torch.cuda.is_available()


def device_capability() -> Optional[tuple[int, int]]:
    """(major, minor) of CUDA device 0, or None without a device."""
    if not cuda_available():
        return None
    return torch.cuda.get_device_capability(0)


def is_sm90() -> bool:
    """True when device 0 is a Hopper card (compute capability 9.0), the
    only target the kernels are built for (``sm_90a``)."""
    return device_capability() == (9, 0)


def nvcc_path() -> Optional[str]:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH,
    or the toolkit's default location; None when absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return _CUDA_HOME_NVCC if os.path.isfile(_CUDA_HOME_NVCC) else None


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain torch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
