"""``window_score``: the ADWISE window-scoring kernel on Hopper.

Replaces the TPU kernel ``window_score_pallas`` + ``_kernel`` of the JAX
package (``src/repro/kernels/window_score.py``). The CUDA source is
``csrc/window_score.cu``; its header states the bound (launch latency at the
step's shapes: ~20 KB of replica rows per call) and the design (one block per
scored row, int32 match counts, an FMA-free fp32 epilogue in the JAX order,
so the kernel is bit-equal to the plain version).

Two entry points into one kernel:

* :func:`window_score` — the full (W, K) op, λ·B added and masked, matching
  :func:`~repro_torch.kernels.ref.window_score_ref`;
* :func:`window_score_rows` — R + CS for R selected window slots, what the
  ADWISE step rescores (:func:`~repro_torch.kernels.ref.window_score_rows_ref`).

Both take CUDA tensors only; ``kernels.ops`` sends CPU tensors to the plain
versions, which live in ``kernels/ref.py`` and are bound here as
``window_score_plain`` / ``window_score_rows_plain``.

``LAUNCHES`` counts kernel launches: one per eager call, and — when a call
is captured into a CUDA graph — one per replay of that graph (the capture
records the launch; :func:`repro_torch.kernels.ops.credit_replays` adds the
recorded launches once per replay).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import window_score_ref as window_score_plain
from repro_torch.kernels.ref import window_score_rows_ref as window_score_rows_plain

__all__ = [
    "window_score",
    "window_score_rows",
    "window_score_plain",
    "window_score_rows_plain",
    "LAUNCHES",
    "REPLACES",
]

REPLACES = "src/repro/kernels/window_score.py:94"  # window_score_pallas
LAUNCHES = 0
CAPTURED = 0  # launches recorded into CUDA graphs (replayed, not run, at capture)

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("window_score")
        fn = lib.window_score_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"window_score: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"window_score: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"window_score: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"window_score: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"window_score: {name} must be contiguous")


def _count() -> None:
    global LAUNCHES, CAPTURED
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1


def _launch(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, max_deg,
            bal, allowed, lam, rows, use_cs):
    dev = win_uv.device
    if dev.type != "cuda":
        raise ValueError(f"window_score: the kernel takes CUDA tensors, got {dev}")
    w, k = rep_u.shape
    _check("win_uv", win_uv, torch.int32, (w, 2), dev)
    _check("win_valid", win_valid, torch.bool, (w,), dev)
    _check("rep_u", rep_u, torch.bool, (w, k), dev)
    _check("rep_v", rep_v, torch.bool, (w, k), dev)
    _check("deg_u", deg_u, torch.int32, (w,), dev)
    _check("deg_v", deg_v, torch.int32, (w,), dev)
    _check("max_deg", max_deg, torch.int32, (), dev)
    if rows is None:
        _check("bal", bal, torch.float32, (k,), dev)
        _check("allowed", allowed, torch.bool, (k,), dev)
        _check("lam", lam, torch.float32, (), dev)
        n_rows = w
    else:
        n_rows = rows.shape[0] if rows.dim() == 1 else -1
        _check("rows", rows, torch.int32, (n_rows,), dev)
    out = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    if n_rows == 0 or w == 0 or k == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            ptr(win_uv), ptr(win_valid), ptr(rep_u), ptr(rep_v), ptr(deg_u),
            ptr(deg_v), ptr(max_deg), ptr(bal), ptr(allowed), ptr(lam),
            ptr(rows), n_rows, w, k, int(bool(use_cs)), ptr(out), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_score: kernel launch failed (cudaError {err})")
    _count()
    return out


def window_score(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, bal, allowed,
                 lam, max_deg, *, use_cs: bool = True) -> torch.Tensor:
    """Full (W, K) score matrix g = R + CS + λ·B, masked with -1e30."""
    return _launch(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, max_deg,
                   bal, allowed, lam, None, use_cs)


def window_score_rows(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, max_deg,
                      rows, *, use_cs: bool = True) -> torch.Tensor:
    """(R, K) R + CS for window slots ``rows`` (int32, each in [0, W))."""
    return _launch(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, max_deg,
                   None, None, None, rows, use_cs)
