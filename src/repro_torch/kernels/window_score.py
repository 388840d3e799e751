"""``window_score``: the ADWISE window-scoring kernel on Hopper.

Replaces the TPU kernel ``window_score_pallas`` + ``_kernel`` of the JAX
package (``src/repro/kernels/window_score.py``). The CUDA source is
``csrc/window_score.cu``; its header states the bound (launch latency plus
one chain of dependent reads at the step's shapes: ~20 KB per call) and the
design (one block per scored row, one thread per window column, the
matched columns compacted with ``__ballot_sync`` and only their replica
rows read, int32 counts, an FMA-free fp32 epilogue in the JAX order, so the
kernel is bit-equal to the plain version).

Entry points into one kernel:

* :func:`window_score` — the full (W, K) op on the window's (W, K) replica
  rows, λ·B added and masked, matching
  :func:`~repro_torch.kernels.ref.window_score_ref`;
* :func:`window_score_rows_batched` — R + CS for R selected window slots of
  each of z instances, what the ADWISE step rescores, read straight from
  the step's (z, V+1, K) replica and (z, V+1) degree tables at each
  window's vertex ids, in one launch (grid rows × instances)
  (:func:`~repro_torch.kernels.ref.window_score_rows_batched_ref`);
* :func:`window_score_rows` — the same for one instance: the z = 1 launch
  of :func:`window_score_rows_batched` on views with a leading axis of 1.

All take CUDA tensors only; ``kernels.ops`` sends CPU tensors to the plain
versions, which live in ``kernels/ref.py`` and are bound here as
``window_score_plain`` / ``window_score_rows_plain`` /
``window_score_rows_batched_plain``.

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
from repro_torch.kernels.ref import window_score_rows_batched_ref as window_score_rows_batched_plain
from repro_torch.kernels.ref import window_score_rows_ref as window_score_rows_plain

__all__ = [
    "window_score",
    "window_score_rows",
    "window_score_rows_batched",
    "window_score_plain",
    "window_score_rows_plain",
    "window_score_rows_batched_plain",
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
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_floor(n_blocks: int) -> None:
    """Launch an empty kernel on ``n_blocks`` blocks of 32 threads on the
    current stream — the launch floor a timing of the row op is read
    against. Not counted in ``LAUNCHES``."""
    lib = _build.load("window_score")
    fn = lib.window_score_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int(n_blocks), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_score: empty kernel launch failed (cudaError {err})")


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
    """Full op when ``rows`` is None (one instance: rep_*/deg_* are the
    window's rows), batched row op otherwise (z instances: rep_u is rep_v,
    the (z, V+1, K) table; deg_u is deg_v, (z, V+1))."""
    dev = win_uv.device
    if dev.type != "cuda":
        raise ValueError(f"window_score: the kernel takes CUDA tensors, got {dev}")
    if rows is None:
        z = 1
        w = win_uv.shape[0] if win_uv.dim() == 2 else -1
        k = rep_u.shape[1] if rep_u.dim() == 2 else -1
        n_tab = w
        _check("rep_u", rep_u, torch.bool, (w, k), dev)
        _check("rep_v", rep_v, torch.bool, (w, k), dev)
        _check("deg_u", deg_u, torch.int32, (w,), dev)
        _check("deg_v", deg_v, torch.int32, (w,), dev)
        _check("win_uv", win_uv, torch.int32, (w, 2), dev)
        _check("win_valid", win_valid, torch.bool, (w,), dev)
        _check("max_deg", max_deg, torch.int32, (), dev)
        _check("bal", bal, torch.float32, (k,), dev)
        _check("allowed", allowed, torch.bool, (k,), dev)
        _check("lam", lam, torch.float32, (), dev)
        n_rows = w
        out_shape = (n_rows, k)
    else:
        z, w = win_uv.shape[:2] if win_uv.dim() == 3 else (-1, -1)
        n_tab, k = rep_u.shape[1:] if rep_u.dim() == 3 else (-1, -1)
        _check("win_uv", win_uv, torch.int32, (z, w, 2), dev)
        _check("win_valid", win_valid, torch.bool, (z, w), dev)
        _check("replicas", rep_u, torch.bool, (z, n_tab, k), dev)
        _check("deg", deg_u, torch.int32, (z, n_tab), dev)
        _check("max_deg", max_deg, torch.int32, (z,), dev)
        if not isinstance(rows, torch.Tensor) or rows.dtype not in (torch.int32, torch.int64):
            raise TypeError("window_score: rows must be an int32 or int64 tensor")
        n_rows = rows.shape[1] if rows.dim() == 2 else -1
        _check("rows", rows, rows.dtype, (z, n_rows), dev)
        if z > 65535:
            raise ValueError(f"window_score: at most 65535 instances per launch, got {z}")
        out_shape = (z, n_rows, k)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    if z == 0 or n_rows == 0 or w == 0 or k == 0:
        return out
    if n_tab == 0:
        raise ValueError("window_score: the replica table has no rows")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rows_64 = int(rows is not None and rows.dtype == torch.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            ptr(win_uv), ptr(win_valid), ptr(rep_u), ptr(rep_v), ptr(deg_u),
            ptr(deg_v), ptr(max_deg), ptr(bal), ptr(allowed), ptr(lam),
            ptr(rows), rows_64, z, n_tab, n_rows, w, k,
            int(bool(use_cs)), ptr(out), stream,
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


def window_score_rows_batched(win_uv, win_valid, replicas, deg, max_deg, rows, *,
                              use_cs: bool = True) -> torch.Tensor:
    """(z, R, K) R + CS for each instance's window slots ``rows`` ((z, R),
    int32 or int64, each in [0, W)), from the (z, V+1, K) bool replica
    tables and the (z, V+1) int32 degree tables at each window's vertex ids;
    ``win_uv`` is (z, W, 2), ``win_valid`` (z, W), ``max_deg`` (z,). One
    launch for all z instances."""
    return _launch(win_uv, win_valid, replicas, replicas, deg, deg, max_deg,
                   None, None, None, rows, use_cs)


def window_score_rows(win_uv, win_valid, replicas, deg, max_deg, rows, *,
                      use_cs: bool = True) -> torch.Tensor:
    """(R, K) R + CS for window slots ``rows`` (int32 or int64, each in
    [0, W)), from the (V+1, K) bool replica table and the (V+1,) int32
    degree table at the window's vertex ids: the z = 1 launch of
    :func:`window_score_rows_batched`."""
    return window_score_rows_batched(
        win_uv[None], win_valid[None], replicas[None], deg[None],
        max_deg.reshape(1), rows[None], use_cs=use_cs,
    )[0]
