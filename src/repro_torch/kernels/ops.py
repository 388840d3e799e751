"""Public kernel ops of the port, dispatched by the device of the tensors.

Counterpart of the JAX package's ``kernels/ops.py`` (``window_score``,
``segment_sum_sorted``, ``flash_attention``), without its tier ladder: a CPU tensor goes to the
plain torch version in ``kernels/ref.py``, a CUDA tensor to the hand-written
kernel — which launches or raises. Nothing falls back from one to the other,
and there is no autotune table in this slice. ``flash_attention`` on
``meta`` tensors (the dry run) returns its output's shape and credits the
kernel's work, computing nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_sum as _ss
from repro_torch.kernels import window_score as _ws

__all__ = [
    "window_score",
    "window_score_rows",
    "window_score_rows_batched",
    "segment_sum_sorted",
    "flash_attention",
    "launch_counts",
    "reset_launch_counts",
    "captured_counts",
    "credit_replays",
]

_KERNELS = {"window_score": _ws, "segment_sum": _ss, "flash_attention": _fa}


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"kernel op inputs must share one device, got {sorted(map(str, devs))}")
    return devs.pop()


def _scalar(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


def window_score(
    win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, bal, allowed, lam, max_deg,
    *, use_cs: bool = True,
) -> torch.Tensor:
    """(W, K) g = λ·B + R + CS, masked (see ``kernels/window_score.py``)."""
    dev = _device_of(win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, bal, allowed)
    lam = _scalar(lam, torch.float32, dev)
    max_deg = _scalar(max_deg, torch.int32, dev)
    if dev.type == "cpu":
        return _ref.window_score_ref(
            win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, bal, allowed, lam,
            max_deg, use_cs=use_cs,
        )
    return _ws.window_score(
        win_uv, win_valid, rep_u, rep_v, deg_u, deg_v, bal, allowed, lam,
        max_deg, use_cs=use_cs,
    )


def window_score_rows(
    win_uv, win_valid, replicas, deg, max_deg, rows, *, use_cs: bool = True,
) -> torch.Tensor:
    """(R, K) R + CS of window slots ``rows`` — the ADWISE step's rescoring,
    read from the (V+1, K) replica and (V+1,) degree tables at the window's
    vertex ids; ``rows`` is int32 or int64."""
    dev = _device_of(win_uv, win_valid, replicas, deg, rows)
    max_deg = _scalar(max_deg, torch.int32, dev)
    if dev.type == "cpu":
        return _ref.window_score_rows_ref(
            win_uv, win_valid, replicas, deg, max_deg, rows, use_cs=use_cs,
        )
    return _ws.window_score_rows(
        win_uv, win_valid, replicas, deg, max_deg, rows, use_cs=use_cs,
    )


def window_score_rows_batched(
    win_uv, win_valid, replicas, deg, max_deg, rows, *, use_cs: bool = True,
) -> torch.Tensor:
    """(z, R, K) R + CS of each of z instances' window slots ``rows`` (z, R)
    — the batched ADWISE step's rescoring, read from the (z, V+1, K) replica
    and (z, V+1) degree tables; one kernel launch for all instances."""
    dev = _device_of(win_uv, win_valid, replicas, deg, max_deg, rows)
    if dev.type == "cpu":
        return _ref.window_score_rows_batched_ref(
            win_uv, win_valid, replicas, deg, max_deg, rows, use_cs=use_cs,
        )
    return _ws.window_score_rows_batched(
        win_uv, win_valid, replicas, deg, max_deg, rows, use_cs=use_cs,
    )


def segment_sum_sorted(
    data: torch.Tensor,  # (E, D) — messages sorted by segment id
    layout: _ss.SegmentLayout,
) -> torch.Tensor:
    """(S, D) fp32 segment sum over a layout that is static per graph.

    Callers build ``layout`` once with
    :func:`~repro_torch.kernels.segment_sum.segment_layout` (the engine does
    so per graph); it carries the sorted segment ids, which the plain
    version reads, and the tile plan the kernel reads. The layout is also
    the kernel's scratch (slots and counters): calls on one layout must not
    run on two streams or threads at once.
    """
    if data.shape[0] != layout.seg_ids.shape[0]:
        raise ValueError(
            f"segment_sum_sorted: data has {data.shape[0]} rows, the layout "
            f"{layout.seg_ids.shape[0]}"
        )
    if data.device.type == "cpu":
        return _ref.segment_sum_ref(data, layout.seg_ids, layout.num_segments)
    return _ss.segment_sum(data.contiguous(), layout)


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Tq, Dh)
    k: torch.Tensor,  # (B, Hkv, Tk, Dh)
    v: torch.Tensor,  # (B, Hkv, Tk, Dh)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, Hq, Tq, Dh) GQA attention in ``q.dtype`` (see
    ``kernels/flash_attention.py``); ``scale`` defaults to Dh**-0.5.
    Differentiable on both devices, through
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`.

    On ``meta`` tensors (the dry run, ``launch.dryrun``) it is shape
    arithmetic: an output of the kernel's shape and layout, the kernel's
    work over the tiles it runs credited to ``flash_attention.META_FLOPS``
    (:func:`~repro_torch.kernels.flash_attention.flash_attention_meta`);
    no launch, no fallback. Its backward is the plain one, as on the card.

    Raises on shapes outside the op's contract
    (:func:`~repro_torch.kernels.flash_attention.check_shapes`) on every
    device.
    """
    if _device_of(q, k, v).type in ("cpu", "meta"):
        _fa.check_shapes(q, k, v, causal)
    return _fa.FlashAttentionFn.apply(q, k, v, causal, scale)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.LAUNCHES for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.LAUNCHES = 0
    _fa.LAUNCHES_BY_BODY.update(dict.fromkeys(_fa.BODIES, 0))
    _fa.BACKWARD_CALLS = 0


def captured_counts() -> dict[str, int]:
    """Launches recorded into CUDA graphs so far, per kernel. The driver
    reads it before and after capturing a graph to learn what one replay
    launches."""
    return {name: mod.CAPTURED for name, mod in _KERNELS.items()}


def credit_replays(per_replay: dict[str, int], replays: int) -> None:
    """Count the launches of ``replays`` replays of a captured CUDA graph
    that holds ``per_replay[name]`` launches of each kernel."""
    for name, n in per_replay.items():
        _KERNELS[name].LAUNCHES += n * replays
