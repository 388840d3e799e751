"""Plain torch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the path ``kernels.ops`` takes for a tensor that lies on the
CPU. Port of the JAX package's ``kernels/ref.py``: the same operation order,
so on the CPU the results are bit-equal to the JAX oracles where the
arithmetic allows it (``window_score``) and equal to fp32 summation order
elsewhere (``segment_sum``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

__all__ = ["window_score_ref", "window_score_rows_ref", "segment_sum_ref"]


def _replication(rep_u, rep_v, deg_u, deg_v, max_deg) -> torch.Tensor:
    denom = 2.0 * max_deg.clamp_min(1).float()
    psi_u = deg_u.float() / denom
    psi_v = deg_v.float() / denom
    return rep_u.float() * (2.0 - psi_u)[:, None] + rep_v.float() * (2.0 - psi_v)[:, None]


def _clustering(u_i, v_i, rows, u, v, win_valid, rep_u, rep_v) -> torch.Tensor:
    """CS for the rows whose endpoints are (u_i, v_i) and whose own window
    slot is ``rows``: (A @ rep_v + B @ rep_u) / max(|A| + |B|, 1)."""
    w = u.shape[0]
    slots = torch.arange(w, device=u.device)
    keep = win_valid[None, :] & (rows[:, None] != slots[None, :])
    a = ((u[None, :] == u_i[:, None]) | (u[None, :] == v_i[:, None])) & keep
    b = ((v[None, :] == u_i[:, None]) | (v[None, :] == v_i[:, None])) & keep
    af, bf = a.float(), b.float()
    num = af @ rep_v.float() + bf @ rep_u.float()
    den = af.sum(1) + bf.sum(1)
    return num / den.clamp_min(1.0)[:, None]


def window_score_ref(
    win_uv: torch.Tensor,  # (W, 2) int32
    win_valid: torch.Tensor,  # (W,) bool
    rep_u: torch.Tensor,  # (W, K) bool — replica rows of u_i
    rep_v: torch.Tensor,  # (W, K) bool
    deg_u: torch.Tensor,  # (W,) int32
    deg_v: torch.Tensor,  # (W,) int32
    bal: torch.Tensor,  # (K,) f32 — precomputed B(p)
    allowed: torch.Tensor,  # (K,) bool
    lam: torch.Tensor,  # () f32
    max_deg: torch.Tensor,  # () int32
    *,
    use_cs: bool = True,
) -> torch.Tensor:
    """g(e,p) = λ·B(p) + R(e,p) + CS(e,p) over the full (W, K) grid.

    Invalid rows and disallowed partitions are NEG_INF. Order of the adds:
    R, then + CS, then + λ·B — the JAX oracle's order.
    """
    w = win_uv.shape[0]
    u, v = win_uv[:, 0], win_uv[:, 1]
    g = _replication(rep_u, rep_v, deg_u, deg_v, max_deg)
    if use_cs:
        rows = torch.arange(w, device=u.device)
        g = g + _clustering(u, v, rows, u, v, win_valid, rep_u, rep_v)
    g = g + lam * bal[None, :]
    return torch.where(win_valid[:, None] & allowed[None, :], g, NEG_INF)


def window_score_rows_ref(
    win_uv: torch.Tensor,  # (W, 2) int32
    win_valid: torch.Tensor,  # (W,) bool
    rep_u: torch.Tensor,  # (W, K) bool
    rep_v: torch.Tensor,  # (W, K) bool
    deg_u: torch.Tensor,  # (W,) int32
    deg_v: torch.Tensor,  # (W,) int32
    max_deg: torch.Tensor,  # () int32
    rows: torch.Tensor,  # (R,) int — window slots to score, in [0, W)
    *,
    use_cs: bool = True,
) -> torch.Tensor:
    """R + CS (no λ·B, no mask) for the selected window slots: (R, K).

    This is what the ADWISE step computes for its lazily rescored rows
    (the JAX package inlines it in ``core/adwise.py``); row r equals row
    ``rows[r]`` of :func:`window_score_ref` before its λ·B add and mask.
    """
    u, v = win_uv[:, 0], win_uv[:, 1]
    rows = rows.long()
    g = _replication(rep_u, rep_v, deg_u, deg_v, max_deg)[rows]
    if use_cs:
        g = g + _clustering(u[rows], v[rows], rows, u, v, win_valid, rep_u, rep_v)
    return g


def segment_sum_ref(
    data: torch.Tensor,  # (E, D) — messages sorted by segment
    seg_ids: torch.Tensor,  # (E,) int — destination segment per row
    num_segments: int,
) -> torch.Tensor:
    """(S, D) fp32 segment sum — the engine's edge→vertex accumulation.

    Accumulates in fp32 whatever the input type, as the kernel does.
    """
    e, d = data.shape
    out = torch.zeros((num_segments, d), dtype=torch.float32, device=data.device)
    idx = seg_ids.long()[:, None].expand(e, d)
    return out.scatter_add_(0, idx, data.float())
