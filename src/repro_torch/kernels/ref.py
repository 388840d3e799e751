"""Plain torch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the path ``kernels.ops`` takes for a tensor that lies on the
CPU. Port of the JAX package's ``kernels/ref.py``: the same operation order,
so on the CPU the results are bit-equal to the JAX oracles where the
arithmetic allows it (``window_score``) and equal up to fp32 summation
order elsewhere (``segment_sum``, ``flash_attention``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

__all__ = [
    "window_score_ref", "window_score_rows_ref", "window_score_rows_batched_ref",
    "segment_sum_ref",
    "flash_attention_ref",
]


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
    replicas: torch.Tensor,  # (V+1, K) bool — the step's replica table
    deg: torch.Tensor,  # (V+1,) int32 — the step's degree table
    max_deg: torch.Tensor,  # () int32
    rows: torch.Tensor,  # (R,) int32 / int64 — window slots to score, in [0, W)
    *,
    use_cs: bool = True,
) -> torch.Tensor:
    """R + CS (no λ·B, no mask) for the selected window slots: (R, K).

    This is what the ADWISE step computes for its lazily rescored rows
    (the JAX package inlines it in ``core/adwise.py``). It gathers the
    window's replica rows and degrees from the tables at the window's
    vertex ids, as the JAX step does; row r then equals row ``rows[r]`` of
    :func:`window_score_ref` on ``replicas[u]``, ``replicas[v]``,
    ``deg[u]``, ``deg[v]`` before its λ·B add and mask.
    """
    u, v = win_uv[:, 0], win_uv[:, 1]
    rep_u, rep_v = replicas[u], replicas[v]
    rows = rows.long()
    g = _replication(rep_u, rep_v, deg[u], deg[v], max_deg)[rows]
    if use_cs:
        g = g + _clustering(u[rows], v[rows], rows, u, v, win_valid, rep_u, rep_v)
    return g


def window_score_rows_batched_ref(
    win_uv: torch.Tensor,  # (z, W, 2) int32
    win_valid: torch.Tensor,  # (z, W) bool
    replicas: torch.Tensor,  # (z, V+1, K) bool — each instance's replica table
    deg: torch.Tensor,  # (z, V+1) int32 — each instance's degree table
    max_deg: torch.Tensor,  # (z,) int32
    rows: torch.Tensor,  # (z, R) int32 / int64 — window slots to score, in [0, W)
    *,
    use_cs: bool = True,
) -> torch.Tensor:
    """:func:`window_score_rows_ref` for each of z independent instances:
    (z, R, K), instance i's rows equal to the z = 1 call on instance i's
    inputs, bit for bit (the elementwise terms are the same operations per
    element, and the clustering numerators and denominators are sums of 0/1
    terms, exact in any order)."""
    z, w = win_uv.shape[:2]
    u, v = win_uv[..., 0].long(), win_uv[..., 1].long()  # (z, W)
    inst = torch.arange(z, device=u.device)[:, None]
    rep_u, rep_v = replicas[inst, u], replicas[inst, v]  # (z, W, K)
    denom = (2.0 * max_deg.clamp_min(1).float())[:, None]
    psi_u = deg.gather(1, u).float() / denom
    psi_v = deg.gather(1, v).float() / denom
    r = rep_u.float() * (2.0 - psi_u)[..., None] + rep_v.float() * (2.0 - psi_v)[..., None]
    rows = rows.long()
    g = r.gather(1, rows[..., None].expand(-1, -1, r.shape[2]))
    if use_cs:
        u_i, v_i = u.gather(1, rows)[..., None], v.gather(1, rows)[..., None]
        slots = torch.arange(w, device=u.device)
        keep = win_valid[:, None, :] & (rows[..., None] != slots)  # (z, R, W)
        a = ((u[:, None, :] == u_i) | (u[:, None, :] == v_i)) & keep
        b = ((v[:, None, :] == u_i) | (v[:, None, :] == v_i)) & keep
        af, bf = a.float(), b.float()
        num = af @ rep_v.float() + bf @ rep_u.float()
        den = af.sum(2) + bf.sum(2)
        g = g + num / den.clamp_min(1.0)[..., None]
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


def flash_attention_ref(
    q: torch.Tensor,  # (B, Hq, Tq, Dh)
    k: torch.Tensor,  # (B, Hkv, Tk, Dh)
    v: torch.Tensor,  # (B, Hkv, Tk, Dh)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """GQA softmax attention with fp32 accumulation, output in ``q.dtype``.

    Query head h reads KV head h // (Hq / Hkv). Causality is aligned to the
    *end* of KV: query row r sits at position Tk - Tq + r (so the same
    function serves prefill, Tq == Tk, and decode append, Tq < Tk); masked
    logits are NEG_INF, as in the JAX oracle.
    """
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (dh**0.5)
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(b, hkv, group, tq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf)
    if causal:
        qpos = torch.arange(tq, device=q.device) + (tk - tq)
        mask = qpos[:, None] >= torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    return out.reshape(b, hq, tq, dh).to(q.dtype)
