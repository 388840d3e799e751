"""ADWISE scoring (Eq. 3-7) on torch tensors.

Port of the JAX package's ``core/scoring.py``. Every function keeps the
reference's operation order — a multiply, then a separate add; never a fused
multiply-add — so on the same inputs the results are bit-equal to the JAX
functions (held by ``tests/test_torch_scoring.py``). Shapes:

  W = window capacity, K = number of partitions.
"""
from __future__ import annotations

import torch

__all__ = [
    "balance_score",
    "replication_score",
    "clustering_terms",
    "window_scores",
    "lambda_update",
    "NEG_INF",
]

NEG_INF = -1e30
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def balance_score(sizes: torch.Tensor, allowed: torch.Tensor, eps: float) -> torch.Tensor:
    """Eq. 3: B(p) = (maxsize - |p|) / (maxsize - minsize + eps), masked to allowed."""
    mx = torch.where(allowed, sizes, _I32_MIN).max()
    mn = torch.where(allowed, sizes, _I32_MAX).min()
    return (mx - sizes).float() / ((mx - mn).float() + eps)


def replication_score(
    rep_u: torch.Tensor,  # (W, K) bool — replicas of u_i
    rep_v: torch.Tensor,  # (W, K) bool
    deg_u: torch.Tensor,  # (W,) int32 partial degrees
    deg_v: torch.Tensor,  # (W,)
    max_deg: torch.Tensor,  # () int32
) -> torch.Tensor:
    """Eq. 5 with the absolute degree normalisation Ψ_x = deg(x)/(2·maxDeg)."""
    denom = 2.0 * max_deg.clamp_min(1).float()
    psi_u = deg_u.float() / denom
    psi_v = deg_v.float() / denom
    return rep_u * (2.0 - psi_u)[:, None] + rep_v * (2.0 - psi_v)[:, None]


def clustering_terms(
    win_uv: torch.Tensor,  # (W, 2) int32
    win_valid: torch.Tensor,  # (W,) bool
    rep_u: torch.Tensor,  # (W, K) bool/f32 — replica rows of u_j
    rep_v: torch.Tensor,  # (W, K)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Window-local clustering score CS (Eq. 6), multiset semantics.

    Edge j contributes its endpoint v_j to N(u_i) ∪ N(v_i) iff u_j ∈ {u_i,
    v_i} (and symmetrically u_j if v_j matches). Returns (numerator (W, K),
    denominator (W,)). The operands are 0/1, so the products are exact
    integer counts in any summation order.
    """
    u, v = win_uv[:, 0], win_uv[:, 1]
    vj = win_valid[None, :]
    noti = ~torch.eye(u.shape[0], dtype=torch.bool, device=u.device)
    a = (u[None, :] == u[:, None]) | (u[None, :] == v[:, None])
    b = (v[None, :] == u[:, None]) | (v[None, :] == v[:, None])
    a = (a & vj & noti).float()
    b = (b & vj & noti).float()
    num = a @ rep_v.float() + b @ rep_u.float()
    den = a.sum(1) + b.sum(1)
    return num, den


def window_scores(
    win_uv: torch.Tensor,
    win_valid: torch.Tensor,
    rep_u: torch.Tensor,
    rep_v: torch.Tensor,
    deg_u: torch.Tensor,
    deg_v: torch.Tensor,
    max_deg: torch.Tensor,
    sizes: torch.Tensor,
    allowed: torch.Tensor,
    lam: torch.Tensor,
    *,
    use_cs: bool = True,
    eps: float = 0.01,
) -> torch.Tensor:
    """Full g(e,p) = λ·B(p) + R(e,p) + CS(e,p) (Eq. 7), (W, K), masked."""
    bal = balance_score(sizes, allowed, eps)
    g = lam * bal[None, :] + replication_score(rep_u, rep_v, deg_u, deg_v, max_deg)
    if use_cs:
        num, den = clustering_terms(win_uv, win_valid, rep_u, rep_v)
        g = g + num / den.clamp_min(1.0)[:, None]
    g = torch.where(win_valid[:, None], g, NEG_INF)
    return torch.where(allowed[None, :], g, NEG_INF)


def lambda_update(
    lam: torch.Tensor,
    sizes: torch.Tensor,
    allowed: torch.Tensor,
    assigned: torch.Tensor,
    m_total: torch.Tensor,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """Adaptive balance weight (Eq. 4): λ += (ι − tolerance(α)), clipped.

    ι = (maxsize − minsize)/maxsize over allowed partitions,
    tolerance(α) = max(0, 1 − α), α = assigned/m.
    """
    mx = torch.where(allowed, sizes, 0).max().float()
    mn = torch.where(allowed, sizes, _I32_MAX).min().float()
    iota = torch.where(mx > 0, (mx - mn) / mx.clamp_min(1.0), 0.0)
    alpha = assigned.float() / m_total.float().clamp_min(1.0)
    tol = (1.0 - alpha).clamp_min(0.0)
    return (lam + (iota - tol)).clamp(lo, hi)
