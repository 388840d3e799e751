"""Pure-Python sequential oracle of ADWISE Algorithm 1.

This is the *exact* semantics of the paper (window as a set, argmax over
W × P, candidate/secondary lazy traversal, adaptive window, adaptive λ,
set-semantics clustering score). It is deliberately unoptimized: it exists to
(a) pin the semantics the vectorized JAX implementation must match and
(b) serve as the correctness oracle in tests. Copied from the JAX package
(numpy only) so the port's ``oracle=True`` path needs no JAX.

Use `repro_torch.core.adwise.partition_stream` for anything larger than ~100k edges.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.types import AdwiseConfig, PartitionResult

__all__ = ["ref_adwise_partition"]


class _State:
    def __init__(self, num_vertices: int, k: int, cfg: AdwiseConfig, m: int):
        self.replicas: List[Set[int]] = [set() for _ in range(num_vertices)]
        self.rep_version = np.zeros(num_vertices, dtype=np.int64)
        self.deg = np.zeros(num_vertices, dtype=np.int64)
        self.max_deg = 1
        self.sizes = np.zeros(k, dtype=np.int64)
        self.lam = cfg.lam_init
        self.assigned = 0
        self.m = m
        self.score_count = 0

    def balance(self, p: int, eps: float) -> float:
        mx, mn = self.sizes.max(), self.sizes.min()
        return float((mx - self.sizes[p]) / (mx - mn + eps))

    def imbalance(self) -> float:
        mx = self.sizes.max()
        return float((mx - self.sizes.min()) / mx) if mx > 0 else 0.0


def _replication_score(st: _State, u: int, v: int, p: int) -> float:
    """Eq. 5: R((u,v),p) = 1{p∈R_u}(2-Ψ_u) + 1{p∈R_v}(2-Ψ_v), Ψ_x=deg(x)/2maxDeg."""
    psi_u = st.deg[u] / (2.0 * st.max_deg)
    psi_v = st.deg[v] / (2.0 * st.max_deg)
    r = 0.0
    if p in st.replicas[u]:
        r += 2.0 - psi_u
    if p in st.replicas[v]:
        r += 2.0 - psi_v
    return r


def _clustering_score(
    st: _State, window: List[Tuple[int, int, int]], i: int, p: int
) -> float:
    """Eq. 6 with exact set semantics; N(·) computed window-locally."""
    u, v = window[i][0], window[i][1]
    neigh: Set[int] = set()
    for j, (a, b, _) in enumerate(window):
        if j == i:
            continue
        if a == u or a == v:
            neigh.add(b)
        if b == u or b == v:
            neigh.add(a)
    neigh.discard(u)
    neigh.discard(v)
    if not neigh:
        return 0.0
    hits = sum(1 for x in neigh if p in st.replicas[x])
    return hits / len(neigh)


def _score(
    st: _State, window: List[Tuple[int, int, int]], i: int, p: int, cfg: AdwiseConfig
) -> float:
    """g(e,p) = λ(ι,α)·B(p) + R(e,p) + CS(e,p)  (Eq. 7)."""
    u, v = window[i][0], window[i][1]
    st.score_count += 1
    g = st.lam * st.balance(p, cfg.eps) + _replication_score(st, u, v, p)
    if cfg.use_clustering:
        g += _clustering_score(st, window, i, p)
    return g


def ref_adwise_partition(
    edges: np.ndarray,
    num_vertices: int,
    cfg: AdwiseConfig,
    cost_per_score: Optional[float] = None,
) -> PartitionResult:
    """Sequential Algorithm 1 with lazy traversal and the adaptive window.

    Args:
      edges: (m, 2) int32 stream.
      num_vertices: |V|.
      cfg: AdwiseConfig (assign_batch must be 1 — the oracle is sequential).
      cost_per_score: if given, (C2) uses ``score_count_delta * cost_per_score``
        as the modeled per-edge latency instead of wall-clock — this makes the
        oracle deterministic and lets tests compare against the JAX scan which
        uses the same model.
    """
    assert cfg.assign_batch == 1, "oracle implements the paper's sequential loop"
    m = len(edges)
    k = cfg.k
    st = _State(num_vertices, k, cfg, m)
    assign = np.full(m, -1, dtype=np.int32)
    cap = int(cfg.cap_slack * m / k) + 1 if cfg.cap_slack else None

    # Window entries: (u, v, stream_index).
    window: List[Tuple[int, int, int]] = []
    cursor = 0
    w = cfg.window_init
    c = 0
    sum_g, period_n = 0.0, 0
    avg_g_prev = -np.inf
    last_grew = True  # treat the initial window as "just grown" so C1 is evaluable
    w_trace: List[int] = []
    lam_trace: List[float] = []
    budget = cfg.latency_budget
    t_start = time.perf_counter()
    score_count_last = 0

    # Lazy traversal caches: per window slot, max-over-p score + best p,
    # validity stamped with endpoint replica versions.
    cache: Dict[int, Tuple[float, int, int, int]] = {}  # stream_idx -> (g, p, ver_u, ver_v)

    def load_edge() -> None:
        nonlocal cursor
        u, v = int(edges[cursor, 0]), int(edges[cursor, 1])
        window.append((u, v, cursor))
        # Streamed partial degrees are updated on observation (DESIGN.md §3).
        st.deg[u] += 1
        st.deg[v] += 1
        st.max_deg = max(st.max_deg, int(st.deg[u]), int(st.deg[v]))
        cursor += 1

    def best_for_edge(i: int) -> Tuple[float, int]:
        best_g, best_p = -np.inf, 0
        for p in range(k):
            if cap is not None and st.sizes[p] >= cap:
                continue
            g = _score(st, window, i, p, cfg)
            if g > best_g:
                best_g, best_p = g, p
        return best_g, best_p

    while cursor < m or window:
        # Alg. 1 line 5: top the window up by one edge.
        while len(window) < w and cursor < m:
            load_edge()

        # --- GETBESTASSIGNMENT with lazy traversal (§III-B) ---
        best = (-np.inf, 0, 0)  # (g, slot, p)
        for i, (u, v, sidx) in enumerate(window):
            entry = cache.get(sidx)
            fresh = (
                entry is not None
                and cfg.lazy
                and entry[2] == st.rep_version[u]
                and entry[3] == st.rep_version[v]
            )
            if fresh:
                g, p = entry[0], entry[1]
            else:
                g, p = best_for_edge(i)
                cache[sidx] = (g, p, int(st.rep_version[u]), int(st.rep_version[v]))
            if g > best[0]:
                best = (g, i, p)
        g_hat, i_hat, p_hat = best
        u, v, sidx = window.pop(i_hat)
        cache.pop(sidx, None)

        # Assign ê to p̂.
        assign[sidx] = p_hat
        st.sizes[p_hat] += 1
        for x in (u, v):
            if p_hat not in st.replicas[x]:
                st.replicas[x].add(p_hat)
                st.rep_version[x] += 1
        st.assigned += 1
        sum_g += g_hat
        period_n += 1
        c += 1

        # Adaptive λ (Eq. 4).
        alpha = st.assigned / m
        tol = max(0.0, 1.0 - alpha)
        st.lam = float(np.clip(st.lam + (st.imbalance() - tol), cfg.lam_lo, cfg.lam_hi))
        lam_trace.append(st.lam)

        # Adaptive window (§III-A), every w assignments.
        if cfg.adapt and c % max(w, 1) == 0:
            avg_g = sum_g / max(period_n, 1)
            edges_left = m - st.assigned
            if budget is not None:
                if cost_per_score is not None:
                    elapsed = st.score_count * cost_per_score
                else:
                    elapsed = time.perf_counter() - t_start
                budget_left = budget - elapsed
                per_edge = (
                    (st.score_count - score_count_last) * (cost_per_score or 0.0) / max(period_n, 1)
                    if cost_per_score is not None
                    else elapsed / max(st.assigned, 1)
                )
                c2 = edges_left == 0 or per_edge < budget_left / max(edges_left, 1)
            else:
                c2 = True
            c1 = (not last_grew) or (avg_g >= avg_g_prev)
            if c1 and c2 and w < cfg.window_max:
                w = min(2 * w, cfg.window_max)
                last_grew = True
                while len(window) < w and cursor < m:
                    load_edge()
            elif not c2:
                w = max(1, -(-w // 2))
                last_grew = False
            else:
                last_grew = False
            avg_g_prev = avg_g
            sum_g, period_n = 0.0, 0
            score_count_last = st.score_count
            c = 0
        w_trace.append(w)

    wall = time.perf_counter() - t_start
    return PartitionResult(
        assign=assign,
        stats=dict(
            k=k,
            score_count=int(st.score_count),
            wall_time_s=wall,
            w_trace=np.array(w_trace, dtype=np.int32),
            lam_trace=np.array(lam_trace, dtype=np.float32),
            final_w=w,
        ),
    )
