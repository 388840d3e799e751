"""Single-edge streaming baselines the paper compares ADWISE against.

Port of the JAX package's ``core/baselines.py``:

* Hashing — edge hash (PowerGraph/GraphX default);
* Grid    — 2D grid-constrained hashing (GraphBuilder);
* DBH     — Degree-Based Hashing (Xie et al., NIPS'14);
* HDRF    — High-Degree Replicated First (Petroni et al., CIKM'15);
* Greedy  — PowerGraph's replica-intersection heuristic (OSDI'12).

Hash, grid and DBH are stateless hashes over the whole stream, computed on
the host. HDRF and Greedy keep a vertex cache; their per-edge numpy loops
(:class:`HdrfState`, :class:`GreedyState`) are copied as the parity oracles,
and :class:`HdrfCore` / :class:`GreedyCore` run the same integer-quantized
math as in-place step-cores on :class:`repro_torch.core.driver.ScanDriver`
(32 steps per CUDA graph on the card, a plain loop on the CPU), one edge
per instance per step for z spotlight instances at once. The same edges and
seed give bit-identical assignments in both packages.

HDRF's tie noise is the JAX package's counter-based uint32 hash of (stream
row, partition, seed). The step evaluates it in int64 with every product
kept below 2^63: the seed and partition terms are folded on the host with
Python ints into a (K,) table per instance (seed ``seed + i`` for instance
i), the multiply by 0x846CA68B (>= 2^31) is split into 16-bit halves, and
every stage is masked to 32 bits (:func:`tie_hash_torch`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.adwise import at_rows, instance_offsets
from repro_torch.core.driver import StepCore
from repro_torch.core.types import PartitionResult, WarmState

__all__ = [
    "hdrf_partition",
    "dbh_partition",
    "greedy_partition",
    "hash_partition",
    "grid_partition",
    "HdrfState",
    "GreedyState",
    "HdrfCore",
    "GreedyCore",
    "hdrf_partition_scan",
    "greedy_partition_scan",
    "hash_assign",
    "grid_assign",
    "dbh_assign",
    "tie_break_hash",
    "tie_hash_torch",
]

# Quantization of the HDRF scoring (shared by the numpy oracle and the
# step-core): θ and balance fractions in 1/64 steps, λ as round(λ·64).
QB = 64
TIE_BITS = 10  # tie-noise bits packed under the quantized score
_TIE_MASK = (1 << TIE_BITS) - 1
_DEG_CLAMP = 1 << 22  # keeps 64·C_rep_q·2^TIE_BITS + λ_q·bal_q·2^TIE_BITS < 2^31
_LAM_Q_MAX = 4096  # λ ≤ 64 — far above the useful HDRF range
_U32 = np.uint64(0xFFFFFFFF)
_M32 = 0xFFFFFFFF
_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


def _hash_vec(x: np.ndarray, k: int, salt: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic integer hash -> [0, k)."""
    h = (x.astype(np.uint64) + np.uint64(salt)) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC2B2AE3D27D4EB4F)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(k)).astype(np.int32)



def _lam_q(lam: float) -> int:
    return int(np.clip(round(float(lam) * QB), 0, _LAM_Q_MAX))


def _eps_q(eps: float) -> int:
    return max(int(round(float(eps))), 1)


def tie_break_hash(rows: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Counter-based HDRF tie noise: uint32 hash of (row, partition, seed).

    Stateless in the stream position, so every chunk geometry draws the
    same noise. Returns int64 (len(rows), k) in [0, 2^TIE_BITS).
    """
    r = (np.asarray(rows, np.uint64) & _U32)[:, None]
    p = np.arange(k, dtype=np.uint64)[None, :]
    s = np.uint64(int(seed) & 0xFFFFFFFF)
    h = (r * np.uint64(0x9E3779B9)) & _U32
    h = h ^ ((p * np.uint64(0x85EBCA6B)) & _U32)
    h = h ^ ((s * np.uint64(0xC2B2AE35)) & _U32)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x7FEB352D)) & _U32
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(0x846CA68B)) & _U32
    h ^= h >> np.uint64(16)
    return (h & np.uint64(_TIE_MASK)).astype(np.int64)


def _tie_terms(k: int, seed: int, device) -> torch.Tensor:
    """(k,) int64: the partition and seed terms of the tie hash, folded on
    the host with Python ints."""
    s_term = (int(seed) & _M32) * 0xC2B2AE35 & _M32
    return torch.tensor(
        [((p * 0x85EBCA6B) & _M32) ^ s_term for p in range(k)],
        dtype=torch.int64, device=device,
    )


def tie_hash_torch(rows: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`tie_break_hash`: (R, k) int64 tie noise for
    int ``rows`` in [0, 2^31) against ``terms = _tie_terms(k, seed)`` —
    (k,) for one seed, or (R, k), row r's terms for row r's seed (the
    batched step: one row and one seed per instance).

    uint32 arithmetic in int64: operands stay below 2^32 and every product
    below 2^63 (the multiply by 0x846CA68B is split into 16-bit halves)."""
    r = rows.to(torch.int64).view(-1, 1)
    h = ((r * 0x9E3779B9) & _M32) ^ terms
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0xA68B + (((h * 0x846C) & 0xFFFF) << 16)) & _M32
    h = h ^ (h >> 16)
    return h & _TIE_MASK


def _local_to_global(allowed: np.ndarray) -> np.ndarray:
    l2g = np.flatnonzero(np.asarray(allowed, bool)).astype(np.int32)
    assert len(l2g) > 0, "allowed mask selects no partition"
    return l2g



def hash_assign(edges: np.ndarray, num_vertices: int, k: int, seed: int = 0) -> np.ndarray:
    key = edges[:, 0].astype(np.uint64) * np.uint64(num_vertices) + edges[:, 1].astype(np.uint64)
    return _hash_vec(key, k, salt=seed + 1)


def grid_assign(edges: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    g = max(int(np.floor(np.sqrt(k))), 1)
    ru = _hash_vec(edges[:, 0].astype(np.uint64), g, salt=seed + 11)
    cv = _hash_vec(edges[:, 1].astype(np.uint64), g, salt=seed + 13)
    return (ru * g + cv).astype(np.int32) % k


def dbh_assign(edges: np.ndarray, degrees: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """DBH placement given the *full-stream* degree table."""
    u, v = edges[:, 0], edges[:, 1]
    pick_u = degrees[u] < degrees[v]
    # Tie: lower id (deterministic).
    tie = degrees[u] == degrees[v]
    pick_u = np.where(tie, u < v, pick_u)
    key = np.where(pick_u, u, v).astype(np.uint64)
    return _hash_vec(key, k, salt=seed + 29)


def hash_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """Random edge hashing (the PowerGraph default loader).

    ``allowed`` restricts placements to a partition subset by hashing into
    it by rank (spotlight masked form).
    """
    t0 = time.perf_counter()
    if allowed is None:
        assign = hash_assign(edges, num_vertices, k, seed=seed)
    else:
        l2g = _local_to_global(allowed)
        assign = l2g[hash_assign(edges, num_vertices, len(l2g), seed=seed)]
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="hash"))


def grid_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """GraphBuilder grid hashing: p drawn from intersection of row(u) and col(v).

    Constrains each vertex's replicas to a sqrt(k)-sized subset.
    """
    if allowed is not None:
        raise ValueError(
            "grid imposes its own replica constraint and cannot honour a "
            "spotlight spread mask"
        )
    t0 = time.perf_counter()
    assign = grid_assign(edges, k, seed=seed)
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="grid"))


def dbh_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    degrees: Optional[np.ndarray] = None,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """Degree-Based Hashing: hash the lower-degree endpoint of each edge."""
    t0 = time.perf_counter()
    if degrees is None:
        degrees = np.zeros(num_vertices, dtype=np.int64)
        np.add.at(degrees, edges[:, 0], 1)
        np.add.at(degrees, edges[:, 1], 1)
    if allowed is None:
        assign = dbh_assign(edges, degrees, k, seed=seed)
    else:
        l2g = _local_to_global(allowed)
        assign = l2g[dbh_assign(edges, degrees, len(l2g), seed=seed)]
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="dbh"))



# ----------------------------------------------------------------------------
# Sequential cores: numpy oracles (stateful; chunk-resumable)
# ----------------------------------------------------------------------------


class HdrfState:
    """HDRF vertex cache + loads, resumable across chunks (parity oracle).

    Integer-quantized scoring with counter-based tie noise keyed on the
    running ``edges_seen`` row id — the assignment stream is invariant to
    chunk geometry and bit-identical to the :class:`HdrfCore` scan.
    """

    def __init__(self, num_vertices: int, k: int, lam: float = 1.1,
                 eps: float = 1.0, seed: int = 0,
                 allowed: Optional[np.ndarray] = None):
        self.k = k
        self.lam_q = _lam_q(lam)
        self.eps_q = _eps_q(eps)
        self.seed = int(seed)
        self.deg = np.zeros(num_vertices, dtype=np.int64)
        self.replicas = np.zeros((num_vertices, k), dtype=bool)
        self.sizes = np.zeros(k, dtype=np.int64)
        self.allowed = (
            np.ones(k, bool) if allowed is None else np.asarray(allowed, bool)
        )
        assert self.allowed.shape == (k,) and self.allowed.any()
        self.edges_seen = 0

    def assign_chunk(self, edges: np.ndarray) -> np.ndarray:
        """Place a chunk of the stream; state advances in stream order."""
        k, lam_q, eps_q = self.k, self.lam_q, self.eps_q
        deg, replicas, sizes = self.deg, self.replicas, self.sizes
        allowed = self.allowed
        aidx = np.flatnonzero(allowed)
        c = len(edges)
        assign = np.empty(c, dtype=np.int32)
        ties = tie_break_hash(
            np.arange(self.edges_seen, self.edges_seen + c), k, self.seed
        )
        for i in range(c):
            u, v = int(edges[i, 0]), int(edges[i, 1])
            deg[u] += 1
            deg[v] += 1
            du = min(int(deg[u]), _DEG_CLAMP)
            dv = min(int(deg[v]), _DEG_CLAMP)
            a = du + dv
            tq_u = ((2 * a - du) * QB) // a
            tq_v = ((2 * a - dv) * QB) // a
            sal = sizes[aidx]
            mx, mn = int(sal.max()), int(sal.min())
            gap = np.clip(mx - sizes, 0, _DEG_CLAMP)
            bal_q = (gap * QB) // (eps_q + min(mx - mn, _DEG_CLAMP))
            rep_q = replicas[u] * tq_u + replicas[v] * tq_v
            score_q = QB * rep_q.astype(np.int64) + lam_q * bal_q
            combined = np.where(allowed, (score_q << TIE_BITS) + ties[i], -1)
            p = int(np.argmax(combined))
            assign[i] = p
            sizes[p] += 1
            replicas[u, p] = True
            replicas[v, p] = True
        self.edges_seen += c
        return assign


class GreedyState:
    """PowerGraph Greedy vertex cache + loads, resumable across chunks."""

    def __init__(self, num_vertices: int, k: int,
                 allowed: Optional[np.ndarray] = None):
        self.k = k
        self.replicas = np.zeros((num_vertices, k), dtype=bool)
        self.sizes = np.zeros(k, dtype=np.int64)
        self.allowed = (
            np.ones(k, bool) if allowed is None else np.asarray(allowed, bool)
        )
        assert self.allowed.shape == (k,) and self.allowed.any()
        self.edges_seen = 0

    def assign_chunk(self, edges: np.ndarray) -> np.ndarray:
        replicas, sizes = self.replicas, self.sizes
        allowed = self.allowed
        c = len(edges)
        assign = np.empty(c, dtype=np.int32)
        for i in range(c):
            u, v = int(edges[i, 0]), int(edges[i, 1])
            ru, rv = replicas[u], replicas[v]
            inter = ru & rv
            # Replicas only ever grow inside `allowed`, so every candidate
            # set below is already a subset of the mask.
            if inter.any():
                cand = inter
            elif ru.any() and rv.any():
                cand = ru | rv
            elif ru.any():
                cand = ru
            elif rv.any():
                cand = rv
            else:
                cand = allowed
            masked = np.where(cand, sizes, np.iinfo(np.int64).max)
            p = int(np.argmin(masked))
            assign[i] = p
            sizes[p] += 1
            replicas[u, p] = True
            replicas[v, p] = True
        self.edges_seen += c
        return assign


def hdrf_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    lam: float = 1.1,
    eps: float = 1.0,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """HDRF single-edge streaming (Petroni et al.) — numpy oracle.

    score(e=(u,v), p) = C_rep + lam * C_bal with
      C_rep = g(u,p) + g(v,p),   g(x,p) = 1{p in R_x} * (1 + (1 - theta_x))
      theta_u = deg(u) / (deg(u) + deg(v))
      C_bal = (maxsize - size_p) / (eps + maxsize - minsize)
    quantized to 1/64 steps. Partial degrees are updated as the stream is
    consumed. lam=1.1 is the authors' recommended default.
    """
    t0 = time.perf_counter()
    state = HdrfState(num_vertices, k, lam=lam, eps=eps, seed=seed,
                      allowed=allowed)
    assign = state.assign_chunk(edges)
    return PartitionResult(
        assign,
        dict(k=k, wall_time_s=time.perf_counter() - t0, name="hdrf",
             score_count=len(edges) * k),
    )


def greedy_partition(
    edges: np.ndarray, num_vertices: int, k: int, seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """PowerGraph Greedy (Gonzalez et al., OSDI'12) placement rules.

    1. If R_u and R_v intersect: least-loaded partition in the intersection.
    2. Else if both non-empty: least-loaded partition in R_u | R_v.
    3. Else if one non-empty: least-loaded partition in it.
    4. Else: least-loaded allowed partition overall.
    """
    t0 = time.perf_counter()
    state = GreedyState(num_vertices, k, allowed=allowed)
    assign = state.assign_chunk(edges)
    return PartitionResult(
        assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="greedy")
    )


# ----------------------------------------------------------------------------
# Step-cores: the same math as in-place steps on the scan driver
# ----------------------------------------------------------------------------


def _clone(carry):
    return type(carry)(*(t.clone() for t in carry))


class HdrfCarry(NamedTuple):
    deg: torch.Tensor  # (V+1,) int32 — row V is a scatter dump
    replicas: torch.Tensor  # (V+1, K) bool
    sizes: torch.Tensor  # (K,) int32
    terms: torch.Tensor  # (K,) int64 — the tie hash's partition and seed terms
    cursor: torch.Tensor  # () int32
    assigned: torch.Tensor  # () int32

    clone = _clone


class GreedyCarry(NamedTuple):
    replicas: torch.Tensor  # (V+1, K) bool
    sizes: torch.Tensor  # (K,) int32
    cursor: torch.Tensor  # () int32
    assigned: torch.Tensor  # () int32

    clone = _clone


def _zeros_i32(device, *shape):
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _warm_tables(num_vertices, k, warm, device):
    """(V+1, K) replicas and (V+1,) degrees of a WarmState, dump row 0."""
    rep = torch.zeros((num_vertices + 1, k), dtype=torch.bool, device=device)
    rep[:num_vertices] = torch.as_tensor(np.asarray(warm.replicas, bool))
    deg = _zeros_i32(device, num_vertices + 1)
    deg[:num_vertices] = torch.as_tensor(np.asarray(warm.deg).astype(np.int32))
    sizes = torch.as_tensor(np.asarray(warm.sizes).astype(np.int32), device=device)
    return rep, deg, sizes


def _edge_at(stream, m_real, cursor, v_dummy, s_off):
    """Each instance's edge of the step: (z,) live flag and int32 live, its
    endpoints (the dump row V once the stream is exhausted) and the (z,)
    stream row, from the (z, m_pad, 2) streams (``s_off``: their
    :func:`~repro_torch.core.adwise.instance_offsets`)."""
    m_pad = stream.shape[1]
    live = cursor < m_real
    live_i = live.to(torch.int32)
    row = stream.view(-1, 2).index_select(0, at_rows(cursor % m_pad, s_off))  # % = the ring index
    u = torch.where(live, row[:, 0], v_dummy)
    v = torch.where(live, row[:, 1], v_dummy)
    return cursor, live, live_i, u, v


def _emit(out, cur, live, live_i, p, carry) -> None:
    """Write the step's StepOut row at ``out.t`` and advance the counters."""
    row = out.t
    z = cur.shape[0]
    out.sidx.index_copy_(0, row, torch.where(live, cur, -1).view(1, z, 1))
    out.p.index_copy_(0, row, torch.where(live, p, 0).view(1, z, 1))
    out.w_cap.index_fill_(0, row, 1)
    out.t.add_(1)
    carry.cursor.add_(live_i)
    carry.assigned.add_(live_i)


def _balance_q(sizes, allowed, eps_q):
    """(z, K) int32 quantized HDRF balance term over the allowed loads."""
    mx = torch.where(allowed, sizes, _I32_MIN).amax(-1, keepdim=True)
    mn = torch.where(allowed, sizes, _I32_MAX).amin(-1, keepdim=True)
    gap = (mx - sizes).clamp(0, _DEG_CLAMP)
    return (gap * QB) // (eps_q + (mx - mn).clamp_max(_DEG_CLAMP))


def _theta_q(du, dv):
    """Quantized (2 - θ)·64 of both endpoints, from clamped degrees."""
    a = (du + dv).clamp_min(1)
    return ((2 * a - du) * QB) // a, ((2 * a - dv) * QB) // a


def _place(replicas, sizes, ug, vg, p, live, live_i, k_off) -> None:
    """Record each instance's edge on its partition p: both replicas (rows
    ``ug``/``vg`` of the flattened (z·(V+1), K) table) and the load. Not
    live, u = v = the dump row, which is written with False and never
    read."""
    z = p.shape[0]
    replicas.index_put_((torch.stack([ug, vg]), p.expand(2, z)), live.expand(2, z))
    sizes.view(-1).index_add_(0, at_rows(p, k_off), live_i)


@dataclasses.dataclass(frozen=True)
class HdrfCore(StepCore):
    """HDRF as a chunk-resumable step-core: one edge per instance per step.

    Bit-identical to :class:`HdrfState` — integer-quantized scoring, tie
    noise from the counter-based hash of (cursor, partition, seed). The step
    updates ``deg`` before it scores, adding twice on a self-loop. The tie
    hash's seed and partition terms live in the carry as a (K,) int64 table
    per instance; :meth:`seed_instances` gives instance i the seed
    ``seed + ids[i]``.
    """

    num_vertices: int
    k: int
    lam: float = 1.1
    eps: float = 1.0
    seed: int = dataclasses.field(default=0, compare=False)

    name = "hdrf"

    def init_carry(self, budget: float, device: torch.device) -> HdrfCarry:
        v1 = self.num_vertices + 1
        return HdrfCarry(
            deg=_zeros_i32(device, v1),
            replicas=torch.zeros((v1, self.k), dtype=torch.bool, device=device),
            sizes=_zeros_i32(device, self.k),
            terms=_tie_terms(self.k, self.seed, device),
            cursor=_zeros_i32(device),
            assigned=_zeros_i32(device),
        )

    def warm_carry(self, budget: float, warm: WarmState, device: torch.device) -> HdrfCarry:
        rep, deg, sizes = _warm_tables(self.num_vertices, self.k, warm, device)
        return self.init_carry(budget, device)._replace(deg=deg, replicas=rep, sizes=sizes)

    def seed_instances(self, carry: HdrfCarry, z: int, ids: np.ndarray) -> HdrfCarry:
        # Keyed on the caller's global ids, not the batch position, so
        # length-bucketed batches reproduce the unbucketed tie streams.
        dev = carry.terms.device
        terms = torch.stack([_tie_terms(self.k, self.seed + int(i), dev) for i in ids])
        return carry._replace(terms=terms)

    def make_step(self, stream, m_real, allowed, cap, prev_assign):
        v_dummy, k = self.num_vertices, self.k
        v1 = v_dummy + 1
        lam_q, eps_q = _lam_q(self.lam), _eps_q(self.eps)
        z, dev = stream.shape[0], stream.device
        s_off, v_off, k_off = (instance_offsets(z, n, dev) for n in (stream.shape[1], v1, k))

        def step(carry: HdrfCarry, out) -> None:
            cur, live, live_i, u, v = _edge_at(stream, m_real, carry.cursor, v_dummy, s_off)
            ug, vg = at_rows(u, v_off), at_rows(v, v_off)
            deg = carry.deg.view(-1)
            deg.index_add_(0, ug, live_i)
            deg.index_add_(0, vg, live_i)
            du = deg.index_select(0, ug).clamp_max(_DEG_CLAMP)
            dv = deg.index_select(0, vg).clamp_max(_DEG_CLAMP)
            tq_u, tq_v = _theta_q(du, dv)
            rep = carry.replicas.view(-1, k)
            rep_q = (rep.index_select(0, ug) * tq_u[:, None]
                     + rep.index_select(0, vg) * tq_v[:, None])
            score_q = QB * rep_q + lam_q * _balance_q(carry.sizes, allowed, eps_q)
            tie = tie_hash_torch(cur, carry.terms)
            combined = torch.where(allowed, (score_q << TIE_BITS) + tie, -1)
            p = combined.argmax(1).to(torch.int32)  # first maximum
            _place(rep, carry.sizes, ug, vg, p, live, live_i, k_off)
            _emit(out, cur, live, live_i, p, carry)

        return step


@dataclasses.dataclass(frozen=True)
class GreedyCore(StepCore):
    """PowerGraph Greedy as a step-core: one edge per instance per step.

    All-integer (argmin over masked loads, first-occurrence ties) — exactly
    the :class:`GreedyState` loop, its candidate set the same four-way
    nested choice.
    """

    num_vertices: int
    k: int

    name = "greedy"

    def init_carry(self, budget: float, device: torch.device) -> GreedyCarry:
        return GreedyCarry(
            replicas=torch.zeros((self.num_vertices + 1, self.k), dtype=torch.bool,
                                 device=device),
            sizes=_zeros_i32(device, self.k),
            cursor=_zeros_i32(device),
            assigned=_zeros_i32(device),
        )

    def warm_carry(self, budget: float, warm: WarmState, device: torch.device) -> GreedyCarry:
        rep, _, sizes = _warm_tables(self.num_vertices, self.k, warm, device)
        return self.init_carry(budget, device)._replace(replicas=rep, sizes=sizes)

    def make_step(self, stream, m_real, allowed, cap, prev_assign):
        v_dummy, k = self.num_vertices, self.k
        v1 = v_dummy + 1
        z, dev = stream.shape[0], stream.device
        s_off, v_off, k_off = (instance_offsets(z, n, dev) for n in (stream.shape[1], v1, k))

        def step(carry: GreedyCarry, out) -> None:
            cur, live, live_i, u, v = _edge_at(stream, m_real, carry.cursor, v_dummy, s_off)
            ug, vg = at_rows(u, v_off), at_rows(v, v_off)
            rep = carry.replicas.view(-1, k)
            ru = rep.index_select(0, ug)  # (z, K)
            rv = rep.index_select(0, vg)
            inter = ru & rv
            has_u, has_v = ru.any(1, keepdim=True), rv.any(1, keepdim=True)
            cand = torch.where(
                inter.any(1, keepdim=True),
                inter,
                torch.where(
                    has_u & has_v,
                    ru | rv,
                    torch.where(has_u, ru, torch.where(has_v, rv, allowed)),
                ),
            )
            p = torch.where(cand, carry.sizes, _I32_MAX).argmin(1).to(torch.int32)  # first minimum
            _place(rep, carry.sizes, ug, vg, p, live, live_i, k_off)
            _emit(out, cur, live, live_i, p, carry)

        return step


def _scan_partition(
    core,
    edges: np.ndarray,
    *,
    allowed: Optional[np.ndarray] = None,
    warm: Optional[WarmState] = None,
    backend: str = "vmap",
    n_chunks: int = 8,
    trace=None,
    device=None,
) -> PartitionResult:
    """Run a single-instance step-core over a resident stream."""
    from repro_torch.core.adwise import _assignment
    from repro_torch.core.driver import ResidentSource, ScanDriver

    m = int(len(edges))
    if m == 0:
        return PartitionResult(np.zeros((0,), np.int32), dict(k=core.k, unassigned=0))
    source = ResidentSource(
        np.ascontiguousarray(edges, np.int32).reshape(1, m, 2),
        np.array([m], np.int64),
    )
    drv = ScanDriver(
        source, core,
        allowed=None if allowed is None else np.asarray(allowed, bool)[None],
        warm=None if warm is None else [warm],
        backend=backend,
        trace=trace,
        device=device,
    )
    res = drv.run(n_chunks=n_chunks)
    assign, _ = _assignment(res, 0, m, f"{core.name} scan")
    stats = dict(drv.stats_base(res, 0), unassigned=0)
    if trace is not None and trace.enabled:
        stats["trace_summary"] = trace.summary().as_dict()
    return PartitionResult(assign, stats)


def hdrf_partition_scan(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    lam: float = 1.1,
    eps: float = 1.0,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
    backend: str = "vmap",
    device=None,
) -> PartitionResult:
    """HDRF via the :class:`HdrfCore` step-core — bit-identical to
    :func:`hdrf_partition` (the numpy oracle)."""
    core = HdrfCore(num_vertices=int(num_vertices), k=int(k),
                    lam=float(lam), eps=float(eps), seed=int(seed))
    return _scan_partition(core, edges, allowed=allowed, backend=backend, device=device)


def greedy_partition_scan(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
    backend: str = "vmap",
    device=None,
) -> PartitionResult:
    """Greedy via the :class:`GreedyCore` step-core — bit-identical to
    :func:`greedy_partition` (the numpy oracle)."""
    core = GreedyCore(num_vertices=int(num_vertices), k=int(k))
    return _scan_partition(core, edges, allowed=allowed, backend=backend, device=device)
