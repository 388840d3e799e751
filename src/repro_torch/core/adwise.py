"""ADWISE as a streaming computation on torch tensors.

Port of the JAX package's ``core/adwise.py``. One loop iteration of the
paper's Algorithm 1 (refill the window → rescore the stale rows → masked
argmax over window × partitions → assign → adapt λ and the window) is one
*step* on a fixed-shape carry. The JAX package scans a pure step with
``lax.scan`` and ``vmap``s it over a leading instance axis; here the step
updates the carry **in place** and writes its :class:`StepOut` row at a
device-side step counter, so it issues no host sync and reads no tensor's
value on the host. That makes it capturable: on the card the driver
(:mod:`repro_torch.core.driver`) records a few steps in a
``torch.cuda.CUDAGraph`` and replays it; on the CPU the same step runs in a
plain loop.

Every carry field carries a leading instance axis ``z``: one step advances
all z instances (spotlight's parallel partitioner instances, §III-D) at
once, with the same kernels as one instance — the (z, V+1, K) replica
tables are scattered through their flattened ``(z·(V+1))`` row index
``inst·(V+1) + v``, which keeps each instance's dump row V, and the sorts,
reductions and the top-b argmax run along the instance rows. A single
instance is the z = 1 case of the same step (:func:`partition_stream`), as
in the JAX package; at z = 1 the offsets are zero and are not added.

The lazily rescored rows (R + CS) of all instances go through one launch of
the hand-written ``window_score`` kernel
(``kernels.ops.window_score_rows_batched``) — the JAX step inlines that
math. Everything else keeps the JAX step's operation order, so on the CPU
every carry field is bit-equal to the JAX step's, except Θ: its sum over
the window is taken in fp64 and rounded once to fp32, where the JAX step
sums in fp32 in XLA's order (``tests/test_torch_adwise.py`` holds both to
the W·2⁻²⁴ bound of an fp32 sum). The fp64 sum is exact at the step's
values (0, or at least 1/(2W) and below 8, for W ≤ 4096: every partial sum
fits in 53 bits), so Θ does not depend on the order of the adds — the same
for every z, on either device, however the reduction is split.

Two scatter dumps keep the shapes static, as in the JAX step: row V of the
vertex tables, and row W (``window_max``) of the three lazy-traversal caches
(the JAX step pads and slices them per step; here the padding lives in the
carry, and :mod:`repro_torch.convert` adds / strips it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.kernels import ops

__all__ = [
    "partition_stream",
    "partition_stream_batched",
    "Carry",
    "StepOut",
    "WarmState",
    "stack_instances",
    "take_instance",
    "instance_offsets",
    "at_rows",
]

NEG_INF = scoring.NEG_INF
_BIG_I32 = 2**31 - 1
_I32 = torch.int32
_F32 = torch.float32


class Carry(NamedTuple):
    """One instance's carry (the shapes below); the step and the driver hold
    z of them stacked on a leading instance axis (:func:`stack_instances`)."""

    # Vertex cache.
    replicas: torch.Tensor  # (V+1, K) bool — row V is a scatter dump
    rep_version: torch.Tensor  # (V+1,) int32
    deg: torch.Tensor  # (V+1,) int32
    max_deg: torch.Tensor  # () int32
    # Partition state.
    sizes: torch.Tensor  # (K,) int32
    lam: torch.Tensor  # () f32
    # Window.
    w_cap: torch.Tensor  # () int32 — logical window size w
    cursor: torch.Tensor  # () int32 — next stream index
    n_valid: torch.Tensor  # () int32
    win_uv: torch.Tensor  # (W, 2) int32
    win_sidx: torch.Tensor  # (W,) int32 — stream index per slot
    win_valid: torch.Tensor  # (W,) bool
    # Lazy traversal caches (row W is a scatter dump).
    cached_rcs: torch.Tensor  # (W+1, K) f32 — cached R + CS per slot
    cached_ver_u: torch.Tensor  # (W+1,) int32
    cached_ver_v: torch.Tensor  # (W+1,) int32
    theta: torch.Tensor  # () f32 — candidate threshold Θ from previous step
    # Counters / controller.
    assigned: torch.Tensor  # () int32
    score_rows: torch.Tensor  # () int32
    c: torch.Tensor  # () int32 — assignments since last window adaptation
    sum_g: torch.Tensor  # () f32
    avg_g_prev: torch.Tensor  # () f32
    last_grew: torch.Tensor  # () bool
    budget_left: torch.Tensor  # () f32 seconds
    lat_ema: torch.Tensor  # () f32 — per-edge modeled latency EMA
    # Calibrated latency model.
    cost_per_score: torch.Tensor  # () f32
    base_cost: torch.Tensor  # () f32

    def clone(self) -> "Carry":
        return Carry(*(t.clone() for t in self))

    @classmethod
    def warm_start(
        cls,
        cfg: AdwiseConfig,
        num_vertices: int,
        budget: float,
        *,
        replicas: np.ndarray,  # (V, K) bool — replica table of the prior pass
        deg: np.ndarray,  # (V,) int — streamed degrees of the prior pass
        sizes: np.ndarray,  # (K,) int — partition loads of the prior pass
        device: torch.device,
    ) -> "Carry":
        """Carry warm-started from a previous pass's tables (re-streaming).

        λ restarts at ``cfg.lam_init`` and re-anneals over the new pass, and
        the window controller starts fresh; the replica table, degree table
        (``max_deg = max(max(deg), 1)``) and partition loads carry over.
        """
        base = _init_carry(cfg, num_vertices, budget, device)
        base.replicas[:num_vertices] = torch.as_tensor(np.asarray(replicas, bool))
        base.deg[:num_vertices] = torch.as_tensor(np.asarray(deg).astype(np.int32))
        return base._replace(
            max_deg=base.deg.max().clamp_min(1),
            sizes=torch.as_tensor(np.asarray(sizes).astype(np.int32), device=device),
        )


class StepOut(NamedTuple):
    """Per-step outputs of z instances, one row per step, written at the
    device-side counter ``t`` ((1,) int64) that each step advances."""

    sidx: torch.Tensor  # (T, z, b) int32 — stream index assigned (-1 = none)
    p: torch.Tensor  # (T, z, b) int32
    w_cap: torch.Tensor  # (T, z) int32
    g_chosen: torch.Tensor  # (T, z) f32 — best score of the step
    t: torch.Tensor  # (1,) int64 — next row to write

    @classmethod
    def empty(cls, n_steps: int, z: int, b: int, device: torch.device) -> "StepOut":
        return cls(
            sidx=torch.full((n_steps, z, b), -1, dtype=_I32, device=device),
            p=torch.zeros((n_steps, z, b), dtype=_I32, device=device),
            w_cap=torch.zeros((n_steps, z), dtype=_I32, device=device),
            g_chosen=torch.zeros((n_steps, z), dtype=_F32, device=device),
            t=torch.zeros((1,), dtype=torch.int64, device=device),
        )


def stack_instances(carries: Sequence[NamedTuple]) -> NamedTuple:
    """z per-instance carries (any NamedTuple of tensors) as one carry with
    a leading instance axis; every field is a fresh tensor."""
    first = carries[0]
    return type(first)(*(torch.stack(xs) for xs in zip(*carries)))


def take_instance(carry: NamedTuple, i: int) -> NamedTuple:
    """Instance ``i`` of a stacked carry (views, no copy)."""
    return type(carry)(*(t[i] for t in carry))


def instance_offsets(z: int, n: int, device, dtype=torch.int32) -> Optional[torch.Tensor]:
    """(z,) offsets ``i·n`` that turn row r of instance i's n-row table into
    row ``i·n + r`` of the tables flattened over the instance axis; None at
    z = 1, where there is nothing to add."""
    return None if z == 1 else torch.arange(z, dtype=dtype, device=device) * n


def at_rows(rows: torch.Tensor, off: Optional[torch.Tensor]) -> torch.Tensor:
    """``rows`` (leading instance axis) as rows of the flattened tables."""
    return rows if off is None else rows + off.view((-1,) + (1,) * (rows.dim() - 1))


def _init_carry(
    cfg: AdwiseConfig, num_vertices: int, budget: float, device: torch.device
) -> Carry:
    v1 = num_vertices + 1
    w, k = cfg.window_max, cfg.k

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    return Carry(
        replicas=torch.zeros((v1, k), dtype=torch.bool, device=device),
        rep_version=torch.zeros((v1,), dtype=_I32, device=device),
        deg=torch.zeros((v1,), dtype=_I32, device=device),
        max_deg=scalar(1, _I32),
        sizes=torch.zeros((k,), dtype=_I32, device=device),
        lam=scalar(cfg.lam_init, _F32),
        w_cap=scalar(max(cfg.window_init, cfg.assign_batch), _I32),
        cursor=scalar(0, _I32),
        n_valid=scalar(0, _I32),
        win_uv=torch.zeros((w, 2), dtype=_I32, device=device),
        win_sidx=torch.full((w,), -1, dtype=_I32, device=device),
        win_valid=torch.zeros((w,), dtype=torch.bool, device=device),
        cached_rcs=torch.zeros((w + 1, k), dtype=_F32, device=device),
        cached_ver_u=torch.full((w + 1,), -1, dtype=_I32, device=device),
        cached_ver_v=torch.full((w + 1,), -1, dtype=_I32, device=device),
        theta=scalar(0.0, _F32),
        assigned=scalar(0, _I32),
        score_rows=scalar(0, _I32),
        c=scalar(0, _I32),
        sum_g=scalar(0.0, _F32),
        avg_g_prev=scalar(-np.inf, _F32),
        last_grew=scalar(True, torch.bool),
        budget_left=scalar(budget, _F32),
        lat_ema=scalar(0.0, _F32),
        cost_per_score=scalar(1e-8, _F32),
        base_cost=scalar(1e-7, _F32),
    )


def _make_step(
    cfg: AdwiseConfig,
    num_vertices: int,
    r_sel: int,
    stream: torch.Tensor,  # (z, m_pad, 2) int32
    m_real: torch.Tensor,  # (z,) int32
    allowed: torch.Tensor,  # (z, K) bool
    cap: torch.Tensor,  # (z,) int32 (BIG when disabled)
    has_budget: bool,
    prev_assign: torch.Tensor,  # (z, m_pad) int32 prior placements, -1 = none
    update_deg: bool,  # False on warm-started passes (degrees already final)
):
    """Build the in-place step ``step(carry, out) -> None`` over z instances.

    Every tensor the step reads besides the carry is bound here, once, so
    the addresses a captured CUDA graph records stay valid for the run.
    """
    w_max, k, b = cfg.window_max, cfg.k, cfg.assign_batch
    z, m_pad = stream.shape[0], stream.shape[1]
    v1 = num_vertices + 1
    dev = stream.device
    slot_ids = torch.arange(w_max, dtype=_I32, device=dev)
    key_fill = slot_ids  # priority class 0: fresh window entries
    key_cand = slot_ids + w_max  # class 1: stale candidates (cached score >= Θ)
    key_sec = slot_ids + 2 * w_max  # class 2: stale secondary edges
    ones_w = torch.ones((z * w_max,), dtype=_I32, device=dev)
    neg_ones_w = -ones_w.view(z, w_max)
    no_trigger = torch.zeros((z,), dtype=torch.bool, device=dev)
    w_lo = max(1, b)
    use_cs = cfg.use_clustering
    stream_rows = stream.reshape(z * m_pad, 2)
    prev_rows = prev_assign.reshape(z * m_pad)
    s_off = instance_offsets(z, m_pad, dev)  # stream rows
    v_off = instance_offsets(z, v1, dev)  # vertex-table rows
    k_off = instance_offsets(z, k, dev)  # partition loads
    w_off = instance_offsets(z, w_max + 1, dev, torch.int64)  # lazy-cache slots
    # Each instance's dump row V of the flattened vertex tables.
    v_dump = num_vertices if v_off is None else (v_off + num_vertices)[:, None]

    def step(carry: Carry, out: StepOut) -> None:
        deg_rows = carry.deg.view(z * v1)
        sizes_rows = carry.sizes.view(z * k)  # becomes the net loads, then the new loads
        rv_rows = carry.rep_version.view(z * v1)
        rep_rows = carry.replicas.view(z * v1, k)
        # ---- 1) Refill invalid slots up to the logical window size w. ----
        need = (carry.w_cap - carry.n_valid).clamp(0, w_max)
        avail = (m_real - carry.cursor).clamp_min(0)
        take = torch.minimum(need, avail)[:, None]
        inv = ~carry.win_valid
        rank = torch.cumsum(inv, 1, dtype=_I32) - 1
        fill = inv & (rank < take)
        src = carry.cursor[:, None] + rank
        src_c = at_rows(src % m_pad, s_off)  # floor mod, as JAX's `%`
        fill_uv = stream_rows.index_select(0, src_c.view(-1)).view(z, w_max, 2)
        win_uv = torch.where(fill[..., None], fill_uv, carry.win_uv)
        win_sidx = torch.where(fill, src, carry.win_sidx)
        win_valid = carry.win_valid | fill
        if update_deg:
            fill_g = at_rows(fill_uv, v_off)
            u_f = torch.where(fill, fill_g[..., 0], v_dump).view(-1)
            v_f = torch.where(fill, fill_g[..., 1], v_dump).view(-1)
            deg_rows.index_add_(0, u_f, ones_w)
            deg_rows.index_add_(0, v_f, ones_w)
            seen = torch.where(
                fill, torch.maximum(deg_rows[u_f], deg_rows[v_f]).view(z, w_max), 0
            )
            max_deg = torch.maximum(carry.max_deg, seen.amax(1))
        else:
            max_deg = carry.max_deg
        # Buffered re-streaming revocation: release the prior placement of
        # an edge as it enters the window (all -1 on a cold pass).
        pa = prev_rows.index_select(0, src_c.view(-1)).view(z, w_max)
        dec = fill & (pa >= 0)
        sizes_rows.index_add_(
            0, at_rows(torch.where(dec, pa, 0), k_off).view(-1),
            torch.where(dec, neg_ones_w, 0).view(-1),
        )
        sizes = carry.sizes
        cursor = carry.cursor + take[:, 0]
        n_valid = carry.n_valid + take[:, 0]
        u = win_uv[..., 0]
        v = win_uv[..., 1]
        win_g = at_rows(win_uv, v_off)
        u_g = win_g[..., 0]  # rows of the flattened vertex tables
        v_g = win_g[..., 1]

        # ---- 2) Lazy traversal: pick <= r_sel stale slots to rescore. ----
        ver_u = rv_rows[u_g]
        ver_v = rv_rows[v_g]
        rcs_cache = carry.cached_rcs[:, :w_max]
        if cfg.lazy:
            stale = win_valid & (
                (ver_u != carry.cached_ver_u[:, :w_max])
                | (ver_v != carry.cached_ver_v[:, :w_max])
                | fill
            )
        else:
            stale = win_valid
        cand = rcs_cache.amax(2) >= carry.theta[:, None]
        key = torch.where(
            stale,
            torch.where(fill, key_fill, torch.where(cand, key_cand, key_sec)),
            _BIG_I32,
        )
        key_sorted, order = torch.sort(key, dim=1, stable=True)
        sel_live = key_sorted[:, :r_sel] < _BIG_I32
        sel_idx = torch.where(sel_live, order[:, :r_sel], w_max)  # dump slot w_max
        sel_c = sel_idx.clamp(max=w_max - 1)

        # ---- 3) Fresh R (+ CS) for the selected rows: the kernel. ----
        rcs_rows = ops.window_score_rows_batched(
            win_uv, win_valid, carry.replicas, carry.deg, max_deg, sel_c, use_cs=use_cs,
        )
        sel_rows = at_rows(sel_idx, w_off).view(-1)
        carry.cached_rcs.view(z * (w_max + 1), k).index_copy_(
            0, sel_rows, rcs_rows.view(z * r_sel, k))
        carry.cached_ver_u.view(-1).index_copy_(0, sel_rows, ver_u.gather(1, sel_c).view(-1))
        carry.cached_ver_v.view(-1).index_copy_(0, sel_rows, ver_v.gather(1, sel_c).view(-1))
        n_scored = sel_live.sum(1, dtype=_I32)

        # ---- 4) Score matrix g = cached RCS + λ·B, masked. ----
        bal = scoring.balance_score(sizes, allowed, cfg.eps)
        ok_p = allowed & (sizes < cap[:, None])
        g = rcs_cache + carry.lam[:, None, None] * bal[:, None, :]
        g = torch.where(win_valid[..., None] & ok_p[:, None, :], g, NEG_INF)
        # Candidate threshold Θ = g_avg + ε in RCS units (the λ·B term is
        # common to a column); the sum is exact in fp64 (module docstring).
        rcs_max = rcs_cache.amax(2)
        nv = win_valid.sum(1, dtype=_F32).clamp_min(1.0)
        theta = (
            torch.where(win_valid, rcs_max, 0.0).sum(1, dtype=torch.float64).to(_F32) / nv
            + cfg.eps
        )

        # ---- 5) Assign the top-b vertex-disjoint window edges. ----
        g_flat = g.reshape(z, w_max * k)
        g_m = g_flat
        ch = torch.zeros((z, w_max), dtype=torch.bool, device=dev)
        ch_p = torch.zeros((z, w_max), dtype=_I32, device=dev)
        g_sum = torch.zeros((z, 1), dtype=_F32, device=dev)
        out_s, out_p = [], []
        for i in range(b):
            flat = g_m.argmax(1, keepdim=True)  # first maximum in (slot, p) order
            slot = flat // k
            p = (flat % k).to(_I32)
            ok = g_m.gather(1, flat) > NEG_INF / 2
            out_s.append(torch.where(ok, win_sidx.gather(1, slot), -1))
            out_p.append(torch.where(ok, p, 0))
            hit = (slot_ids == slot) & ok
            ch = ch | hit
            ch_p = torch.where(hit, p, ch_p)
            g_sum = g_sum + torch.where(ok, g_flat.gather(1, flat), 0.0)
            if i + 1 < b:
                u_s, v_s = u.gather(1, slot), v.gather(1, slot)
                share = (u == u_s) | (u == v_s) | (v == u_s) | (v == v_s)
                g_m = torch.where(
                    (share & ok)[..., None], NEG_INF, g_m.view(z, w_max, k)
                ).reshape(z, w_max * k)
        g_sum = g_sum.view(z)
        n_ch = ch.sum(1, dtype=_I32)

        # ---- 6) Apply assignments to the vertex cache / partition state. ----
        sizes_rows.index_add_(0, at_rows(ch_p, k_off).view(-1), ch.to(_I32).view(-1))  # 0 where not chosen
        u_c = torch.where(ch, u_g, v_dump)
        v_c = torch.where(ch, v_g, v_dump)
        old_u = rep_rows[u_c, ch_p]
        old_v = rep_rows[v_c, ch_p]
        rep_rows.index_put_((u_c, ch_p), old_u | ch)
        rep_rows.index_put_((v_c, ch_p), old_v | ch)
        rv_rows.index_add_(0, u_c.view(-1), (ch & ~old_u).to(_I32).view(-1))
        rv_rows.index_add_(0, v_c.view(-1), (ch & ~old_v).to(_I32).view(-1))
        win_valid = win_valid & ~ch
        n_valid = n_valid - n_ch
        assigned = carry.assigned + n_ch
        lam = scoring.lambda_update(
            carry.lam, sizes, allowed, assigned, m_real, cfg.lam_lo, cfg.lam_hi
        )

        # ---- 7) Modeled latency + adaptive window controller (§III-A). ----
        step_cost = n_scored.to(_F32) * float(k) * carry.cost_per_score + carry.base_cost
        budget_left = carry.budget_left - step_cost
        lat_edge = step_cost / n_ch.to(_F32).clamp_min(1.0)
        lat_ema = torch.where(
            carry.assigned == 0, lat_edge, 0.9 * carry.lat_ema + 0.1 * lat_edge
        )
        c = carry.c + n_ch
        sum_g = carry.sum_g + g_sum
        trigger = (c >= carry.w_cap) if cfg.adapt else no_trigger
        avg_g = sum_g / c.to(_F32).clamp_min(1.0)
        c1 = (~carry.last_grew) | (avg_g >= carry.avg_g_prev)
        if has_budget:
            edges_left = (m_real - assigned).clamp_min(1).to(_F32)
            c2 = lat_ema < budget_left / edges_left
            grow = trigger & c1 & c2 & (carry.w_cap < w_max)
            shrink = trigger & ~c2
        else:
            grow = trigger & c1 & (carry.w_cap < w_max)
            shrink = no_trigger
        w_new = torch.where(
            grow,
            (2 * carry.w_cap).clamp_max(w_max),
            torch.where(shrink, ((carry.w_cap + 1) // 2).clamp_min(w_lo), carry.w_cap),
        )

        # ---- Outputs at the step counter, then commit the carry. ----
        row = out.t
        out.sidx.index_copy_(0, row, torch.cat(out_s, 1).view(1, z, b))
        out.p.index_copy_(0, row, torch.cat(out_p, 1).view(1, z, b))
        out.w_cap.index_copy_(0, row, carry.w_cap.view(1, z))
        out.g_chosen.index_copy_(0, row, g_sum.view(1, z))
        out.t.add_(1)
        carry.c.copy_(torch.where(trigger, 0, c))
        carry.sum_g.copy_(torch.where(trigger, 0.0, sum_g))
        carry.avg_g_prev.copy_(torch.where(trigger, avg_g, carry.avg_g_prev))
        carry.last_grew.copy_(torch.where(trigger, grow, carry.last_grew))
        carry.max_deg.copy_(max_deg)
        carry.lam.copy_(lam)
        carry.w_cap.copy_(w_new)
        carry.cursor.copy_(cursor)
        carry.n_valid.copy_(n_valid)
        carry.win_uv.copy_(win_uv)
        carry.win_sidx.copy_(win_sidx)
        carry.win_valid.copy_(win_valid)
        carry.theta.copy_(theta)
        carry.assigned.copy_(assigned)
        carry.score_rows.add_(n_scored)
        carry.budget_left.copy_(budget_left)
        carry.lat_ema.copy_(lat_ema)

    return step


def _ceil_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1) — the length-bucket key."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def _assignment(res, j: int, m: int, what: str) -> tuple[np.ndarray, int]:
    """Instance j's (m,) assignment from a DriveResult; raises unless every
    edge was placed."""
    sidx, pout = res.sidx[j], res.p[j]
    assign = np.full((m,), -1, np.int32)
    live = sidx >= 0
    assign[sidx[live]] = pout[live]
    unassigned = int((assign < 0).sum())
    if unassigned or int(res.assigned[j]) != m:
        raise RuntimeError(
            f"{what} left {unassigned} of {m} edges unassigned (scan assigned "
            f"counter: {int(res.assigned[j])}) — drain loop failed"
        )
    return assign, unassigned


def partition_stream(
    edges: np.ndarray,
    num_vertices: int,
    cfg: AdwiseConfig,
    *,
    allowed: Optional[np.ndarray] = None,
    n_chunks: int = 8,
    cost_per_score: Optional[float] = None,
    warm: Optional[WarmState] = None,
    residency=None,
    trace=None,
    device=None,
) -> PartitionResult:
    """Partition an edge stream with ADWISE.

    Thin caller of :class:`repro_torch.core.driver.ScanDriver` over one
    resident instance (z = 1), as in the JAX package. ``device`` defaults to
    ``cuda`` (see :func:`repro_torch.compat.resolve_device`). ``warm``
    resumes from a previous pass's tables (degrees are then not re-counted,
    and each edge's ``warm.prev_assign`` placement, when given, is revoked
    as it re-enters the window); ``residency`` (a
    :class:`~repro_torch.core.driver.StreamResidency`) shares one device
    stream across re-streaming passes over the same edges; ``trace`` (a
    :class:`repro_torch.obs.Tracer`) records the driver's host-side
    ``scan-call`` / ``materialize`` spans, and the stats gain a
    ``trace_summary``.

    Returns a PartitionResult with ``assign`` (int32[m]) and the JAX
    package's stats keys.
    """
    from repro_torch.core.driver import ResidentSource, ScanDriver

    m = int(len(edges))
    k = cfg.k
    if m == 0:
        return PartitionResult(np.zeros((0,), np.int32), dict(k=k, unassigned=0))
    source = ResidentSource(
        np.ascontiguousarray(edges, np.int32).reshape(1, m, 2),
        np.array([m], np.int64),
        residency=residency,
    )
    drv = ScanDriver(
        source, cfg, num_vertices,
        allowed=None if allowed is None else np.asarray(allowed, bool)[None],
        warm=None if warm is None else [warm],
        cost_per_score=cost_per_score,
        trace=trace,
        device=device,
    )
    res = drv.run(n_chunks=n_chunks)
    assign, unassigned = _assignment(res, 0, m, "partition_stream")
    stats = dict(
        drv.stats_base(res, 0),
        w_trace=res.w_trace[0],
        unassigned=unassigned,
    )
    if trace is not None and trace.enabled:
        stats["trace_summary"] = trace.summary().as_dict()
    return PartitionResult(assign, stats)


def partition_stream_batched(
    streams: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    cfg: Optional[AdwiseConfig],
    *,
    core=None,
    allowed: Optional[np.ndarray] = None,
    backend: str = "auto",
    n_chunks: int = 8,
    cost_per_score: Optional[float] = None,
    warm: Optional[Sequence[WarmState]] = None,
    residency=None,
    trace=None,
    device=None,
) -> list[PartitionResult]:
    """Run ``z`` independent instance scans as ONE batched step.

    The device-parallel spotlight entry point: every step advances all z
    instances at once (one ``window_score`` launch for all of them), the
    card's counterpart of the paper's z machines. Thin caller of
    :class:`repro_torch.core.driver.ScanDriver` over a z-instance resident
    source.

    Args:
      streams: (z, per, 2) int32 — per-instance padded edge chunks
        (:meth:`repro_torch.graph.EdgeStream.split_padded` layout).
      valid: (z, per) bool — per-row *prefix* mask; row i's real stream is
        ``streams[i, :valid[i].sum()]``.
      num_vertices: |V| (shared; instances keep independent vertex caches).
      cfg: AdwiseConfig (shared by all instances); may be None when ``core``
        is given.
      core: optional step-core (``HdrfCore``, ``GreedyCore``, ``TpslCore``,
        ...) batched over the instance axis through the same driver path as
        ADWISE; per-instance state (HDRF's tie seeds ``seed + i``) comes
        from the core's ``seed_instances`` hook.
      allowed: optional (z, k) bool — per-instance spotlight spread masks.
      backend: 'auto', 'vmap' or 'shard_map', resolved per length bucket
        as the JAX package resolves it per bucket, with the ranks of the
        default process group in place of its devices
        (:func:`repro_torch.core.driver.resolve_backend`): a bucket of
        ``z_b`` instances that resolves to 'shard_map' runs as blocks of
        ``z_b / n_shards`` instances on ``n_shards`` ranks; one that
        resolves to ``('vmap', 0)`` (every bucket with no process group or
        one rank) runs whole on every rank. Every rank returns the same z
        results; ``backend`` and ``n_shards`` in each instance's stats are
        its bucket's.
      n_chunks / cost_per_score / residency / trace / device: as in
        :func:`partition_stream`.
      warm: optional length-z sequence of per-instance :class:`WarmState`;
        all instances must agree on whether ``prev_assign`` is given.

    Returns a list of z :class:`PartitionResult`; entry i's ``assign`` covers
    instance i's real stream in local order. With z == 1 and identical
    inputs it is bit-identical to :func:`partition_stream`.

    Length bucketing: instances are grouped by ``ceil_pow2(m_i)`` and each
    bucket runs as its own batched scan padded to
    ``min(ceil_pow2(max m_i in bucket), per)`` rows, so short instances do
    not idle through the longest one's tail. Results come back in the
    caller's instance order, and seed-deriving cores receive the *global*
    instance ids, so assignments equal those of the unbucketed layout.
    ``wall_time_s``, ``h2d_rows`` and ``h2d_bytes`` are summed over the
    buckets (they run back to back) and shared by every instance.
    """
    from repro_torch.core.driver import ResidentSource, ScanDriver, resolve_backend

    streams = np.ascontiguousarray(streams, np.int32)
    valid = np.asarray(valid, bool)
    if streams.ndim != 3 or streams.shape[2] != 2:
        raise ValueError(f"streams must be (z, per, 2), got {streams.shape}")
    z, per, _ = streams.shape
    if valid.shape != (z, per):
        raise ValueError(f"valid must be {(z, per)}, got {valid.shape}")
    # The refill consumes each instance stream sequentially from slot 0, so
    # validity must be a prefix per row.
    if per > 1 and not (valid[:, :-1] >= valid[:, 1:]).all():
        raise ValueError("valid must be a per-row prefix mask (padding only at the tail)")
    if core is None and cfg is None:
        raise ValueError("need a cfg or a step-core")
    k = core.k if core is not None else cfg.k
    resolve_backend(backend, z)  # validates the name
    m_per = valid.sum(axis=1).astype(np.int64)
    m_max = int(m_per.max()) if z else 0
    if allowed is not None:
        allowed = np.asarray(allowed, bool)
        if allowed.shape != (z, k):
            raise ValueError(f"allowed must be {(z, k)}, got {allowed.shape}")
    if warm is not None:
        warm = list(warm)
        if len(warm) != z:
            raise ValueError(f"need one WarmState per instance, got {len(warm)}")
    if m_max == 0:
        return [PartitionResult(np.zeros((0,), np.int32), dict(k=k, unassigned=0))
                for _ in range(z)]

    buckets: dict[int, list[int]] = {}
    for i in range(z):
        buckets.setdefault(_ceil_pow2(int(m_per[i])), []).append(i)
    runs = []  # (global ids, driver, result, padded width) per bucket
    total_wall, total_h2d_rows, total_h2d_bytes = 0.0, 0, 0
    for key in sorted(buckets):
        idx = np.asarray(buckets[key], np.int64)
        width = min(key, per)
        drv = ScanDriver(
            ResidentSource(np.ascontiguousarray(streams[idx, :width]), m_per[idx],
                           residency=residency),
            core if core is not None else cfg,
            num_vertices,
            allowed=None if allowed is None else allowed[idx],
            warm=None if warm is None else [warm[i] for i in idx],
            cost_per_score=cost_per_score,
            backend=backend,
            trace=trace,
            instance_ids=idx,
            device=device,
        )
        res_b = drv.run(n_chunks=n_chunks)
        total_wall += res_b.wall_time_s
        total_h2d_rows += res_b.h2d_rows
        total_h2d_bytes += res_b.h2d_bytes
        runs.append((idx, drv, res_b, width))
    tsum = trace.summary().as_dict() if trace is not None and trace.enabled else None
    results: list[Optional[PartitionResult]] = [None] * z
    for idx, drv, res_b, width in runs:
        for j, i in enumerate(int(g) for g in idx):
            assign, unassigned = _assignment(res_b, j, int(m_per[i]), f"batched instance {i}")
            stats = dict(
                drv.stats_base(res_b, j),
                batched=True,
                backend=res_b.backend,
                n_shards=res_b.n_shards,
                z=z,
                instance=i,
                wall_time_s=total_wall,
                h2d_rows=total_h2d_rows,
                h2d_bytes=total_h2d_bytes,
                n_buckets=len(runs),
                bucket_rows=width,
                w_trace=res_b.w_trace[j],
                unassigned=unassigned,
            )
            if tsum is not None:
                stats["trace_summary"] = tsum
            results[i] = PartitionResult(assign, stats)
    return results  # type: ignore[return-value]
