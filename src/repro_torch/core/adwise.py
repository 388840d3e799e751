"""ADWISE as a streaming computation on torch tensors.

Port of the JAX package's ``core/adwise.py``. One loop iteration of the
paper's Algorithm 1 (refill the window → rescore the stale rows → masked
argmax over window × partitions → assign → adapt λ and the window) is one
*step* on a fixed-shape carry. The JAX package scans a pure step with
``lax.scan``; here the step updates the carry **in place** and writes its
:class:`StepOut` row at a device-side step counter, so it issues no host
sync and reads no tensor's value on the host. That makes it capturable: on
the card the driver (:mod:`repro_torch.core.driver`) records a few steps in a
``torch.cuda.CUDAGraph`` and replays it; on the CPU the same step runs in a
plain loop.

The lazily rescored rows (R + CS) go through the hand-written
``window_score`` kernel (``kernels.ops.window_score_rows``) — the JAX step
inlines that math. Everything else keeps the JAX step's operation order,
so on the CPU every carry field is bit-equal to the JAX step's, except Θ,
whose fp32 sum over the window may differ from XLA's summation order in the
last bit (``tests/test_torch_adwise.py`` holds both).

Two scatter dumps keep the shapes static, as in the JAX step: row V of the
vertex tables, and row W (``window_max``) of the three lazy-traversal caches
(the JAX step pads and slices them per step; here the padding lives in the
carry, and :mod:`repro_torch.convert` adds / strips it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.kernels import ops

__all__ = ["partition_stream", "Carry", "StepOut", "WarmState"]

NEG_INF = scoring.NEG_INF
_BIG_I32 = 2**31 - 1
_I32 = torch.int32
_F32 = torch.float32


class Carry(NamedTuple):
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


class StepOut(NamedTuple):
    """Per-step outputs, one row per step, written at the device-side
    counter ``t`` ((1,) int64) that each step advances."""

    sidx: torch.Tensor  # (T, b) int32 — stream index assigned (-1 = none)
    p: torch.Tensor  # (T, b) int32
    w_cap: torch.Tensor  # (T,) int32
    g_chosen: torch.Tensor  # (T,) f32 — best score of the step
    t: torch.Tensor  # (1,) int64 — next row to write

    @classmethod
    def empty(cls, n_steps: int, b: int, device: torch.device) -> "StepOut":
        return cls(
            sidx=torch.full((n_steps, b), -1, dtype=_I32, device=device),
            p=torch.zeros((n_steps, b), dtype=_I32, device=device),
            w_cap=torch.zeros((n_steps,), dtype=_I32, device=device),
            g_chosen=torch.zeros((n_steps,), dtype=_F32, device=device),
            t=torch.zeros((1,), dtype=torch.int64, device=device),
        )


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
    stream: torch.Tensor,  # (m_pad, 2) int32
    m_real: torch.Tensor,  # () int32
    allowed: torch.Tensor,  # (K,) bool
    cap: torch.Tensor,  # () int32 (BIG when disabled)
    has_budget: bool,
    prev_assign: Optional[torch.Tensor],  # (m_pad,) int32, -1 = none; None = cold pass
    update_deg: bool,  # False on warm-started passes (degrees already final)
):
    """Build the in-place step ``step(carry, out) -> None``.

    Every tensor the step reads besides the carry is bound here, once, so
    the addresses a captured CUDA graph records stay valid for the run.
    """
    w_max, k, b = cfg.window_max, cfg.k, cfg.assign_batch
    v_dummy = num_vertices
    m_pad = stream.shape[0]
    dev = stream.device
    slot_ids = torch.arange(w_max, dtype=_I32, device=dev)
    key_fill = slot_ids  # priority class 0: fresh window entries
    key_cand = slot_ids + w_max  # class 1: stale candidates (cached score >= Θ)
    key_sec = slot_ids + 2 * w_max  # class 2: stale secondary edges
    ones_w = torch.ones((w_max,), dtype=_I32, device=dev)
    no_trigger = torch.zeros((), dtype=torch.bool, device=dev)
    w_lo = max(1, b)
    use_cs = cfg.use_clustering

    def step(carry: Carry, out: StepOut) -> None:
        # ---- 1) Refill invalid slots up to the logical window size w. ----
        need = (carry.w_cap - carry.n_valid).clamp(0, w_max)
        avail = (m_real - carry.cursor).clamp_min(0)
        take = torch.minimum(need, avail)
        inv = ~carry.win_valid
        rank = torch.cumsum(inv, 0, dtype=_I32) - 1
        fill = inv & (rank < take)
        src = carry.cursor + rank
        src_c = src % m_pad  # floor mod, as JAX's `%`
        fill_uv = stream[src_c]
        win_uv = torch.where(fill[:, None], fill_uv, carry.win_uv)
        win_sidx = torch.where(fill, src, carry.win_sidx)
        win_valid = carry.win_valid | fill
        deg = carry.deg
        if update_deg:
            u_f = torch.where(fill, fill_uv[:, 0], v_dummy)
            v_f = torch.where(fill, fill_uv[:, 1], v_dummy)
            deg.index_add_(0, u_f, ones_w)
            deg.index_add_(0, v_f, ones_w)
            seen = torch.where(fill, torch.maximum(deg[u_f], deg[v_f]), 0)
            max_deg = torch.maximum(carry.max_deg, seen.max())
        else:
            max_deg = carry.max_deg
        sizes = carry.sizes  # becomes the net loads, then the new loads, in place
        if prev_assign is not None:
            # Buffered re-streaming revocation: release the prior placement
            # of an edge as it enters the window.
            pa = prev_assign[src_c]
            dec = fill & (pa >= 0)
            sizes.index_add_(0, torch.where(dec, pa, 0), -dec.to(_I32))
        cursor = carry.cursor + take
        n_valid = carry.n_valid + take
        u = win_uv[:, 0]
        v = win_uv[:, 1]

        # ---- 2) Lazy traversal: pick <= r_sel stale slots to rescore. ----
        ver_u = carry.rep_version[u]
        ver_v = carry.rep_version[v]
        rcs_cache = carry.cached_rcs[:w_max]
        if cfg.lazy:
            stale = win_valid & (
                (ver_u != carry.cached_ver_u[:w_max])
                | (ver_v != carry.cached_ver_v[:w_max])
                | fill
            )
        else:
            stale = win_valid
        cand = rcs_cache.amax(1) >= carry.theta
        key = torch.where(
            stale,
            torch.where(fill, key_fill, torch.where(cand, key_cand, key_sec)),
            _BIG_I32,
        )
        key_sorted, order = torch.sort(key, stable=True)
        sel_live = key_sorted[:r_sel] < _BIG_I32
        sel_idx = torch.where(sel_live, order[:r_sel], w_max)  # dump slot w_max
        sel_c = sel_idx.clamp(max=w_max - 1)

        # ---- 3) Fresh R (+ CS) for the selected rows: the kernel. ----
        rcs_rows = ops.window_score_rows(
            win_uv, win_valid, carry.replicas[u], carry.replicas[v],
            deg[u], deg[v], max_deg, sel_c.to(_I32), use_cs=use_cs,
        )
        carry.cached_rcs.index_copy_(0, sel_idx, rcs_rows)
        carry.cached_ver_u.index_copy_(0, sel_idx, ver_u[sel_c])
        carry.cached_ver_v.index_copy_(0, sel_idx, ver_v[sel_c])
        n_scored = sel_live.sum(dtype=_I32)

        # ---- 4) Score matrix g = cached RCS + λ·B, masked. ----
        bal = scoring.balance_score(sizes, allowed, cfg.eps)
        ok_p = allowed & (sizes < cap)
        g = rcs_cache + carry.lam * bal[None, :]
        g = torch.where(win_valid[:, None] & ok_p[None, :], g, NEG_INF)
        # Candidate threshold Θ = g_avg + ε in RCS units (the λ·B term is
        # common to a column). The one order-dependent fp32 sum of the step.
        rcs_max = rcs_cache.amax(1)
        nv = win_valid.sum(dtype=_F32).clamp_min(1.0)
        theta = torch.where(win_valid, rcs_max, 0.0).sum() / nv + cfg.eps

        # ---- 5) Assign the top-b vertex-disjoint window edges. ----
        g_flat = g.reshape(-1)
        g_m = g_flat
        ch = torch.zeros((w_max,), dtype=torch.bool, device=dev)
        ch_p = torch.zeros((w_max,), dtype=_I32, device=dev)
        g_sum = torch.zeros((1,), dtype=_F32, device=dev)
        out_s, out_p = [], []
        for i in range(b):
            flat = g_m.argmax().view(1)  # first maximum in (slot, p) order
            slot = flat // k
            p = (flat % k).to(_I32)
            ok = g_m.index_select(0, flat) > NEG_INF / 2
            out_s.append(torch.where(ok, win_sidx.index_select(0, slot), -1))
            out_p.append(torch.where(ok, p, 0))
            hit = (slot_ids == slot) & ok
            ch = ch | hit
            ch_p = torch.where(hit, p, ch_p)
            g_sum = g_sum + torch.where(ok, g_flat.index_select(0, flat), 0.0)
            if i + 1 < b:
                u_s, v_s = u.index_select(0, slot), v.index_select(0, slot)
                share = (u == u_s) | (u == v_s) | (v == u_s) | (v == v_s)
                g_m = torch.where(
                    (share & ok)[:, None], NEG_INF, g_m.view(w_max, k)
                ).reshape(-1)
        g_sum = g_sum.view(())
        n_ch = ch.sum(dtype=_I32)

        # ---- 6) Apply assignments to the vertex cache / partition state. ----
        sizes.index_add_(0, ch_p, ch.to(_I32))  # adds 0 where not chosen
        u_c = torch.where(ch, u, v_dummy)
        v_c = torch.where(ch, v, v_dummy)
        old_u = carry.replicas[u_c, ch_p]
        old_v = carry.replicas[v_c, ch_p]
        carry.replicas.index_put_((u_c, ch_p), old_u | ch)
        carry.replicas.index_put_((v_c, ch_p), old_v | ch)
        carry.rep_version.index_add_(0, u_c, (ch & ~old_u).to(_I32))
        carry.rep_version.index_add_(0, v_c, (ch & ~old_v).to(_I32))
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
        out.sidx.index_copy_(0, row, torch.cat(out_s).view(1, b))
        out.p.index_copy_(0, row, torch.cat(out_p).view(1, b))
        out.w_cap.index_copy_(0, row, carry.w_cap.view(1))
        out.g_chosen.index_copy_(0, row, g_sum.view(1))
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


def partition_stream(
    edges: np.ndarray,
    num_vertices: int,
    cfg: AdwiseConfig,
    *,
    allowed: Optional[np.ndarray] = None,
    n_chunks: int = 8,
    cost_per_score: Optional[float] = None,
    device=None,
) -> PartitionResult:
    """Partition an edge stream with ADWISE.

    Thin caller of :class:`repro_torch.core.driver.ScanDriver` over one
    resident stream, as in the JAX package. ``device`` defaults to ``cuda``
    (see :func:`repro_torch.compat.resolve_device`).

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
    )
    drv = ScanDriver(
        source, cfg, num_vertices,
        allowed=None if allowed is None else np.asarray(allowed, bool)[None],
        cost_per_score=cost_per_score,
        device=device,
    )
    res = drv.run(n_chunks=n_chunks)
    sidx, pout = res.sidx[0], res.p[0]
    assign = np.full((m,), -1, np.int32)
    live = sidx >= 0
    assign[sidx[live]] = pout[live]
    unassigned = int((assign < 0).sum())
    if unassigned or int(res.assigned[0]) != m:
        raise RuntimeError(
            f"partition_stream left {unassigned} of {m} edges unassigned "
            f"(scan assigned counter: {int(res.assigned[0])}) — drain loop failed"
        )
    stats = dict(
        drv.stats_base(res, 0),
        w_trace=res.w_trace[0],
        unassigned=unassigned,
    )
    return PartitionResult(assign, stats)
