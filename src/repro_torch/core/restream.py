"""Multi-pass re-streaming: restreamed ADWISE, 2PS and 2PS-L on torch.

Port of the JAX package's ``core/restream.py`` over resident streams.
Three strategies ride one warm-start mechanism
(:meth:`repro_torch.core.adwise.Carry.warm_start` and
``StepCore.warm_carry`` in the driver):

* ``adwise-restream`` — n-pass re-streaming. Pass 1 runs any registered
  strategy (default ADWISE); every later pass re-runs the ADWISE scan over
  the same stream, warm-started from the previous pass's replica table,
  degree table and partition loads, revoking each edge's prior placement
  as it re-enters the window. The passes share one device stream through a
  :class:`~repro_torch.core.driver.StreamResidency`, so pass 2 onwards ships
  only its prev table.
* ``2ps`` — phase 1 streams a volume-capped vertex clustering and packs the
  clusters onto partitions (LPT); phase 2 is the ADWISE scan warm-started
  with one virtual replica per clustered vertex on its cluster's partition.
* ``2ps-l`` — the same phase 1, then :class:`TpslCore`: each edge scored once
  against its endpoints' cluster partitions plus the quantized HDRF balance,
  under a hard capacity cap. :class:`TpslState` is its numpy oracle.

Phase 1's per-edge clustering step is :class:`ClusterCore`, an in-place
step driven 32 steps per CUDA graph on the card, a plain loop on the CPU;
:func:`streaming_vertex_clustering_np` is its numpy oracle. The cluster
packing stays host numpy (its tie order is numpy's default ``argsort``).

The batched variants (:func:`restream_partition_batched`,
:func:`two_phase_partition_batched`) run z spotlight instances: every
ADWISE or 2PS-L pass is one batched scan over all of them
(:func:`repro_torch.core.adwise.partition_stream_batched`), while phase 1
and the warm-state hand-off between passes stay per instance, as in the
JAX package. ``trace=`` (a :class:`repro_torch.obs.Tracer`) records one
``pass``-category span per restream pass on its own lane
(``restream-pass-<j>``) and threads through to the scan drivers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import driver, registry
from repro_torch.core.adwise import (
    StepOut,
    at_rows,
    instance_offsets,
    partition_stream,
    partition_stream_batched,
)
from repro_torch.core.baselines import (
    QB,
    _DEG_CLAMP,
    _balance_q,
    _clone,
    _emit,
    _edge_at,
    _eps_q,
    _lam_q,
    _scan_partition,
    _theta_q,
    _zeros_i32,
)
from repro_torch.core.driver import StepCore, StreamResidency, resolve_backend
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.graph import metrics
from repro_torch.obs import resolve_tracer

__all__ = [
    "warm_from_assignment",
    "restream_partition",
    "restream_partition_batched",
    "two_phase_partition",
    "two_phase_partition_batched",
    "two_phase_linear_partition",
    "streaming_vertex_clustering",
    "streaming_vertex_clustering_np",
    "VertexClusteringState",
    "ClusterCore",
    "TpslCore",
    "TpslState",
]


def _degrees(edges: np.ndarray, num_vertices: int) -> np.ndarray:
    deg = np.zeros(num_vertices, dtype=np.int64)
    if len(edges):
        deg += np.bincount(edges[:, 0], minlength=num_vertices)
        deg += np.bincount(edges[:, 1], minlength=num_vertices)
    return deg


def warm_from_assignment(
    edges: np.ndarray, assign: np.ndarray, num_vertices: int, k: int
) -> WarmState:
    """WarmState for the next pass, derived from a completed assignment."""
    replicas = metrics.replica_sets_from_assignment(
        edges, assign, num_vertices, k, unassigned="drop"
    )
    sizes = metrics.partition_sizes(assign, k, unassigned="drop")
    return WarmState(
        replicas=replicas,
        deg=_degrees(edges, num_vertices),
        sizes=sizes,
        prev_assign=np.asarray(assign, np.int32),
    )


def _rd(edges: np.ndarray, assign: np.ndarray, num_vertices: int, k: int) -> float:
    return metrics.replication_degree(
        metrics.replica_sets_from_assignment(edges, assign, num_vertices, k)
    )


def _steps(stats: dict) -> int:
    # Steps run on the device, the warm-up before capture included (the
    # port's own stat: one window_score launch each on an ADWISE pass).
    return int(stats.get("steps_run", 0)) + int(stats.get("warmup_steps", 0))


def _score_rows(stats: dict, k: int) -> int:
    # Baselines report score_count = m·k but no score_rows; both count
    # toward invested latency (partition_latency's §III-B metric).
    return int(stats.get("score_rows", stats.get("score_count", 0) // max(k, 1)))


def restream_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    passes: int = 2,
    base: str = "adwise",
    keep_best: bool = True,
    eps: Optional[float] = None,
    seed: int = 0,
    n_chunks: int = 8,
    allowed: Optional[np.ndarray] = None,
    trace=None,
    device=None,
    **adwise_cfg,
) -> PartitionResult:
    """n-pass re-streaming: warm-started ADWISE over a base pass.

    Args:
      passes: total passes over the stream (1 == just the base strategy).
      base: registry strategy for pass 1. Non-adwise bases take no cfg here.
      allowed: optional (k,) bool partition mask for every pass.
      keep_best: return the pass with the lowest replication degree (quality
        is then non-increasing in ``passes``); False returns the last pass.
      eps: stop re-streaming once a pass improves RD by less than ``eps``
        (None always runs ``passes``); ``stats['passes_run']`` says how many
        ran. Distinct from ``AdwiseConfig.eps``.
      trace: optional :class:`repro_torch.obs.Tracer` — one ``pass`` span per
        pass (lane ``restream-pass-<j>``), threaded through to the scan
        drivers; the stats gain ``trace_summary``.
      device: ``cuda`` by default (:func:`repro_torch.compat.resolve_device`).
      adwise_cfg: AdwiseConfig fields for the ADWISE passes.
    """
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    tr = resolve_tracer(trace)
    device = compat.resolve_device(device)
    cfg = AdwiseConfig(k=k, seed=seed, **adwise_cfg)
    base_kw = {} if allowed is None else {"allowed": allowed}
    # Every ADWISE pass streams the same edges: share one device upload
    # across passes (later passes ship only their prev table).
    residency = StreamResidency()
    t_p1 = time.perf_counter()
    if base == "adwise":
        res = partition_stream(
            edges, num_vertices, cfg, n_chunks=n_chunks, allowed=allowed,
            residency=residency, trace=trace, device=device,
        )
    else:
        res = registry.run_partitioner(
            base, edges, num_vertices, k, seed=seed, device=device, **base_kw
        )

    pass_rd: List[float] = [_rd(edges, res.assign, num_vertices, k)]
    if tr.enabled:
        tr.add_span(
            "pass-1", "pass", t_p1, time.perf_counter(),
            track="restream-pass-1", attrs=dict(base=base, rd=pass_rd[0]),
        )
    pass_imbalance: List[float] = [metrics.partition_balance(res.assign, k)]
    pass_wall: List[float] = [float(res.stats.get("wall_time_s", 0.0))]
    pass_score_rows: List[int] = [_score_rows(res.stats, k)]
    pass_steps: List[int] = [_steps(res.stats)]
    pass_scan_calls: List[int] = [int(res.stats.get("scan_calls", 0))]
    h2d_rows = int(res.stats.get("h2d_rows", 0))
    h2d_bytes = int(res.stats.get("h2d_bytes", 0))
    best_res, best_rd, best_pass = res, pass_rd[0], 1
    warm_wall = 0.0

    for j in range(1, passes):
        t_w = time.perf_counter()
        warm = warm_from_assignment(edges, res.assign, num_vertices, k)
        warm_wall += time.perf_counter() - t_w
        res = partition_stream(
            edges, num_vertices, cfg, n_chunks=n_chunks, warm=warm,
            allowed=allowed, residency=residency, trace=trace, device=device,
        )
        pass_rd.append(_rd(edges, res.assign, num_vertices, k))
        if tr.enabled:
            tr.add_span(
                f"pass-{j + 1}", "pass", t_w, time.perf_counter(),
                track=f"restream-pass-{j + 1}",
                attrs=dict(rd=pass_rd[-1], rd_delta=pass_rd[-2] - pass_rd[-1]),
            )
        pass_imbalance.append(metrics.partition_balance(res.assign, k))
        pass_wall.append(float(res.stats.get("wall_time_s", 0.0)))
        pass_score_rows.append(_score_rows(res.stats, k))
        pass_steps.append(_steps(res.stats))
        pass_scan_calls.append(int(res.stats.get("scan_calls", 0)))
        h2d_rows += int(res.stats.get("h2d_rows", 0))
        h2d_bytes += int(res.stats.get("h2d_bytes", 0))
        if pass_rd[-1] <= best_rd:
            best_res, best_rd, best_pass = res, pass_rd[-1], len(pass_rd)
        if eps is not None and (pass_rd[-2] - pass_rd[-1]) < eps:
            break  # diminishing returns — stop investing passes

    passes_run = len(pass_rd)
    final = best_res if keep_best else res
    score_rows = int(sum(pass_score_rows))
    stats = dict(
        final.stats,
        name="adwise-restream",
        base=base,
        passes=passes,
        passes_run=passes_run,
        # Each pass is one full read of the edge stream — the latency model
        # bills IO per read (engine/latency_model.py::partition_latency).
        stream_reads=passes_run,
        eps=eps,
        best_pass=best_pass if keep_best else passes_run,
        pass_rd=pass_rd,
        pass_imbalance=pass_imbalance,
        pass_wall_s=pass_wall,
        pass_score_rows=pass_score_rows,
        pass_steps=pass_steps,
        pass_scan_calls=pass_scan_calls,
        score_rows=score_rows,
        score_count=score_rows * k,
        h2d_rows=h2d_rows,
        h2d_bytes=h2d_bytes,
        # Pure partitioning wall: per-pass scan walls + warm-state handoff.
        wall_time_s=float(sum(pass_wall)) + warm_wall,
        unassigned=metrics.unassigned_count(final.assign),
    )
    if tr.enabled:
        # final.stats carries its own pass's snapshot; refresh so the
        # returned stats see every pass's spans.
        stats["trace_summary"] = tr.summary().as_dict()
    return PartitionResult(final.assign, stats)


def restream_partition_batched(
    streams: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    allowed: Optional[np.ndarray] = None,
    passes: int = 2,
    base: str = "adwise",
    keep_best: bool = True,
    eps: Optional[float] = None,
    seed: int = 0,
    n_chunks: int = 8,
    backend: str = "auto",
    trace=None,
    device=None,
    **adwise_cfg,
) -> List[PartitionResult]:
    """n-pass re-streaming over ``z`` batched spotlight instances.

    Every pass runs all z instance scans as one batched scan
    (:func:`repro_torch.core.adwise.partition_stream_batched`); between
    passes each instance derives its own :class:`WarmState` from its own
    sub-stream assignment. Instances never communicate (the paper's
    parallel loading model); ``keep_best`` picks each instance's best pass
    independently, while ``eps`` stops once NO instance improves its
    replication degree by >= eps (passes are batched, so all instances run
    the same pass count).

    Args mirror :func:`restream_partition` plus the batched layout of
    :func:`partition_stream_batched` (``streams[z, per, 2]``,
    ``valid[z, per]``, per-instance ``allowed[z, k]``) — except ``base``:
    only ``'adwise'`` batches; a non-adwise pass 1 runs per-instance
    baselines (``spotlight_partition(..., backend='loop')``).

    Returns one PartitionResult per instance (local stream order).
    """
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    if base != "adwise":
        raise ValueError(
            f"restream_partition_batched only batches base='adwise' (got "
            f"{base!r}): a non-adwise pass 1 runs per-instance baselines — "
            "use spotlight_partition(..., backend='loop')"
        )
    tr = resolve_tracer(trace)
    device = compat.resolve_device(device)
    cfg = AdwiseConfig(k=k, seed=seed, **adwise_cfg)
    z = int(streams.shape[0])
    valid = np.asarray(valid, bool)
    m_per = valid.sum(axis=1).astype(np.int64)
    edges_i = [streams[i, : m_per[i]] for i in range(z)]
    run = dict(allowed=allowed, backend=backend, n_chunks=n_chunks,
               residency=StreamResidency(), trace=trace, device=device)

    t0 = time.perf_counter()
    results = partition_stream_batched(streams, valid, num_vertices, cfg, **run)
    pass_rd = [[_rd(edges_i[i], results[i].assign, num_vertices, k)] for i in range(z)]
    if tr.enabled:
        tr.add_span(
            "pass-1", "pass", t0, time.perf_counter(), track="restream-pass-1",
            attrs=dict(base=base, z=z, rd_mean=float(np.mean([r[0] for r in pass_rd]))),
        )
    pass_score_rows = [[int(results[i].stats.get("score_rows", 0))] for i in range(z)]
    pass_steps = [_steps(results[0].stats)]
    pass_scan_calls = [int(results[0].stats.get("scan_calls", 0))]
    # h2d counters are run-level (one batched scan per pass).
    h2d_rows = int(results[0].stats.get("h2d_rows", 0))
    h2d_bytes = int(results[0].stats.get("h2d_bytes", 0))
    best = list(results)
    best_rd = [pass_rd[i][0] for i in range(z)]
    best_pass = [1] * z

    for j in range(1, passes):
        t_pass = time.perf_counter()
        warms = [warm_from_assignment(edges_i[i], results[i].assign, num_vertices, k)
                 for i in range(z)]
        results = partition_stream_batched(streams, valid, num_vertices, cfg, warm=warms, **run)
        h2d_rows += int(results[0].stats.get("h2d_rows", 0))
        h2d_bytes += int(results[0].stats.get("h2d_bytes", 0))
        pass_steps.append(_steps(results[0].stats))
        pass_scan_calls.append(int(results[0].stats.get("scan_calls", 0)))
        improved = 0.0
        for i in range(z):
            rd = _rd(edges_i[i], results[i].assign, num_vertices, k)
            improved = max(improved, pass_rd[i][-1] - rd)
            pass_rd[i].append(rd)
            pass_score_rows[i].append(int(results[i].stats.get("score_rows", 0)))
            if rd <= best_rd[i]:
                best[i], best_rd[i], best_pass[i] = results[i], rd, len(pass_rd[i])
        if tr.enabled:
            tr.add_span(
                f"pass-{j + 1}", "pass", t_pass, time.perf_counter(),
                track=f"restream-pass-{j + 1}",
                attrs=dict(z=z, rd_delta_max=improved,
                           rd_mean=float(np.mean([r[-1] for r in pass_rd]))),
            )
        if eps is not None and improved < eps:
            break

    passes_run = len(pass_rd[0])
    wall = time.perf_counter() - t0
    finals = best if keep_best else results
    tsum = tr.summary().as_dict() if tr.enabled else None
    out = []
    for i in range(z):
        rows = int(sum(pass_score_rows[i]))
        stats = dict(
            finals[i].stats,
            name="adwise-restream",
            passes=passes,
            passes_run=passes_run,
            stream_reads=passes_run,
            eps=eps,
            best_pass=best_pass[i] if keep_best else passes_run,
            pass_rd=pass_rd[i],
            pass_score_rows=pass_score_rows[i],
            pass_steps=pass_steps,
            pass_scan_calls=pass_scan_calls,
            score_rows=rows,
            score_count=rows * k,
            h2d_rows=h2d_rows,
            h2d_bytes=h2d_bytes,
            # All passes ran as batched scans; the accumulated batched wall
            # is shared by every instance (parallel model).
            wall_time_s=wall,
            unassigned=metrics.unassigned_count(finals[i].assign),
        )
        if tsum is not None:
            stats["trace_summary"] = tsum
        out.append(PartitionResult(finals[i].assign, stats))
    return out


# ----------------------------------------------------------------------------
# 2PS: phase-1 streaming vertex clustering
# ----------------------------------------------------------------------------


def _volume_cap(m: int, k: int, cluster_slack: float) -> int:
    """Integer volume cap. Volumes are integer degree sums, so the float cap
    ``max(cluster_slack * 2m/k, 1.0)`` gates exactly like its floor."""
    max_vol = max(cluster_slack * 2.0 * m / max(k, 1), 1.0)
    return int(min(math.floor(max_vol), np.iinfo(np.int32).max - 1))


class ClusterCarry(NamedTuple):
    cl: torch.Tensor  # (V+1,) int32 cluster per vertex, -1 = none; row V a dump
    vols: torch.Tensor  # (V+3,) int32 cluster volumes; the last row a dump
    nxt: torch.Tensor  # () int32 next cluster id
    deg: torch.Tensor  # (V+1,) int32 full-stream degrees (row V: 0)
    cursor: torch.Tensor  # () int32 next row of the current chunk
    assigned: torch.Tensor  # () int32 rows clustered in the current chunk

    clone = _clone


@dataclasses.dataclass(frozen=True)
class ClusterCore(StepCore):
    """Phase 1's per-edge clustering as an in-place step: one edge per step.

    The JAX package's ``_cluster_scan`` step: five cases (both endpoints
    new, one new, both in different clusters — the 2PS-L local move), the
    u-then-v cluster writes, and the volume updates at the old ``nxt``. The
    stream is one chunk; ``m_real`` its live rows, ``cap`` the integer
    volume cap. Rows past ``m_real`` are no-ops. The carry starts from the
    full-stream degrees (:meth:`start_carry`), so there is no cold
    ``init_carry``.
    """

    num_vertices: int

    name = "cluster"

    def start_carry(self, deg: np.ndarray, device: torch.device) -> ClusterCarry:
        n = self.num_vertices
        d = _zeros_i32(device, n + 1)
        d[:n] = torch.as_tensor(np.asarray(deg).astype(np.int32))
        return ClusterCarry(
            cl=torch.full((n + 1,), -1, dtype=torch.int32, device=device),
            vols=_zeros_i32(device, n + 3),
            nxt=_zeros_i32(device),
            deg=d,
            cursor=_zeros_i32(device),
            assigned=_zeros_i32(device),
        )

    def make_step(self, stream, m_real, allowed, cap, prev_assign):
        n = self.num_vertices
        dummy_v = n + 2  # the last row of vols
        dummy_c = n  # the dump row of cl
        # One instance: the chunk as a batch of one, its scalars as (1,).
        stream1, m_real1 = stream[None], m_real.view(1)

        def step(carry: ClusterCarry, out) -> None:
            _, lv, lvi, u, v = _edge_at(stream1, m_real1, carry.cursor.view(1), n, None)
            cl, vols, nxt = carry.cl, carry.vols, carry.nxt
            du = carry.deg.index_select(0, u)
            dv = carry.deg.index_select(0, v)
            cu = cl.index_select(0, u)
            cv = cl.index_select(0, v)
            cu_ok = cu >= 0
            cv_ok = cv >= 0
            vol_cu = vols.index_select(0, torch.where(cu_ok, cu, dummy_v))
            vol_cv = vols.index_select(0, torch.where(cv_ok, cv, dummy_v))
            selfloop = u == v
            both_new = ~cu_ok & ~cv_ok
            u_new = ~cu_ok & cv_ok
            v_new = cu_ok & ~cv_ok
            both_old = cu_ok & cv_ok & (cu != cv)

            # Case A: both unclustered — found together (cap / self-loop) or apart.
            a_join = both_new & (selfloop | (du + dv <= cap))
            a_split = both_new & ~a_join
            # Case B / C: one endpoint joins the other's cluster if it fits,
            # else founds its own.
            b_fits = u_new & (vol_cv + du <= cap)
            b_new = u_new & ~b_fits
            c_fits = v_new & (vol_cu + dv <= cap)
            c_new = v_new & ~c_fits
            # Case D: 2PS-L local move — endpoint in the lighter cluster moves.
            lighter_u = vol_cu <= vol_cv
            d_u = both_old & lighter_u & (vol_cv + du <= cap)
            d_v = both_old & ~lighter_u & (vol_cu + dv <= cap)

            wu = lv & (a_join | a_split | b_fits | b_new | d_u)
            new_cl_u = torch.where(b_fits | d_u, cv, nxt)
            wv = lv & (a_join | a_split | c_fits | c_new | d_v)
            new_cl_v = torch.where(c_fits | d_v, cu, torch.where(a_split, nxt + 1, nxt))
            # u and v in one write: the only u/v collision is the self-loop
            # join, where both write the same id (the dump row is never read).
            cl.index_put_(
                (torch.cat([torch.where(wu, u, dummy_c), torch.where(wv, v, dummy_c)]),),
                torch.cat([new_cl_u, new_cl_v]),
            )
            zero = torch.zeros_like(du)
            add_nxt = torch.where(
                a_join,
                du + torch.where(selfloop, zero, dv),
                torch.where(a_split | b_new, du, torch.where(c_new, dv, zero)),
            )
            add_nxt1 = torch.where(a_split, dv, zero)
            du_d, dv_d = torch.where(d_u, du, zero), torch.where(d_v, dv, zero)
            delta_cv = torch.where(b_fits, du, zero) + du_d - dv_d
            delta_cu = torch.where(c_fits, dv, zero) + dv_d - du_d
            vols.index_add_(
                0,
                torch.cat([
                    torch.where(lv, nxt, dummy_v),
                    torch.where(lv, nxt + 1, dummy_v),
                    torch.where(lv & cv_ok, cv, dummy_v),
                    torch.where(lv & cu_ok, cu, dummy_v),
                ]),
                torch.cat([add_nxt, add_nxt1, delta_cv, delta_cu]) * lvi,
            )
            founded = torch.where(
                a_join | b_new | c_new, 1, torch.where(a_split, 2, 0)
            ).to(torch.int32)
            nxt.view(1).add_(lvi * founded)
            carry.cursor.view(1).add_(lvi)
            carry.assigned.view(1).add_(lvi)

        return step


class VertexClusteringState:
    """Chunk-resumable phase-1 clustering on the device.

    Feed the stream through :meth:`update` in any chunking; the state after
    the final chunk equals the one-shot run exactly (integer carries, no-op
    steps past a chunk's rows). ``deg`` must be the *full-stream* degree
    table and ``num_edges`` the full stream length.
    """

    def __init__(
        self,
        num_vertices: int,
        k: int,
        num_edges: int,
        deg: np.ndarray,
        *,
        cluster_slack: float = 1.25,
        chunk_edges: Optional[int] = None,
        device=None,
    ):
        self.device = compat.resolve_device(device)
        self.num_vertices = num_vertices
        self.cap = _volume_cap(num_edges, k, cluster_slack)
        self._pad = max(int(chunk_edges or num_edges), 1)
        self._core = ClusterCore(num_vertices=num_vertices)
        self._carry = self._core.start_carry(deg, self.device)
        self._chunk = torch.zeros((self._pad, 2), dtype=torch.int32, device=self.device)
        self._rows = _zeros_i32(self.device)
        self._run = None

    def _stepper(self):
        if self._run is None:
            dev = self.device
            step = self._core.make_step(
                self._chunk, self._rows, None,
                torch.tensor(self.cap, dtype=torch.int32, device=dev), None,
            )
            out = StepOut.empty(1, 1, 1, dev)  # the step writes no output row
            if dev.type == "cuda":
                self._run = driver._GraphStepper(
                    step, self._carry, out, self._pad, driver.STEPS_PER_GRAPH)
            else:
                self._run = driver._LoopStepper(step, self._carry, out, self._pad)
        return self._run

    def update(self, edges: np.ndarray) -> None:
        c = len(edges)
        if c > self._pad:
            raise ValueError(f"chunk of {c} rows > declared chunk_edges={self._pad}")
        if c == 0:
            return
        self._chunk[:c] = torch.as_tensor(np.asarray(edges, np.int32))
        self._rows.fill_(c)
        self._carry.cursor.zero_()
        self._stepper()()

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """(cluster_id int64[V] (-1 = never streamed), volumes float64[C])."""
        carry = self._carry
        cl = carry.cl[: self.num_vertices].cpu().numpy().astype(np.int64)
        nxt = int(carry.nxt)
        vols = carry.vols[:nxt].cpu().numpy().astype(np.float64)
        return cl, vols


def streaming_vertex_clustering(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    cluster_slack: float = 1.25,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """One streaming pass of volume-capped vertex clustering (2PS-L style)
    on the device (the numpy loop is :func:`streaming_vertex_clustering_np`,
    the parity oracle).

    Cluster *volume* is the sum of member degrees; the cap
    ``cluster_slack * 2m / k`` keeps every cluster small enough to fit a
    partition. Returns (cluster_id int64[V] (-1 = never streamed), volumes
    float64[C]).
    """
    state = VertexClusteringState(
        num_vertices, k, len(edges), _degrees(edges, num_vertices),
        cluster_slack=cluster_slack, device=device,
    )
    state.update(np.asarray(edges, np.int32))
    return state.finalize()


def streaming_vertex_clustering_np(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    cluster_slack: float = 1.25,
) -> tuple[np.ndarray, np.ndarray]:
    """Reference numpy per-edge loop (parity oracle for the device step)."""
    deg = _degrees(edges, num_vertices)
    m = len(edges)
    max_vol = max(cluster_slack * 2.0 * m / max(k, 1), 1.0)
    cl = np.full(num_vertices, -1, dtype=np.int64)
    vols: List[float] = []
    for i in range(m):
        u, v = int(edges[i, 0]), int(edges[i, 1])
        cu, cv = cl[u], cl[v]
        if cu < 0 and cv < 0:
            if u == v or deg[u] + deg[v] <= max_vol:
                cl[u] = cl[v] = len(vols)
                vols.append(float(deg[u] + (deg[v] if u != v else 0)))
            else:
                cl[u] = len(vols)
                vols.append(float(deg[u]))
                cl[v] = len(vols)
                vols.append(float(deg[v]))
        elif cu < 0:
            if vols[cv] + deg[u] <= max_vol:
                cl[u] = cv
                vols[cv] += float(deg[u])
            else:
                cl[u] = len(vols)
                vols.append(float(deg[u]))
        elif cv < 0:
            if vols[cu] + deg[v] <= max_vol:
                cl[v] = cu
                vols[cu] += float(deg[v])
            else:
                cl[v] = len(vols)
                vols.append(float(deg[v]))
        elif cu != cv:
            if vols[cu] <= vols[cv]:
                x, src, dst = u, cu, cv
            else:
                x, src, dst = v, cv, cu
            if vols[dst] + deg[x] <= max_vol:
                cl[x] = dst
                vols[src] -= float(deg[x])
                vols[dst] += float(deg[x])
    return cl, np.asarray(vols, dtype=np.float64)


def _pack_clusters(vols: np.ndarray, k: int) -> np.ndarray:
    """LPT greedy: int32[C] partition per cluster, heaviest cluster first."""
    part = np.zeros(len(vols), dtype=np.int32)
    loads = np.zeros(k, dtype=np.float64)
    for c in np.argsort(vols)[::-1]:
        p = int(np.argmin(loads))
        part[c] = p
        loads[p] += vols[c]
    return part


def _phase1_warm(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    allowed: Optional[np.ndarray],
    cluster_slack: float,
    device,
) -> tuple[WarmState, int]:
    """Phase 1 shared by 2PS and 2PS-L: volume-capped streaming clustering,
    LPT packing, and the virtual-replica :class:`WarmState` for phase 2.

    ``allowed`` restricts the instance to its partition set: the volume cap
    divides by n_allowed and clusters are packed onto the allowed ids only.
    ``device=None`` clusters with the numpy oracle. Returns
    ``(warm, n_clusters)``.
    """
    allowed_np = None if allowed is None else np.asarray(allowed, bool)
    n_allowed = k if allowed_np is None else max(int(allowed_np.sum()), 1)
    deg = _degrees(edges, num_vertices)
    if device is None:
        cl, vols = streaming_vertex_clustering_np(
            edges, num_vertices, n_allowed, cluster_slack=cluster_slack)
    else:
        state = VertexClusteringState(
            num_vertices, n_allowed, len(edges), deg, cluster_slack=cluster_slack,
            device=device,
        )
        state.update(np.asarray(edges, np.int32))
        cl, vols = state.finalize()
    part_of_cluster = (
        _pack_clusters(vols, n_allowed) if len(vols) else np.zeros(0, np.int32)
    )
    if allowed_np is not None:
        part_of_cluster = np.flatnonzero(allowed_np).astype(np.int32)[part_of_cluster]
    replicas = np.zeros((num_vertices, k), dtype=bool)
    clustered = np.flatnonzero(cl >= 0)
    if len(clustered):
        replicas[clustered, part_of_cluster[cl[clustered]]] = True
    warm = WarmState(
        replicas=replicas,
        deg=deg,
        sizes=np.zeros(k, dtype=np.int64),
        prev_assign=None,
    )
    return warm, int(len(vols))


def two_phase_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    cluster_slack: float = 1.25,
    seed: int = 0,
    n_chunks: int = 8,
    allowed: Optional[np.ndarray] = None,
    trace=None,
    device=None,
    **adwise_cfg,
) -> PartitionResult:
    """2PS: streaming vertex clustering, then cluster-aware edge scoring.

    Phase 2 runs the ADWISE scan warm-started with virtual replicas — each
    clustered vertex starts replicated on its cluster's partition — so the
    Eq. 5 replication term *is* the cluster-affinity score, and λ·B plus the
    capacity cap keep the result balanced. ``trace`` threads through to the
    phase-2 scan driver.
    """
    device = compat.resolve_device(device)
    adwise_cfg.setdefault("window_max", 32)
    adwise_cfg.setdefault("window_init", max(1, min(8, adwise_cfg["window_max"])))
    cfg = AdwiseConfig(k=k, seed=seed, **adwise_cfg)
    t0 = time.perf_counter()
    warm, n_clusters = _phase1_warm(edges, num_vertices, k, allowed, cluster_slack, device)
    t_phase1 = time.perf_counter() - t0
    res = partition_stream(
        edges, num_vertices, cfg, n_chunks=n_chunks, warm=warm, allowed=allowed,
        trace=trace, device=device,
    )
    stats = dict(
        res.stats,
        name="2ps",
        n_clusters=n_clusters,
        cluster_slack=cluster_slack,
        phase1_wall_s=t_phase1,
        # Clustering pass + scoring pass — two full stream reads, billed by
        # the latency model's IO term.
        stream_reads=2,
        wall_time_s=time.perf_counter() - t0,
        unassigned=metrics.unassigned_count(res.assign),
    )
    return PartitionResult(res.assign, stats)


# ----------------------------------------------------------------------------
# 2PS-L: linear-time phase 2 as its own step-core
# ----------------------------------------------------------------------------


class TpslCarry(NamedTuple):
    vp: torch.Tensor  # (V+1,) int32 — partition of each vertex's cluster, -1 none
    deg: torch.Tensor  # (V+1,) int32 — full-stream degrees, clamped
    sizes: torch.Tensor  # (K,) int32
    cursor: torch.Tensor  # () int32
    assigned: torch.Tensor  # () int32

    clone = _clone


class TpslState:
    """2PS-L phase 2 as a per-edge numpy loop (parity oracle for
    :class:`TpslCore`).

    Each edge is scored ONCE per partition: the HDRF degree-weighted
    replication term rewards the two endpoints' cluster partitions (``vp``),
    the quantized balance term and a hard capacity cap keep loads even.
    Partitions at the cap are ineligible, so the argmax degenerates to
    least-loaded when no cluster partition is open. Deterministic: no tie
    noise, first-occurrence argmax.
    """

    def __init__(
        self,
        num_vertices: int,
        k: int,
        vp: np.ndarray,
        deg: np.ndarray,
        *,
        lam: float = 1.1,
        eps: float = 1.0,
        cap: Optional[int] = None,
        allowed: Optional[np.ndarray] = None,
    ):
        self.k = k
        self.lam_q = _lam_q(lam)
        self.eps_q = _eps_q(eps)
        self.vp = np.asarray(vp, np.int64)
        self.deg = np.asarray(deg, np.int64)
        self.sizes = np.zeros(k, dtype=np.int64)
        self.cap = int(cap) if cap is not None else int(np.iinfo(np.int32).max)
        self.allowed = (
            np.ones(k, bool) if allowed is None else np.asarray(allowed, bool)
        )
        assert self.allowed.shape == (k,) and self.allowed.any()
        self.edges_seen = 0

    def assign_chunk(self, edges: np.ndarray) -> np.ndarray:
        k, lam_q, eps_q = self.k, self.lam_q, self.eps_q
        vp, deg, sizes, allowed = self.vp, self.deg, self.sizes, self.allowed
        aidx = np.flatnonzero(allowed)
        arange = np.arange(k)
        c = len(edges)
        assign = np.empty(c, dtype=np.int32)
        for i in range(c):
            u, v = int(edges[i, 0]), int(edges[i, 1])
            du = min(int(deg[u]), _DEG_CLAMP)
            dv = min(int(deg[v]), _DEG_CLAMP)
            a = max(du + dv, 1)
            tq_u = ((2 * a - du) * QB) // a
            tq_v = ((2 * a - dv) * QB) // a
            sal = sizes[aidx]
            mx, mn = int(sal.max()), int(sal.min())
            gap = np.clip(mx - sizes, 0, _DEG_CLAMP)
            bal_q = (gap * QB) // (eps_q + min(mx - mn, _DEG_CLAMP))
            rep_q = (arange == vp[u]) * tq_u + (arange == vp[v]) * tq_v
            score_q = QB * rep_q.astype(np.int64) + lam_q * bal_q
            eligible = allowed & (sizes < self.cap)
            combined = np.where(eligible, score_q, -1)
            p = int(np.argmax(combined))
            assign[i] = p
            sizes[p] += 1
        self.edges_seen += c
        return assign


@dataclasses.dataclass(frozen=True)
class TpslCore(StepCore):
    """2PS-L phase 2 as a chunk-resumable step-core: one edge per scan step.

    Bit-identical to :class:`TpslState`. Cold start is a contract error —
    phase 2 resumes from the phase-1 WarmState, whose virtual replicas
    ``warm_carry`` collapses to the per-vertex ``vp``. The capacity cap
    ``ceil(cap_slack·m/n_allowed)+1`` guarantees an eligible partition
    always exists (pigeonhole), so the scan can never strand an edge.
    """

    num_vertices: int
    k: int
    lam: float = 1.1
    eps: float = 1.0
    cap_slack: float = 1.15

    name = "2ps-l"

    def cap_value(self, m: int, n_allowed: int) -> int:
        return int(math.ceil(self.cap_slack * m / max(n_allowed, 1))) + 1

    def init_carry(self, budget: float, device: torch.device) -> TpslCarry:
        raise ValueError(
            "2ps-l phase 2 always resumes from a phase-1 WarmState — "
            "run the clustering pass and pass warm="
        )

    def warm_carry(self, budget: float, warm: WarmState, device: torch.device) -> TpslCarry:
        v = self.num_vertices
        rep = np.asarray(warm.replicas, bool)
        vp = np.full((v + 1,), -1, np.int32)
        vp[:v] = np.where(rep.any(axis=1), rep.argmax(axis=1), -1)
        deg = np.zeros((v + 1,), np.int32)
        deg[:v] = np.minimum(np.asarray(warm.deg), _DEG_CLAMP)
        return TpslCarry(
            vp=torch.as_tensor(vp, device=device),
            deg=torch.as_tensor(deg, device=device),
            sizes=torch.as_tensor(np.asarray(warm.sizes).astype(np.int32), device=device),
            cursor=_zeros_i32(device),
            assigned=_zeros_i32(device),
        )

    def make_step(self, stream, m_real, allowed, cap, prev_assign):
        v_dummy, k = self.num_vertices, self.k
        v1 = v_dummy + 1
        lam_q, eps_q = _lam_q(self.lam), _eps_q(self.eps)
        parts = torch.arange(k, dtype=torch.int32, device=stream.device)
        z, dev = stream.shape[0], stream.device
        s_off, v_off, k_off = (instance_offsets(z, n, dev) for n in (stream.shape[1], v1, k))

        def step(carry: TpslCarry, out) -> None:
            cur, live, live_i, u, v = _edge_at(stream, m_real, carry.cursor, v_dummy, s_off)
            ug, vg = at_rows(u, v_off), at_rows(v, v_off)
            deg, vp = carry.deg.view(-1), carry.vp.view(-1)
            # Degrees were clamped when the carry was built.
            tq_u, tq_v = _theta_q(deg.index_select(0, ug), deg.index_select(0, vg))
            rep_q = ((parts == vp.index_select(0, ug)[:, None]) * tq_u[:, None]
                     + (parts == vp.index_select(0, vg)[:, None]) * tq_v[:, None])
            sizes = carry.sizes
            score_q = QB * rep_q + lam_q * _balance_q(sizes, allowed, eps_q)
            eligible = allowed & (sizes < cap[:, None])
            p = torch.where(eligible, score_q, -1).argmax(1).to(torch.int32)
            sizes.view(-1).index_add_(0, at_rows(p, k_off), live_i)
            _emit(out, cur, live, live_i, p, carry)

        return step


def two_phase_linear_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    cluster_slack: float = 1.25,
    lam: float = 1.1,
    eps: float = 1.0,
    cap_slack: float = 1.15,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
    scan: bool = True,
    backend: str = "vmap",
    n_chunks: int = 8,
    trace=None,
    device=None,
) -> PartitionResult:
    """2PS-L: streaming clustering, then the linear-time scoring pass.

    ``scan=True`` (default) runs phase 2 as the :class:`TpslCore` step-core
    through the scan driver (``trace`` threads through to it);
    ``scan=False`` runs the :class:`TpslState` numpy oracle after the numpy
    clustering oracle — bit-identical by construction. ``seed`` is accepted
    for registry uniformity; 2PS-L is deterministic (no tie noise).
    """
    resolve_backend(backend, 1)
    device = compat.resolve_device(device)
    m = len(edges)
    if m == 0:
        return PartitionResult(
            np.zeros((0,), np.int32),
            dict(k=k, name="2ps-l", n_clusters=0, stream_reads=2,
                 wall_time_s=0.0, unassigned=0),
        )
    t0 = time.perf_counter()
    core = TpslCore(
        num_vertices=int(num_vertices), k=int(k), lam=float(lam),
        eps=float(eps), cap_slack=float(cap_slack),
    )
    warm, n_clusters = _phase1_warm(
        edges, num_vertices, k, allowed, cluster_slack, device if scan else None
    )
    t_phase1 = time.perf_counter() - t0
    if scan:
        res = _scan_partition(
            core, edges, allowed=allowed, warm=warm, backend=backend,
            n_chunks=n_chunks, trace=trace, device=device,
        )
        assign, stats = res.assign, dict(res.stats)
    else:
        n_allowed = k if allowed is None else max(int(np.asarray(allowed, bool).sum()), 1)
        rep = warm.replicas
        vp = np.where(rep.any(axis=1), rep.argmax(axis=1), -1)
        state = TpslState(
            num_vertices, k, vp, warm.deg, lam=lam, eps=eps,
            cap=core.cap_value(m, n_allowed), allowed=allowed,
        )
        assign = state.assign_chunk(np.asarray(edges))
        stats = dict(score_rows=m, score_count=m * k)
    stats.update(
        k=k,
        name="2ps-l",
        n_clusters=n_clusters,
        cluster_slack=cluster_slack,
        phase1_wall_s=t_phase1,
        # Clustering pass + scoring pass, same IO billing as 2ps.
        stream_reads=2,
        wall_time_s=time.perf_counter() - t0,
        unassigned=int((np.asarray(assign) < 0).sum()),
    )
    return PartitionResult(np.asarray(assign, np.int32), stats)


def two_phase_partition_batched(
    streams: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    variant: str = "2ps",
    allowed: Optional[np.ndarray] = None,
    cluster_slack: float = 1.25,
    seed: int = 0,
    n_chunks: int = 8,
    backend: str = "auto",
    lam: float = 1.1,
    eps: float = 1.0,
    cap_slack: float = 1.15,
    trace=None,
    device=None,
    **adwise_cfg,
) -> List[PartitionResult]:
    """2PS / 2PS-L over ``z`` batched spotlight instances.

    Phase 1 runs per instance (each instance clusters its own sub-stream
    against its own ``allowed`` partition budget, through
    :class:`VertexClusteringState` at z = 1); phase 2 runs ALL z instances
    as one batched scan — the ADWISE scan for ``variant='2ps'``
    (``adwise_cfg`` keys apply, window_max defaults to 32) or the
    :class:`TpslCore` step-core for ``variant='2ps-l'`` (which takes
    ``lam``/``eps``/``cap_slack`` instead). Bit-identical per instance to
    the sequential :func:`two_phase_partition` /
    :func:`two_phase_linear_partition` calls.
    """
    if variant not in ("2ps", "2ps-l"):
        raise ValueError(f"unknown two-phase variant {variant!r}")
    device = compat.resolve_device(device)
    z = int(streams.shape[0])
    valid = np.asarray(valid, bool)
    m_per = valid.sum(axis=1).astype(np.int64)
    t0 = time.perf_counter()
    warms, n_clusters = [], []
    for i in range(z):
        a_i = None if allowed is None else np.asarray(allowed[i], bool)
        w, nc = _phase1_warm(streams[i, : m_per[i]], num_vertices, k, a_i,
                             cluster_slack, device)
        warms.append(w)
        n_clusters.append(nc)
    t_phase1 = time.perf_counter() - t0
    run = dict(allowed=allowed, warm=warms, backend=backend, n_chunks=n_chunks,
               trace=trace, device=device)
    if variant == "2ps":
        adwise_cfg.setdefault("window_max", 32)
        adwise_cfg.setdefault("window_init", max(1, min(8, adwise_cfg["window_max"])))
        cfg = AdwiseConfig(k=k, seed=seed, **adwise_cfg)
        results = partition_stream_batched(streams, valid, num_vertices, cfg, **run)
    else:
        if adwise_cfg:
            raise TypeError(f"2ps-l: unknown config keys {sorted(adwise_cfg)}")
        core = TpslCore(
            num_vertices=int(num_vertices), k=int(k), lam=float(lam),
            eps=float(eps), cap_slack=float(cap_slack),
        )
        results = partition_stream_batched(
            streams, valid, num_vertices, None, core=core, **run)
    wall = time.perf_counter() - t0
    out = []
    for i, res in enumerate(results):
        stats = dict(
            res.stats,
            name=variant,
            n_clusters=n_clusters[i],
            cluster_slack=cluster_slack,
            phase1_wall_s=t_phase1,
            stream_reads=2,
            # Phase 2 ran as one batched scan; the shared wall covers every
            # instance (parallel loading model).
            wall_time_s=wall,
            unassigned=metrics.unassigned_count(res.assign),
        )
        out.append(PartitionResult(res.assign, stats))
    return out


# ----------------------------------------------------------------------------
# Registry entries
# ----------------------------------------------------------------------------

_ADWISE_FIELDS = {f.name for f in dataclasses.fields(AdwiseConfig)} - {"k", "seed"}


def _check_cfg(name: str, cfg: dict, extra: frozenset) -> None:
    unknown = set(cfg) - _ADWISE_FIELDS - set(extra)
    if unknown:
        raise TypeError(f"{name}: unknown config keys {sorted(unknown)}")


@registry.register("adwise-restream")
def _adwise_restream(
    edges, num_vertices, k, seed=0, *, device=None, passes=2, base="adwise",
    keep_best=True, eps=None, allowed=None, **cfg,
) -> PartitionResult:
    """n-pass restreamed ADWISE. cfg keys = AdwiseConfig fields plus
    ``passes=`` / ``base=`` / ``keep_best=`` / ``eps=`` (early-stop on RD
    improvement; stats report ``passes_run``) / ``allowed=`` (partition
    mask) / ``n_chunks=`` (see restream_partition)."""
    _check_cfg("adwise-restream", cfg, frozenset({"n_chunks"}))
    return restream_partition(
        edges, num_vertices, k, passes=passes, base=base,
        keep_best=keep_best, eps=eps, seed=seed, allowed=allowed, device=device,
        **cfg,
    )


@registry.register("2ps")
def _two_ps(
    edges, num_vertices, k, seed=0, *, device=None, cluster_slack=1.25,
    allowed=None, **cfg,
) -> PartitionResult:
    """2PS two-phase partitioner. cfg keys = AdwiseConfig fields (phase 2;
    window_max defaults to 32) plus ``cluster_slack=`` (phase-1 volume cap),
    ``allowed=`` (partition mask), and ``n_chunks=``."""
    _check_cfg("2ps", cfg, frozenset({"n_chunks"}))
    return two_phase_partition(
        edges, num_vertices, k, cluster_slack=cluster_slack, seed=seed,
        allowed=allowed, device=device, **cfg,
    )


@registry.register("2ps-l")
def _two_ps_l(
    edges, num_vertices, k, seed=0, *, device=None, cluster_slack=1.25, lam=1.1,
    eps=1.0, cap_slack=1.15, allowed=None, scan=True, backend="vmap", n_chunks=8,
) -> PartitionResult:
    """2PS-L linear-run-time two-phase partitioner (arXiv:2203.12721).
    Shares phase 1 with 2ps; phase 2 is the single-score cluster-affinity
    pass (no window, no tie noise). cfg keys: ``cluster_slack=``,
    ``lam=``/``eps=``, ``cap_slack=``, ``allowed=``, ``scan=`` (False runs
    the numpy parity oracles of both phases), ``backend=``, ``n_chunks=``."""
    return two_phase_linear_partition(
        edges, num_vertices, k, cluster_slack=cluster_slack, lam=lam,
        eps=eps, cap_slack=cap_slack, seed=seed, allowed=allowed,
        scan=scan, backend=backend, n_chunks=n_chunks, device=device,
    )
