"""Out-of-core partitioning driver: any registry strategy over a file reader.

Port of the JAX package's ``core/oocore.py``; ``device=`` (default
``cuda``) picks where the ring and the scan live.

`partition_file` runs a registry strategy — adwise / adwise-restream / 2ps /
hdrf / dbh / greedy / hash / grid, with or without a z>1 spotlight spread —
over an :class:`repro_torch.graph.io.format.EdgeFileReader` while keeping resident
*edge* memory bounded by the chunk size. Assignments are written to a spill
memmap as they are produced; multi-pass re-streaming re-reads the stream from
disk each pass and reads the prior pass's placements back from its spill
(never holding a resident edge array). Output is **bit-identical** to the
in-memory path for every strategy:

* Every scan-core strategy — ADWISE, HDRF, Greedy, and 2PS(-L) phase 2 —
  runs through ONE code path: :class:`repro_torch.core.driver.ScanDriver`
  over a :class:`repro_torch.core.driver.FileSource` — a **device-resident
  ring buffer**: logical stream row ``s`` lives in ring slot ``s % B`` on
  the device, each refill copies only the new tail rows into the ring in
  place, and the scan step is the very step the in-memory path runs
  (``s % m`` is the identity there). Per scan call of
  ``S`` steps the cursor advances at most
  ``window_rows + S * rows_per_step`` rows (ADWISE:
  ``window_max + S * assign_batch``; the single-edge cores ``0 + S``),
  which bounds the refill — host→device traffic is O(refill) per call, not
  O(B), and is reported as ``h2d_rows`` / ``h2d_bytes`` in stats (billed by
  the latency model).
* The z>1 spotlight path batches per-instance ring buffers over
  per-instance sub-readers (`EdgeFileReader.split` — the same ceil(m/z)
  ``split_bounds`` byte ranges `EdgeStream` uses) through the same driver:
  every instance runs at GLOBAL k restricted by its ``allowed`` spread
  mask, exactly mirroring `spotlight_partition`'s batched backend (HDRF
  instances derive their tie-noise streams from ``seed + i`` inside the
  batched carry). Only the stateless hashes (hash/dbh) run a per-instance
  chunked loop — the same vectorized assignment either way.
* DBH takes a chunked degree pass then a chunked placement pass; Hash /
  Grid are stateless. The chunk-resumable numpy states
  (`repro_torch.core.baselines.HdrfState` / ``GreedyState``) survive as the
  base-pass path for non-adwise re-streaming.
* 2PS / 2PS-L take a chunked degree pass, stream phase 1 through the
  chunk-resumable clustering step
  (:class:`repro_torch.core.restream.VertexClusteringState`), and run
  phase 2 through the warm-started ring scan (the ADWISE scan for 2ps, the
  :class:`repro_torch.core.restream.TpslCore` step-core for 2ps-l).

Stats report the *measured* IO: ``io_wall_s`` (seconds inside ``read``),
``rows_read`` and ``stream_reads`` (measured full passes over the stream),
so `repro_torch.engine.latency_model.partition_latency` bills real IO instead of
an assumed single pass.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import compat
from repro_torch.core import baselines
from repro_torch.core.driver import FileSource, RingHandle, ScanDriver, resolve_backend
from repro_torch.core.restream import TpslCore, VertexClusteringState, _pack_clusters
from repro_torch.core.spotlight import _SPOTLIGHT_INCOMPATIBLE, spread_mask
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.graph import metrics
from repro_torch.graph.stream import EdgeStream
from repro_torch import dist as rdist
from repro_torch.obs import resolve_tracer

__all__ = ["partition_file"]

_ADWISE_FIELDS = {f.name for f in dataclasses.fields(AdwiseConfig)} - {"k", "seed"}


# ----------------------------------------------------------------------------
# Assignment spill (disk-backed int32[m], -1 = unassigned)
# ----------------------------------------------------------------------------


class _Spill:
    """int32[m] assignment spill memmap; resident set is page cache, not heap.

    With several ranks (one host), rank 0 creates the file and fills it
    with -1, and the others map it after a barrier: every rank writes the
    rows its drive owns into the one file (:func:`_owns_rows`) and, after a
    barrier, reads every row."""

    def __init__(self, path: str, m: int):
        self.path = path
        self.m = m
        shape = (max(m, 1),)
        if rdist.rank() == 0:
            self._map = np.memmap(path, dtype=np.int32, mode="w+", shape=shape)
            self._map[:] = -1
        if rdist.world_size() > 1:
            if rdist.rank() == 0:
                self._map.flush()
            rdist.barrier()
            if rdist.rank() != 0:
                self._map = np.memmap(path, dtype=np.int32, mode="r+", shape=shape)

    def write(self, idx: np.ndarray, vals: np.ndarray) -> None:
        self._map[idx] = vals

    def write_range(self, start: int, vals: np.ndarray) -> None:
        self._map[start : start + len(vals)] = vals

    def read(self, start: int, count: int) -> np.ndarray:
        return np.asarray(self._map[start : start + count])

    def flush_readonly(self) -> np.memmap:
        self._map.flush()
        return np.memmap(self.path, dtype=np.int32, mode="r", shape=(max(self.m, 1),))[
            : self.m
        ]

    def remove(self) -> None:
        """Drop the mapping and delete the backing file (dead pass spills;
        rank 0 deletes it)."""
        self._map = None
        if rdist.rank() != 0:
            return
        try:
            os.remove(self.path)
        except OSError:
            pass


def _owns_rows(backend: str, z: int) -> bool:
    """Whether this rank writes the spill rows of a drive over z instances:
    each rank writes its own instances' rows when the batch is sharded over
    ranks (``on_assign`` hands it only those), else rank 0 writes them all
    (every rank computes the same rows). Always true with a world of 1."""
    if rdist.rank() == 0:
        return True
    return backend in ("auto", "shard_map") and resolve_backend(backend, z)[1] > 1


# ----------------------------------------------------------------------------
# Chunked accumulation helpers (vertex-sized state, O(chunk) edge memory)
# ----------------------------------------------------------------------------


def _chunked_degrees(reader, num_vertices: int, chunk_edges: int) -> np.ndarray:
    deg = np.zeros(num_vertices, dtype=np.int64)
    for chunk in reader.chunks(chunk_edges):
        deg += np.bincount(chunk[:, 0], minlength=num_vertices)
        deg += np.bincount(chunk[:, 1], minlength=num_vertices)
    return deg


def _pairs(reader, spill: _Spill, offset: int, chunk_edges: int):
    """Yield (edges_chunk, assign_chunk) over a sub-reader + its spill range."""
    start = 0
    for chunk in reader.chunks(chunk_edges):
        yield chunk, spill.read(offset + start, len(chunk))
        start += len(chunk)


class _PassMetrics:
    """Replica table + sizes + quality of one completed pass, accumulated in
    a SINGLE chunked read of (stream, spill) — the table feeds both the pass
    quality stats and the next pass's warm start, so re-streaming pays one
    metric read per pass, not two (`warm_from_assignment` parity: the spill
    is complete, so drop/raise policies coincide)."""

    def __init__(self, reader, spill: _Spill, offset: int, num_vertices: int,
                 k: int, chunk_edges: int):
        q = metrics.quality_from_chunks(
            _pairs(reader, spill, offset, chunk_edges), num_vertices, k
        )
        self.rep = q["replicas"]
        self.sizes = q["sizes"]
        self.rd = q["replication_degree"]
        self.imbalance = q["imbalance"]

    def warm(self, deg: np.ndarray) -> WarmState:
        return WarmState(replicas=self.rep, deg=deg, sizes=self.sizes,
                         prev_assign=None)


# ----------------------------------------------------------------------------
# The ring-buffer scan driver (z >= 1 batched, warm-chunk path, any core)
# ----------------------------------------------------------------------------


def _drive_core(
    readers: Sequence,
    num_vertices: int,
    core,  # a StepCore, or an AdwiseConfig (wrapped by the driver)
    *,
    write_assign: Callable[[int, np.ndarray, np.ndarray], None],
    chunk_edges: int,
    allowed: Optional[np.ndarray] = None,  # (z, k) bool
    warm: Optional[List[WarmState]] = None,
    prev_read: Optional[List[Callable[[int, int], np.ndarray]]] = None,
    backend: str = "auto",
    prefetch: Optional[int] = None,
    resume: Optional[RingHandle] = None,
    trace=None,
    device=None,
) -> tuple[List[dict], Optional[RingHandle]]:
    """Feed z instance streams through any step-core's scan in a bounded
    device-resident ring buffer — a thin caller of
    :class:`repro_torch.core.driver.ScanDriver` over a
    :class:`~repro_torch.core.driver.FileSource`.

    ``readers[i]`` is instance i's (locally addressed) stream;
    ``write_assign(i, local_idx, p)`` receives finished placements.
    ``prev_read[i](start, count)`` supplies the prior pass's placements for
    buffered re-streaming revocation; ``resume`` adopts the previous pass's
    ring under the cross-pass shared-buffer contract. Returns per-instance
    stats dicts plus this pass's :class:`RingHandle` for the next one.
    """
    z = len(readers)
    m_per = np.array([r.num_edges for r in readers], dtype=np.int64)
    m_max = int(m_per.max()) if z else 0
    if m_max == 0:
        return [dict(k=core.k, score_rows=0, assigned=0, unassigned=0)
                for _ in range(z)], None

    is_cfg = isinstance(core, AdwiseConfig)
    source = FileSource(
        readers, chunk_edges=chunk_edges,
        cfg=core if is_cfg else None, core=None if is_cfg else core,
        prev_read=prev_read, prefetch=prefetch, resume=resume, trace=trace,
    )
    drv = ScanDriver(source, core, num_vertices, allowed=allowed, warm=warm,
                     backend=backend, trace=trace, device=device)
    res = drv.run(on_assign=write_assign)
    stats = []
    for i in range(z):
        if int(res.assigned[i]) != int(m_per[i]):
            raise RuntimeError(
                f"instance {i}: {int(res.assigned[i])} of {int(m_per[i])} assigned")
        stats.append(
            dict(
                drv.stats_base(res, i),
                batched=True,
                backend=res.backend,
                n_shards=res.n_shards,
                z=z,
                instance=i,
                unassigned=0,
            )
        )
    return stats, drv.ring_handle


# ----------------------------------------------------------------------------
# Chunk-resumable baselines / 2PS over a (sub-)reader
# ----------------------------------------------------------------------------


def _run_baseline_chunks(
    strategy: str,
    reader,
    num_vertices: int,
    k: int,
    seed: int,
    chunk_edges: int,
    write_range: Callable[[int, np.ndarray], None],
    trace=None,
    **cfg,
) -> dict:
    """Stream a single-edge baseline over reader chunks (state resumes)."""
    allowed_cfg = {"hdrf": {"lam", "eps"}}.get(strategy, set())
    unknown = set(cfg) - allowed_cfg
    if unknown:
        raise TypeError(f"{strategy}: unknown config keys {sorted(unknown)}")
    m = reader.num_edges
    t0 = time.perf_counter()
    reads = 1
    if strategy == "hash":
        off = 0
        for chunk in reader.chunks(chunk_edges):
            write_range(off, baselines.hash_assign(chunk, num_vertices, k, seed=seed))
            off += len(chunk)
        stats = dict(name="hash")
    elif strategy == "grid":
        off = 0
        for chunk in reader.chunks(chunk_edges):
            write_range(off, baselines.grid_assign(chunk, k, seed=seed))
            off += len(chunk)
        stats = dict(name="grid")
    elif strategy == "dbh":
        deg = _chunked_degrees(reader, num_vertices, chunk_edges)
        off = 0
        for chunk in reader.chunks(chunk_edges):
            write_range(off, baselines.dbh_assign(chunk, deg, k, seed=seed))
            off += len(chunk)
        reads = 2
        stats = dict(name="dbh")
    elif strategy == "hdrf":
        state = baselines.HdrfState(num_vertices, k, seed=seed, **cfg)
        off = 0
        for chunk in reader.chunks(chunk_edges):
            write_range(off, state.assign_chunk(chunk))
            off += len(chunk)
        stats = dict(name="hdrf", score_count=m * k)
    elif strategy == "greedy":
        state = baselines.GreedyState(num_vertices, k)
        off = 0
        for chunk in reader.chunks(chunk_edges):
            write_range(off, state.assign_chunk(chunk))
            off += len(chunk)
        stats = dict(name="greedy")
    else:
        raise KeyError(f"no chunk-resumable core for strategy {strategy!r}")
    stats.update(k=k, wall_time_s=time.perf_counter() - t0, stream_reads=reads)
    tr = resolve_tracer(trace)
    if tr.enabled:
        tr.add_span(
            f"baseline:{strategy}", "phase", t0, time.perf_counter(),
            attrs=dict(strategy=strategy, k=k, stream_reads=reads),
        )
    return stats


def _run_two_phase_chunks(
    readers: Sequence,
    num_vertices: int,
    k: int,
    seed: int,
    chunk_edges: int,
    write_assign: Callable[[int, np.ndarray, np.ndarray], None],
    *,
    variant: str = "2ps",
    allowed: Optional[np.ndarray] = None,  # (z, k) bool
    backend: str = "auto",
    prefetch: Optional[int] = None,
    cluster_slack: float = 1.25,
    trace=None,
    device=None,
    **cfg,
) -> List[dict]:
    """2PS / 2PS-L over z per-instance readers: chunked degree pass →
    chunk-resumable clustering → LPT packing onto each instance's allowed
    partitions → warm-started ring-buffer phase 2 (the ADWISE scan for 2ps,
    the :class:`TpslCore` step-core for 2ps-l). The per-instance phase 1 is
    bit-identical to :func:`repro_torch.core.restream._phase1_warm` on the
    resident sub-stream."""
    z = len(readers)
    tr = resolve_tracer(trace)
    t0 = time.perf_counter()
    warms, n_clusters = [], []
    for i in range(z):
        a_i = None if allowed is None else np.asarray(allowed[i], bool)
        n_allowed = k if a_i is None else max(int(a_i.sum()), 1)
        with tr.span("degree-pass", cat="phase", instance=i):
            deg = _chunked_degrees(readers[i], num_vertices, chunk_edges)
        state = VertexClusteringState(
            num_vertices, n_allowed, readers[i].num_edges, deg,
            cluster_slack=cluster_slack, chunk_edges=chunk_edges, device=device,
        )
        with tr.span("clustering", cat="phase", instance=i):
            for chunk in readers[i].chunks(chunk_edges):
                state.update(chunk)
            cl, vols = state.finalize()
        part = (
            _pack_clusters(vols, n_allowed) if len(vols)
            else np.zeros(0, np.int32)
        )
        if a_i is not None:
            part = np.flatnonzero(a_i).astype(np.int32)[part]
        replicas = np.zeros((num_vertices, k), dtype=bool)
        clustered = np.flatnonzero(cl >= 0)
        if len(clustered):
            replicas[clustered, part[cl[clustered]]] = True
        warms.append(WarmState(
            replicas=replicas, deg=deg, sizes=np.zeros(k, dtype=np.int64),
            prev_assign=None,
        ))
        n_clusters.append(int(len(vols)))
    t_phase1 = time.perf_counter() - t0
    if tr.enabled:
        # Same endpoints that define phase1_wall_s in the returned stats.
        tr.add_span(
            "phase1", "phase", t0, t0 + t_phase1,
            attrs=dict(variant=variant, z=z, n_clusters=sum(n_clusters)),
        )

    if variant == "2ps":
        cfg.setdefault("window_max", 32)
        cfg.setdefault("window_init", max(1, min(8, cfg["window_max"])))
        core = AdwiseConfig(k=k, seed=seed, **cfg)
    else:
        core = TpslCore(
            num_vertices=int(num_vertices), k=int(k),
            lam=float(cfg.pop("lam", 1.1)), eps=float(cfg.pop("eps", 1.0)),
            cap_slack=float(cfg.pop("cap_slack", 1.15)),
        )
        if cfg:  # partition_file validated the keys
            raise TypeError(f"2ps-l: unknown config keys {sorted(cfg)}")
    with tr.span("phase2", cat="phase", variant=variant):
        per_stats, _ = _drive_core(
            readers, num_vertices, core, write_assign=write_assign,
            chunk_edges=chunk_edges, allowed=allowed, warm=warms,
            backend=backend, prefetch=prefetch, trace=trace, device=device,
        )
    wall = time.perf_counter() - t0
    return [
        dict(
            st,
            name=variant,
            n_clusters=n_clusters[i],
            cluster_slack=cluster_slack,
            phase1_wall_s=t_phase1,
            # Degree pass + clustering pass + scoring pass: three measured
            # reads of the file (the in-memory path folds degree counting
            # into its resident array and bills 2).
            stream_reads=3,
            wall_time_s=wall,
        )
        for i, st in enumerate(per_stats)
    ]


# ----------------------------------------------------------------------------
# Multi-pass re-streaming from disk
# ----------------------------------------------------------------------------


def _run_restream_chunks(
    readers: Sequence,
    num_vertices: int,
    k: int,
    seed: int,
    chunk_edges: int,
    spill_dir: str,
    m_total: int,
    offsets: np.ndarray,  # (z,) global start row per instance
    final_spill: _Spill,
    *,
    allowed: Optional[np.ndarray] = None,
    passes: int = 2,
    base: str = "adwise",
    keep_best: bool = True,
    eps: Optional[float] = None,
    backend: str = "auto",
    prefetch: Optional[int] = None,
    trace=None,
    device=None,
    **adwise_cfg,
) -> dict:
    """n-pass re-streaming where every pass re-reads the stream from disk and
    the prior pass's placements from its spill (WarmState.prev_assign becomes
    a spill-backed range read instead of a resident array). Consecutive
    passes share the device ring through the driver's :class:`RingHandle`:
    when the geometry lets a stream sit in the ring without wrapping, pass
    j+1 ships only the 4 B/row prev placements."""
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    z = len(readers)
    tr = resolve_tracer(trace)
    cfg = AdwiseConfig(k=k, seed=seed, **adwise_cfg)
    m_per = np.array([r.num_edges for r in readers], dtype=np.int64)
    spills: List[_Spill] = []

    def new_spill(j: int) -> _Spill:
        s = _Spill(os.path.join(spill_dir, f"restream.pass{j}.i32"), m_total)
        spills.append(s)
        return s

    t0 = time.perf_counter()
    spill = new_spill(0)
    handle: Optional[RingHandle] = None
    own = _owns_rows(backend, z) if base == "adwise" else rdist.rank() == 0

    def writer(sp: _Spill) -> Callable[[int, np.ndarray, np.ndarray], None]:
        def write(i, idx, p):
            if own:
                sp.write(offsets[i] + idx, p)
        return write

    if base == "adwise":
        pass_stats, handle = _drive_core(
            readers, num_vertices, cfg,
            write_assign=writer(spill),
            chunk_edges=chunk_edges, allowed=allowed, backend=backend,
            prefetch=prefetch, trace=trace, device=device,
        )
    else:
        if z > 1:
            raise ValueError(
                "file-driven restream only batches base='adwise' under a "
                f"z>1 spotlight (got base={base!r}); run z=1 or base='adwise'"
            )
        st = _run_baseline_chunks(
            base, readers[0], num_vertices, k, seed, chunk_edges,
            lambda off, a: spill.write_range(int(offsets[0]) + off, a) if own else None,
            trace=trace,
        )
        pass_stats = [st]
    rdist.barrier()  # every rank's rows are in the spill before any reads it

    def metrics_of(j_spill: _Spill) -> List[_PassMetrics]:
        # One fused read per instance: quality stats AND the next pass's
        # warm tables come out of the same chunked accumulation.
        with tr.span("metrics", cat="phase", z=z):
            return [
                _PassMetrics(readers[i], j_spill, int(offsets[i]),
                             num_vertices, k, chunk_edges)
                for i in range(z)
            ]

    def score_rows_of(stats_list) -> List[int]:
        return [
            int(s.get("score_rows", s.get("score_count", 0) // max(k, 1)))
            for s in stats_list
        ]

    def h2d_of(stats_list) -> tuple[int, int, int]:
        # The driver's h2d counters are run-level (shared by every
        # instance); pass-level totals accumulate over passes.
        s0 = stats_list[0] if stats_list else {}
        return (s0.get("h2d_rows", 0), s0.get("h2d_bytes", 0),
                s0.get("scan_calls", 0))

    def pipeline_of(stats_list) -> tuple[float, int, int, int, float]:
        s0 = stats_list[0] if stats_list else {}
        return (s0.get("h2d_wait_s", 0.0), s0.get("refill_spans", 0),
                s0.get("spans_prestaged", 0), s0.get("spans_missed", 0),
                s0.get("prestage_wall_s", 0.0))

    pm = metrics_of(spill)
    if tr.enabled:
        tr.add_span(
            "pass-1", "pass", t0, time.perf_counter(),
            track="restream-pass-1", attrs=dict(base=base, rd=pm[0].rd),
        )
    pass_rd = [[pm[i].rd] for i in range(z)]
    pass_imbalance = [[pm[i].imbalance] for i in range(z)]
    pass_score_rows = [[s] for s in score_rows_of(pass_stats)]
    h2d_rows, h2d_bytes, scan_calls = h2d_of(pass_stats)
    (h2d_wait_s, refill_spans, spans_prestaged, spans_missed,
     prestage_wall_s) = pipeline_of(pass_stats)
    prefetch_depth = pass_stats[0].get("prefetch_depth", 0)
    buffer_rows = pass_stats[0].get("buffer_rows", 0)
    best_spill = [spill] * z
    best_rd = [pass_rd[i][0] for i in range(z)]
    best_pass = [1] * z
    prev = spill

    # The degree tables are pass-invariant: one counting read per instance,
    # reused by every warm start (no re-reads inside the pass loop).
    if passes > 1:
        with tr.span("degree-pass", cat="phase", z=z):
            degs = [
                _chunked_degrees(readers[i], num_vertices, chunk_edges)
                for i in range(z)
            ]
    else:
        degs = []
    for j in range(1, passes):
        t_pass = time.perf_counter()
        warms = [pm[i].warm(degs[i]) for i in range(z)]
        prev_read = [
            (lambda pv, off: lambda start, count: pv.read(off + start, count))(
                prev, int(offsets[i])
            )
            for i in range(z)
        ]
        spill = new_spill(j)
        pass_stats, handle = _drive_core(
            readers, num_vertices, cfg,
            write_assign=writer(spill),
            chunk_edges=chunk_edges, allowed=allowed, warm=warms,
            prev_read=prev_read, backend=backend,
            prefetch=prefetch, resume=handle, trace=trace, device=device,
        )
        rdist.barrier()
        pm = metrics_of(spill)
        dr, db, dc = h2d_of(pass_stats)
        h2d_rows += dr
        h2d_bytes += db
        scan_calls += dc
        dw, ds, dp, dm, dpw = pipeline_of(pass_stats)
        h2d_wait_s += dw
        refill_spans += ds
        spans_prestaged += dp
        spans_missed += dm
        prestage_wall_s += dpw
        buffer_rows = max(buffer_rows, pass_stats[0].get("buffer_rows", 0))
        improved = 0.0
        for i in range(z):
            improved = max(improved, pass_rd[i][-1] - pm[i].rd)
            pass_rd[i].append(pm[i].rd)
            pass_imbalance[i].append(pm[i].imbalance)
            pass_score_rows[i].append(score_rows_of(pass_stats)[i])
            if pm[i].rd <= best_rd[i]:
                best_spill[i], best_rd[i] = spill, pm[i].rd
                best_pass[i] = len(pass_rd[i])
        if tr.enabled:
            # Per-pass lane with the quality delta this pass bought.
            tr.add_span(
                f"pass-{j + 1}", "pass", t_pass, time.perf_counter(),
                track=f"restream-pass-{j + 1}",
                attrs=dict(rd=pm[0].rd,
                           rd_delta=pass_rd[0][-2] - pass_rd[0][-1],
                           improved=improved),
            )
        prev = spill
        if eps is not None and improved < eps:
            break

    passes_run = len(pass_rd[0])
    # Compose the final assignment from each instance's winning pass, then
    # drop the (passes x 4m-byte) intermediate spills — only the final spill
    # backs the returned memmap.
    with tr.span("compose", cat="phase", passes_run=passes_run):
        if rdist.rank() == 0:  # one writer of the final spill
            for i in range(z):
                src = best_spill[i] if keep_best else spill
                g0 = int(offsets[i])
                for start in range(0, int(m_per[i]), chunk_edges):
                    c = min(chunk_edges, int(m_per[i]) - start)
                    final_spill.write_range(g0 + start, src.read(g0 + start, c))
        rdist.barrier()
        for s in spills:
            s.remove()
    score_rows = int(sum(sum(sr) for sr in pass_score_rows))
    return dict(
        k=k,
        name="adwise-restream",
        base=base,
        passes=passes,
        passes_run=passes_run,
        stream_reads=passes_run,
        eps=eps,
        best_pass=best_pass[0] if keep_best else passes_run,
        pass_rd=pass_rd[0] if z == 1 else [list(r) for r in pass_rd],
        pass_imbalance=pass_imbalance[0] if z == 1 else None,
        pass_score_rows=pass_score_rows[0] if z == 1 else None,
        score_rows=score_rows,
        score_count=score_rows * k,
        h2d_rows=h2d_rows,
        h2d_bytes=h2d_bytes,
        h2d_wait_s=h2d_wait_s,
        prefetch_depth=prefetch_depth,
        refill_spans=refill_spans,
        spans_prestaged=spans_prestaged,
        spans_missed=spans_missed,
        prestage_wall_s=prestage_wall_s,
        scan_calls=scan_calls,
        buffer_rows=buffer_rows,
        wall_time_s=time.perf_counter() - t0,
    )


# ----------------------------------------------------------------------------
# partition_file — the public driver
# ----------------------------------------------------------------------------


def partition_file(
    reader,
    strategy: str,
    k: int,
    *,
    z: int = 1,
    spread: Optional[int] = None,
    seed: int = 0,
    chunk_edges: int = 1 << 16,
    spill_dir: Optional[str] = None,
    backend: str = "auto",
    prefetch: Optional[int] = None,
    trace=None,
    device=None,
    **cfg,
) -> PartitionResult:
    """Partition a file-resident edge stream with bounded edge memory.

    Args:
      reader: an :class:`repro_torch.graph.io.format.EdgeFileReader` (or
        sub-reader).
      strategy: registry strategy name — 'adwise', 'adwise-restream', '2ps',
        '2ps-l', 'hdrf', 'dbh', 'greedy', 'hash', 'grid'.
      k: global partition count.
      z: spotlight parallel-loading instances; z > 1 splits the file into z
        contiguous byte ranges (``EdgeFileReader.split`` — the boundaries
        `EdgeStream.split_padded` uses) and restricts instance i to a cyclic
        ``spread``-partition block, exactly like
        :func:`repro_torch.core.spotlight.spotlight_partition`.
      spread: partitions per instance (z > 1 only; default ``max(1, k // z)``).
      chunk_edges: the resident-edge bound. Per instance, the device-resident
        ring holds O(max(chunk_edges, window_max + assign_batch)) rows (a
        quantized multiple — see :class:`repro_torch.core.driver.FileSource`) and
        the host heap only ever holds one in-flight refill span of at most
        ``max(chunk_edges, window_max + assign_batch)`` rows; ``stats``
        report the realized bound as ``peak_resident_edges`` and the shipped
        traffic as ``h2d_rows`` / ``h2d_bytes``.
      spill_dir: directory for assignment spill files (default: a fresh
        temp dir; the final spill backs the returned ``assign`` memmap, so
        the directory outlives the call — pass e.g. a pytest tmp_path to
        control its lifetime).
      backend: forwarded to the batched scan ('auto'/'vmap'/'shard_map').
        Under a process group of several ranks on one host, 'auto' and
        'shard_map' place the z instances on the ranks
        (:func:`repro_torch.core.driver.resolve_backend`): every rank reads
        the file, runs its instances over its own ring and writes their
        rows into the one spill, and every rank returns the whole
        assignment. Each spill row is written once.
      prefetch: ring read-ahead depth (None → ``ADWISE_PREFETCH`` env →
        default 2; 0 = synchronous refills). See
        :func:`repro_torch.core.driver.resolve_prefetch` and the pipeline
        in :mod:`repro_torch.core.driver`.
      trace: an optional :class:`repro_torch.obs.Tracer`. When given, the
        whole pipeline records host-side spans into it (scan calls, refills,
        read-ahead staging, restream passes, phases) and stats carry a
        ``trace_summary`` (see :mod:`repro_torch.obs`). ``None`` selects the
        zero-overhead null tracer.
      device: where the ring and the scan run (default ``cuda``, which
        raises without a card; ``cpu`` runs the plain torch step).
      cfg: strategy knobs, exactly as `repro_torch.core.registry.run_partitioner`
        takes them (AdwiseConfig fields; `passes=`/`base=`/`keep_best=`/
        `eps=` for adwise-restream; `cluster_slack=` for 2ps;
        `cluster_slack=`/`lam=`/`eps=`/`cap_slack=` for 2ps-l; `lam=` for
        hdrf, ...).

    Returns a PartitionResult whose ``assign`` is a read-only memmap over the
    final spill file (stats carry ``spill_path``) — **bit-identical** to the
    in-memory registry / spotlight path for the same inputs.
    """
    device = compat.resolve_device(device)
    m = reader.num_edges
    n = reader.num_vertices
    if z < 1:
        raise ValueError(f"z must be >= 1, got {z}")
    if z > 1 and strategy in _SPOTLIGHT_INCOMPATIBLE:
        raise ValueError(
            f"strategy {strategy!r} does not compose with spotlight spread "
            "masking (see repro_torch.core.spotlight)"
        )
    if spread is None:
        spread = k if z == 1 else max(1, k // z)
    if m == 0:
        # Full stats surface (no spill file is created for an empty stream).
        return PartitionResult(
            np.zeros((0,), np.int32),
            dict(k=k, name=strategy, m=0, num_vertices=n, z=z,
                 chunk_edges=chunk_edges, peak_resident_edges=0,
                 spill_path=None, wall_time_s=0.0, io_wall_s=0.0,
                 rows_read=0, stream_reads=0, stream_reads_measured=0,
                 h2d_rows=0, h2d_bytes=0, scan_calls=0, buffer_rows=0,
                 h2d_wait_s=0.0, prefetch_depth=0, refill_spans=0,
                 spans_prestaged=0, spans_missed=0, prestage_wall_s=0.0,
                 unassigned=0),
        )
    if spill_dir is None:
        spill_dir = rdist.shared_tmpdir("adwise-oocore-")
    os.makedirs(spill_dir, exist_ok=True)

    tr = resolve_tracer(trace)
    rows_before = getattr(reader, "rows_read", 0)
    io_before = getattr(reader, "read_seconds", 0.0)
    final = _Spill(os.path.join(spill_dir, "assign.i32"), m)
    t0 = time.perf_counter()

    readers = list(reader.split(z)) if z > 1 else [reader]
    offsets = (
        np.asarray(EdgeStream.split_bounds(m, z)[:z])
        if z > 1
        else np.zeros((1,), np.int64)
    )
    allowed = (
        np.stack([spread_mask(k, z, i, spread) for i in range(z)])
        if z > 1
        else None
    )

    own = _owns_rows(backend, z)

    def write_core(i, idx, p):
        if own:
            final.write(offsets[i] + idx, p)

    def spotlightify(stats, per_stats):
        return dict(
            stats, name=f"spotlight-{strategy}", z=z, spread=spread,
            score_count=sum(s.get("score_count", 0) for s in per_stats),
        )

    if strategy in ("adwise", "adwise-restream"):
        unknown = set(cfg) - _ADWISE_FIELDS - (
            {"passes", "base", "keep_best", "eps", "n_chunks"}
            if strategy == "adwise-restream" else set()
        )
        if unknown:
            raise TypeError(f"{strategy}: unknown config keys {sorted(unknown)}")
        cfg.pop("n_chunks", None)
        if strategy == "adwise":
            acfg = AdwiseConfig(k=k, seed=seed, **cfg)
            per_stats, _ = _drive_core(
                readers, n, acfg, write_assign=write_core,
                chunk_edges=chunk_edges, allowed=allowed, backend=backend,
                prefetch=prefetch, trace=trace, device=device,
            )
            stats = dict(per_stats[0], stream_reads=1)
            if z > 1:
                stats = spotlightify(stats, per_stats)
        else:
            stats = _run_restream_chunks(
                readers, n, k, seed, chunk_edges, spill_dir, m, offsets, final,
                allowed=allowed, backend=backend, prefetch=prefetch,
                trace=trace, device=device, **cfg,
            )
            if z > 1:
                stats.update(name="spotlight-adwise-restream", z=z, spread=spread)
    elif strategy in ("2ps", "2ps-l"):
        allowed_keys = (
            _ADWISE_FIELDS | {"cluster_slack", "n_chunks"}
            if strategy == "2ps"
            else {"cluster_slack", "lam", "eps", "cap_slack", "n_chunks"}
        )
        unknown = set(cfg) - allowed_keys
        if unknown:
            raise TypeError(f"{strategy}: unknown config keys {sorted(unknown)}")
        cfg.pop("n_chunks", None)
        per_stats = _run_two_phase_chunks(
            readers, n, k, seed, chunk_edges, write_core,
            variant=strategy, allowed=allowed, backend=backend,
            prefetch=prefetch, trace=trace, device=device, **cfg,
        )
        stats = per_stats[0]
        if z > 1:
            stats = dict(
                spotlightify(stats, per_stats),
                n_clusters=[s["n_clusters"] for s in per_stats],
            )
    elif strategy in ("hdrf", "greedy"):
        if strategy == "hdrf":
            unknown = set(cfg) - {"lam", "eps"}
            if unknown:
                raise TypeError(f"hdrf: unknown config keys {sorted(unknown)}")
            core = baselines.HdrfCore(
                num_vertices=n, k=k, lam=float(cfg.get("lam", 1.1)),
                eps=float(cfg.get("eps", 1.0)), seed=seed,
            )
        else:
            if cfg:
                raise TypeError(f"greedy: unknown config keys {sorted(cfg)}")
            core = baselines.GreedyCore(num_vertices=n, k=k)
        per_stats, _ = _drive_core(
            readers, n, core, write_assign=write_core,
            chunk_edges=chunk_edges, allowed=allowed, backend=backend,
            prefetch=prefetch, trace=trace, device=device,
        )
        stats = dict(per_stats[0], stream_reads=1)
        if z > 1:
            stats = spotlightify(stats, per_stats)
    elif strategy in ("hash", "dbh", "grid"):
        # Every rank runs the loop; rank 0 writes the rows.
        own = rdist.rank() == 0
        if z == 1:
            stats = _run_baseline_chunks(
                strategy, reader, n, k, seed, chunk_edges,
                lambda off, a: final.write_range(off, a) if own else None, trace=trace, **cfg,
            )
        else:
            stats = _run_stateless_spotlight(
                strategy, readers, offsets, n, k, z, spread, seed,
                chunk_edges, final, cfg, trace=trace, write=own,
            )
    else:
        raise KeyError(
            f"partition_file has no out-of-core driver for strategy "
            f"{strategy!r}"
        )

    wall = time.perf_counter() - t0
    rows_read = getattr(reader, "rows_read", 0) - rows_before
    io_wall = getattr(reader, "read_seconds", 0.0) - io_before
    measured_reads = max(1, int(round(rows_read / max(m, 1))))
    # Resident-edge ceiling: per instance, the (device-resident) ring buffer
    # (or baseline chunk) plus host-side in-flight reads of at most the same
    # size. Host heap itself only ever holds one refill span (<= chunk).
    buffer_rows = int(stats.get("buffer_rows", chunk_edges) or chunk_edges)
    stats = dict(
        stats,
        k=k,
        file=getattr(reader, "path", None),
        m=m,
        num_vertices=n,
        z=z,
        chunk_edges=chunk_edges,
        peak_resident_edges=z * 2 * buffer_rows,
        spill_path=final.path,
        wall_time_s=stats.get("wall_time_s", wall),
        io_wall_s=io_wall,
        rows_read=int(rows_read),
        stream_reads=int(stats.get("stream_reads", measured_reads)),
        stream_reads_measured=measured_reads,
        unassigned=0,
    )
    rdist.barrier()  # every rank's rows are in the spill
    # Chunked completeness check (no O(m) temporary; raises even under -O).
    with tr.span("spill-verify", cat="phase", m=m):
        neg = 0
        for start in range(0, m, chunk_edges):
            a = final.read(start, min(chunk_edges, m - start))
            neg += int((a < 0).sum())
    if neg:
        raise RuntimeError(f"partition_file left {neg} of {m} edges unassigned")
    if tr.enabled:
        tr.add_span(
            "partition_file", "phase", t0, time.perf_counter(),
            attrs=dict(strategy=strategy, k=k, z=z, m=m),
        )
        stats["trace_summary"] = tr.summary().as_dict()
    return PartitionResult(final.flush_readonly(), stats)


def _run_stateless_spotlight(
    strategy: str,
    readers: Sequence,
    offsets: np.ndarray,
    num_vertices: int,
    k: int,
    z: int,
    spread: int,
    seed: int,
    chunk_edges: int,
    final: _Spill,
    cfg: dict,
    trace=None,
    write: bool = True,
) -> dict:
    """z>1 spotlight for the stateless hashes (hash/dbh): each instance runs
    the chunked assignment at its local spread-k over its byte range with
    ``seed + i``, local partition *ranks* remapped to the global ids its mask
    selects — the same rank-remap `spotlight_partition`'s batched backend
    applies to masked hashing in memory, so file == memory bit-for-bit."""
    t0 = time.perf_counter()
    walls, score_counts, reads = [], 0, 0
    for i in range(z):
        allowed = spread_mask(k, z, i, spread)
        local_to_global = np.flatnonzero(allowed).astype(np.int32)
        g0 = int(offsets[i])
        st = _run_baseline_chunks(
            strategy, readers[i], num_vertices, int(allowed.sum()),
            seed + i, chunk_edges,
            lambda off, a, g0=g0, m_=local_to_global: final.write_range(
                g0 + off, m_[a]
            ) if write else None,
            trace=trace,
            **cfg,
        )
        walls.append(st.get("wall_time_s", 0.0))
        score_counts += st.get("score_count", 0)
        reads = max(reads, st.get("stream_reads", 1))
    return dict(
        k=k,
        z=z,
        spread=spread,
        name=f"spotlight-{strategy}",
        backend="loop",
        wall_time_s=max(walls) if walls else 0.0,
        wall_time_serial_s=time.perf_counter() - t0,
        score_count=score_counts,
        stream_reads=reads,
    )
