"""Spotlight partitioning (§III-D): reduce the *spread* of parallel partitioners.

Port of the JAX package's ``core/spotlight.py``. With ``z`` parallel
partitioner instances and ``k`` global partitions, each instance ``i`` is
restricted to a window ("spread") of ``s`` partitions starting at
``i * k/z`` (cyclic). ``s = k/z`` gives fully disjoint blocks — the
configuration the paper recommends; ``s = k`` degenerates to the usual
full-spread parallel loading. Spotlight composes with *any* streaming
partitioner.

Instance-axis layout (the batched backend)
------------------------------------------
The paper's cluster runs the z instances on z machines; here they run as
ONE batched step on one card, or as blocks of one batched step on the ranks
of an ``instances`` mesh (``backend="shard_map"``, which ``"auto"`` and
``"batched"`` resolve to under a process group of several ranks, as the
JAX package resolves them on several devices; see
:mod:`repro_torch.core.driver`). ``EdgeStream.split_padded(z)`` reshapes the
stream into ``streams[z, per, 2]`` with a per-row prefix mask
``valid[z, per]`` — instance ``i`` owns the contiguous global slice
``[i*per, i*per + valid[i].sum())``. Every per-instance quantity of the
scan (vertex cache, window, partition loads, λ, controller state) carries a
leading ``z`` axis, and :func:`repro_torch.core.adwise.partition_stream_batched`
advances all z scans with each step — one ``window_score`` launch for all
instances. Instances share nothing (the parallel loading model).

Backends:

* ``"batched"`` (the ``"auto"`` default for every registry strategy): one
  batched scan for all z instances. The adwise-scan family (adwise,
  adwise-restream, 2ps, 2ps-l) and the step-core baselines (hdrf, greedy)
  batch their scan over the instance axis; the stateless hashes (hash,
  dbh) run their vectorized assignment per instance. ``wall_time_s`` is
  the measured wall of the batched scan, which IS the parallel-model wall.
  ``"vmap"`` / ``"shard_map"`` are passed to the batched scan as in the
  JAX package: ``"vmap"`` runs every instance on every rank, and
  ``"shard_map"`` splits them over the ranks (``vmap`` with one rank).
* ``"loop"``: the sequential per-instance path — one registry call per
  instance at GLOBAL k with the instance's ``allowed`` spread mask;
  required only for custom ``partitioner=`` callables and non-adwise
  restream base passes. ``wall_time_s`` then reports the parallel model
  ``max(instance walls)``. Bit-identical to the batched backend for every
  registry strategy.

Per-instance seeds: the stateless hashes and HDRF's counter-based tie noise
derive instance ``i``'s stream from ``seed + i`` (loop and batched agree:
``HdrfCore.seed_instances`` plants the same ``seed + i`` per instance). The
adwise-scan strategies share one ``seed`` across instances.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import compat
from repro_torch.core import baselines, registry
from repro_torch.core.adwise import partition_stream, partition_stream_batched
from repro_torch.core.restream import (
    restream_partition_batched,
    two_phase_partition_batched,
)
from repro_torch.core.types import AdwiseConfig, PartitionResult
from repro_torch.graph.stream import EdgeStream

__all__ = ["spread_mask", "spotlight_partition"]


def spread_mask(k: int, z: int, instance: int, spread: int) -> np.ndarray:
    """bool (k,): partitions instance ``i`` may fill — cyclic block of ``spread``."""
    if not 1 <= spread <= k:
        raise ValueError(f"spread must be in [1, k={k}], got {spread}")
    start = (instance * k) // z
    idx = (start + np.arange(spread)) % k
    mask = np.zeros((k,), bool)
    mask[idx] = True
    return mask


# Grid's vertex-pair cells impose their own replica constraint and cannot
# honour an allowed subset.
_SPOTLIGHT_INCOMPATIBLE = {"grid"}

# Strategies whose per-instance state is an independent seed: instance i
# runs with seed + i on both backends.
_PER_INSTANCE_SEED = {"hash", "dbh", "hdrf", "greedy"}

# spotlight backend -> inner partition_stream_batched backend.
_BATCHED_INNER = {"batched": "auto", "vmap": "vmap", "shard_map": "shard_map"}


def _reject_incompatible(strategy: str) -> None:
    if strategy in _SPOTLIGHT_INCOMPATIBLE:
        raise ValueError(
            f"strategy {strategy!r} does not compose with spotlight spread "
            "masking (its placement structure ignores the allowed subset); "
            "use hash/dbh/hdrf/greedy or the adwise family"
        )


def _adwise_cfg(cfg: Optional[AdwiseConfig], k: int) -> AdwiseConfig:
    c = cfg or AdwiseConfig(k=k)
    return c if c.k == k else dataclasses.replace(c, k=k)


def _spotlight_batched(
    edges, num_vertices, k, z, spread, strategy, cfg, seed, strategy_cfg,
    inner_backend, trace, device,
):
    """One batched scan for all z instances (any registry strategy)."""
    stream = EdgeStream(edges, num_vertices)
    streams, valid = stream.split_padded(z)
    per = streams.shape[1]
    m = stream.num_edges
    allowed = np.stack([spread_mask(k, z, i, spread) for i in range(z)])
    scfg = dict(strategy_cfg or {})
    run = dict(allowed=allowed, backend=inner_backend, trace=trace, device=device)
    t0 = time.perf_counter()
    if strategy == "adwise":
        results = partition_stream_batched(
            streams, valid, num_vertices, _adwise_cfg(cfg, k), **run)
    elif strategy == "adwise-restream":
        # Per-instance WarmState batches between passes.
        results = restream_partition_batched(
            streams, valid, num_vertices, k, seed=seed, **run, **scfg)
    elif strategy in ("2ps", "2ps-l"):
        results = two_phase_partition_batched(
            streams, valid, num_vertices, k, variant=strategy, seed=seed, **run, **scfg)
    elif strategy in ("hdrf", "greedy"):
        if strategy == "hdrf":
            unknown = set(scfg) - {"lam", "eps"}
            if unknown:
                raise TypeError(f"hdrf: unknown config keys {sorted(unknown)}")
            core = baselines.HdrfCore(
                num_vertices=int(num_vertices), k=int(k),
                lam=float(scfg.get("lam", 1.1)), eps=float(scfg.get("eps", 1.0)),
                seed=int(seed),
            )
        else:
            if scfg:
                raise TypeError(f"greedy: unknown config keys {sorted(scfg)}")
            core = baselines.GreedyCore(num_vertices=int(num_vertices), k=int(k))
        results = partition_stream_batched(
            streams, valid, num_vertices, None, core=core, **run)
    else:
        # Stateless hashes (hash/dbh) — or an unknown name, which
        # run_partitioner rejects. One vectorized assignment per instance;
        # seed + i is each instance's independent hash stream.
        m_per = valid.sum(axis=1)
        results = [
            registry.run_partitioner(
                strategy, streams[i, : m_per[i]], num_vertices, k,
                seed=seed + i, allowed=allowed[i], device=device, **scfg,
            )
            for i in range(z)
        ]
    serial_wall = time.perf_counter() - t0
    assign = np.full((m,), -1, np.int32)
    for i, r in enumerate(results):
        assign[i * per : i * per + len(r.assign)] = r.assign
    s0 = results[0].stats if results else {}
    if strategy in ("hash", "dbh"):
        # Independent vectorized assigns: the parallel model bills the
        # slowest one.
        wall = max((r.stats.get("wall_time_s", 0.0) for r in results), default=0.0)
    else:
        # One batched scan ran every instance: its wall IS the parallel wall.
        wall = s0.get("wall_time_s", serial_wall)
    stats = dict(
        k=k,
        z=z,
        spread=spread,
        name=f"spotlight-{strategy}",
        backend=s0.get("backend", "batched"),
        n_shards=s0.get("n_shards", 0),
        wall_time_s=wall,
        wall_time_serial_s=serial_wall,
        score_count=sum(r.stats.get("score_count", 0) for r in results),
        stream_reads=s0.get("stream_reads", 1),
        # One batched scan shipped one stream upload for all instances.
        h2d_rows=s0.get("h2d_rows", 0),
        h2d_bytes=s0.get("h2d_bytes", 0),
    )
    if strategy == "adwise-restream":
        stats["passes_run"] = s0.get("passes_run", 1)
    # The port's own: the batched scan's steps, for µs per step.
    for key in ("steps_run", "warmup_steps", "setup_s", "scan_calls", "n_buckets"):
        if key in s0:
            stats[key] = s0[key]
    if trace is not None and trace.enabled:
        stats["trace_summary"] = trace.summary().as_dict()
    return PartitionResult(assign, stats)


def spotlight_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    z: int,
    spread: int,
    strategy: str = "adwise",
    cfg: Optional[AdwiseConfig] = None,
    seed: int = 0,
    partitioner: Optional[Callable] = None,
    strategy_cfg: Optional[dict] = None,
    backend: str = "auto",
    trace=None,
    device=None,
) -> PartitionResult:
    """Run ``z`` parallel partitioner instances with a limited spread.

    Args:
      strategy: any name in ``registry.available_strategies()`` except
        'grid' — every registry strategy runs at GLOBAL k restricted by its
        instance's ``allowed`` spread mask, on either backend. Or pass
        ``partitioner``: callable (edges, num_vertices, k, allowed, seed) ->
        PartitionResult with *global* partition ids (loop backend only).
      cfg: AdwiseConfig for strategy='adwise' (k is overridden).
      strategy_cfg: keyword cfg forwarded to every non-'adwise' strategy
        instance (e.g. ``dict(passes=3, window_max=64)`` for
        'adwise-restream', ``dict(lam=1.5)`` for 'hdrf').
      spread: partitions per instance; k/z = disjoint spotlight blocks.
      backend: 'auto' (batched for every registry strategy, loop for custom
        partitioners), 'batched' / 'vmap' / 'shard_map' (one batched scan
        for all instances — see the module docstring), or 'loop'
        (sequential per-instance path, bit-identical; wall_time_s reports
        the parallel model max(instance walls)).
      trace: optional :class:`repro_torch.obs.Tracer`, threaded through to
        the scan drivers (the stats gain ``trace_summary``).
      device: ``cuda`` by default (:func:`repro_torch.compat.resolve_device`).
    """
    if partitioner is None:
        _reject_incompatible(strategy)
    device = compat.resolve_device(device)
    batchable = partitioner is None
    if strategy == "adwise-restream" and (strategy_cfg or {}).get("base", "adwise") != "adwise":
        # A non-adwise base pass runs per-instance registry baselines, which
        # only the sequential path supports.
        batchable = False
    if backend == "auto":
        backend = "batched" if batchable else "loop"
    if backend in _BATCHED_INNER:
        if not batchable:
            raise ValueError(
                f"backend {backend!r} needs a registry strategy with an "
                f"adwise base pass (got {strategy!r}"
                f"{' with custom partitioner' if partitioner else ''}); "
                "use backend='loop'"
            )
        return _spotlight_batched(
            edges, num_vertices, k, z, spread, strategy, cfg, seed,
            strategy_cfg, _BATCHED_INNER[backend], trace, device,
        )
    if backend != "loop":
        raise ValueError(
            "backend must be 'auto', 'batched', 'vmap', 'shard_map' or "
            f"'loop', got {backend!r}"
        )

    stream = EdgeStream(edges, num_vertices)
    subs = stream.split(z)
    m = stream.num_edges
    assign = np.full((m,), -1, np.int32)
    offsets = EdgeStream.split_bounds(m, z)
    walls, score_counts = [], 0
    t0 = time.perf_counter()
    for i, sub in enumerate(subs):
        allowed = spread_mask(k, z, i, spread)
        if partitioner is not None:
            res = partitioner(sub.edges, num_vertices, k, allowed, seed + i)
        elif strategy == "adwise":
            # Per-instance latency budget: the budget is wall-clock and the
            # instances run in parallel on the cluster, so each gets L.
            res = partition_stream(sub.edges, num_vertices, _adwise_cfg(cfg, k),
                                   allowed=allowed, trace=trace, device=device)
        else:
            res = registry.run_partitioner(
                strategy, sub.edges, num_vertices, k,
                seed=seed + i if strategy in _PER_INSTANCE_SEED else seed,
                allowed=allowed, device=device, **(strategy_cfg or {}),
            )
        assign[offsets[i] : offsets[i + 1]] = res.assign
        walls.append(res.stats.get("wall_time_s", 0.0))
        score_counts += res.stats.get("score_count", 0)
    stats = dict(
        k=k,
        z=z,
        spread=spread,
        name=f"spotlight-{strategy}",
        backend="loop",
        wall_time_s=max(walls) if walls else 0.0,
        wall_time_serial_s=time.perf_counter() - t0,
        score_count=score_counts,
    )
    if trace is not None and trace.enabled:
        stats["trace_summary"] = trace.summary().as_dict()
    return PartitionResult(assign, stats)
