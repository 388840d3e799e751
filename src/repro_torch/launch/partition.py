"""Graph partition→process launcher of the port — the paper's pipeline.

    PYTHONPATH=src python -m repro_torch.launch.partition --graph brain_like \
        --scale 1.0 --k 32 --device cuda
    # spotlight: 8 instances, each on a block of 4 partitions, one batched scan
    PYTHONPATH=src python -m repro_torch.launch.partition --graph brain_like \
        --scale 1.0 --strategy adwise --k 32 --z 8 --spread 4 --trace trace.json

Runs: a generator preset → stream partitioning (a strategy of
``repro_torch.core.registry``, optionally under spotlight parallel loading
with ``--z N``: the z instances run as ONE batched scan for every registry
strategy but grid, ``--backend loop`` runs them one after another) →
vertex-cut engine build → workload → total latency report (partitioning
wall-clock + modeled cluster processing latency), printing the same lines
as the JAX package's ``repro.launch.partition``. ``--device`` picks
``cuda`` (default) or ``cpu``.

``--trace out.json`` records a span timeline with
:class:`repro_torch.obs.Tracer` — one ``partition`` phase span and one
``superstep`` span per engine superstep — and writes it as Chrome
trace-event JSON (open it in https://ui.perfetto.dev). Tracing is
host-side only: it adds no device synchronisation.

``--graph`` also takes a *path*: a binary edge-stream file
(``repro_torch.graph.io`` format) is partitioned out-of-core through
``repro_torch.core.oocore.partition_file`` — resident edge memory stays
bounded by ``--chunk-edges``, assignments spill to disk, quality metrics
accumulate in chunks, and the report adds the measured IO and the ring's
refill pipeline. ``--ingest`` converts a SNAP-style text edge list to the
binary format first (``--relabel`` densifies sparse vertex ids);
``--prefetch N`` sets the read-ahead depth (0 = synchronous refills)::

    PYTHONPATH=src python -m repro_torch.launch.partition --graph g.txt \
        --ingest --strategy adwise --k 32 --z 8 --spread 4 \
        --chunk-edges 8192 --spill-dir spill --workload pagerank

Under torchrun (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set, or a
process group already initialised) the pipeline runs over the ranks, as the
JAX launcher runs over every local device: the ``--z`` instances are placed
on an ``instances`` mesh of ranks (``--backend auto``, ``batched`` or
``shard_map``), then the k partitions on a ``parts`` mesh for the workload.
``--dist-backend`` defaults to ``nccl`` on ``cuda`` and ``gloo`` on
``cpu``; NCCL refuses two ranks on one card (use gloo there).
``--dist-init`` is the group's init method (``env://`` by default, or
``file:///path``). Every rank computes the same result; only rank 0 prints
and writes ``--json`` and ``--trace``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.partition --graph brain_like --scale 0.25 \
        --k 32 --z 8 --spread 4 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import time

import torch
import torch.distributed as dist

from repro_torch.core import (
    AdwiseConfig,
    available_strategies,
    partition_file,
    run_partitioner,
    spotlight_partition,
)
from repro_torch.engine import (
    PAPER_CLUSTER,
    build_partitioned_graph,
    coloring,
    label_propagation,
    pagerank,
    process_latency,
    triangle_count,
)
from repro_torch.launch import mesh as meshes
from repro_torch.graph import (
    GRAPH_PRESETS,
    make_graph,
    partition_balance,
    quality_from_chunks,
    replica_sets_from_assignment,
    replication_degree,
    unassigned_count,
)

# Strategies that take AdwiseConfig-style knobs from the CLI.
_ADWISE_LIKE = ("adwise", "adwise-restream", "2ps")


def _adwise_cfg_kwargs(args) -> dict:
    return dict(window_max=args.window_max, latency_budget=args.budget,
                use_clustering=not args.no_cs)


def _strategy_cfg_kwargs(args) -> dict:
    """Registry-style **cfg for the active strategy (file-driven path)."""
    cfg = {}
    if args.strategy in _ADWISE_LIKE:
        cfg = _adwise_cfg_kwargs(args)
    if args.strategy == "adwise-restream":
        cfg["passes"] = args.passes
        if args.eps is not None:
            cfg["eps"] = args.eps
    return cfg


def run_partition_file(path, args, trace=None):
    """Out-of-core path: ingest (optional) → partition_file → the reader,
    the result and the temporary directories the run must remove."""
    from repro_torch.graph.io import EdgeFileReader

    if args.oracle:
        raise SystemExit(
            "--oracle (the sequential Algorithm-1 reference) has no "
            "out-of-core driver; run it on a generator preset instead"
        )
    if args.backend in ("batched", "loop"):
        print(f"note: --backend {args.backend} has no file-driven equivalent; "
              "using 'auto' (every scan-core strategy rides the batched ring "
              "buffer; only the stateless hashes run a per-instance loop)")
    ingest_tmp = None
    if args.ingest:
        ingest_tmp, path = _ingest(path, args)
    reader = EdgeFileReader(path)
    print(
        f"graph={path} |V|={reader.num_vertices} |E|={reader.num_edges} "
        f"k={args.k} (out-of-core, chunk={args.chunk_edges})"
    )
    backend = args.backend if args.backend not in ("batched", "loop") else "auto"
    spill_tmp = None if args.spill_dir else meshes.shared_tmpdir("adwise-oocore-")
    try:
        res = partition_file(
            reader, args.strategy, args.k, z=args.parallel,
            spread=args.spread if args.parallel > 1 else None, seed=args.seed,
            chunk_edges=args.chunk_edges, backend=backend,
            spill_dir=args.spill_dir or spill_tmp, prefetch=args.prefetch,
            trace=trace, device=args.device, **_strategy_cfg_kwargs(args),
        )
    except BaseException:
        reader.close()
        _remove(spill_tmp, ingest_tmp, wait=False)
        raise
    return reader, res, spill_tmp, ingest_tmp


def _remove(*dirs, wait: bool = True) -> None:
    """Remove the run's temporary directories: rank 0 does, once every rank
    is done with them (``wait=False``: at once, on a failed run)."""
    if wait:
        meshes.barrier()
    for tmp in dirs:
        if tmp is not None and meshes.rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)


def _ingest(path, args):
    """(temporary directory or None, binary path) of ``--ingest``: rank 0
    converts the text list (or finds an up-to-date binary); the others wait
    for it."""
    from repro_torch.graph.io import ingest_text

    ingest_tmp = None
    # The cache name keys on --relabel: the two settings produce different
    # id spaces, so they must never reuse each other's binary.
    suffix = ".relabel.adw" if args.relabel else ".adw"
    binary = path + suffix
    if not os.access(os.path.dirname(os.path.abspath(path)) or ".", os.W_OK):
        # Read-only dataset mount: put the binary in the spill dir (kept) or
        # a temp dir the end of the run removes.
        if args.spill_dir is None:
            ingest_tmp = meshes.shared_tmpdir("adwise-ingest-")
        else:
            os.makedirs(args.spill_dir, exist_ok=True)
        binary = os.path.join(args.spill_dir or ingest_tmp, os.path.basename(path) + suffix)
    if meshes.rank() == 0:
        if os.path.exists(binary) and os.path.getmtime(binary) >= os.path.getmtime(path):
            print(f"reusing up-to-date binary {binary} (delete it to re-ingest)")
        else:
            rep = ingest_text(path, binary, relabel=args.relabel)
            mb = rep.bytes_read / 1e6
            print(
                f"ingested {path}: {rep.num_edges} edges, {rep.num_vertices} "
                f"vertices, {rep.comment_lines} comments, {rep.blank_lines} "
                f"blanks in {rep.wall_s:.2f}s "
                f"({mb / max(rep.wall_s, 1e-9):.1f} MB/s) -> {binary}"
            )
    meshes.barrier()
    return ingest_tmp, binary


def _chunked_quality(res, reader, args) -> tuple[float, float]:
    """(RD, ι) of a file run, accumulated in chunks: the edge array is
    never materialised."""
    assign = res.assign
    pairs = (
        (chunk, assign[s : s + len(chunk)])
        for s, chunk in zip(range(0, reader.num_edges, args.chunk_edges),
                            reader.chunks(args.chunk_edges))
    )
    q = quality_from_chunks(pairs, reader.num_vertices, args.k, unassigned="drop")
    return q["replication_degree"], q["imbalance"]


def _print_file_io(st: dict) -> None:
    """The io and refill-pipeline report lines of a file run."""
    print(
        f"io: {st['rows_read']} rows read "
        f"({st['stream_reads_measured']} stream reads, billed "
        f"{st['stream_reads']}), io_wall={st['io_wall_s']:.2f}s, "
        f"resident edges <= {st['peak_resident_edges']}, "
        f"h2d={st.get('h2d_bytes', 0) / 1e6:.2f} MB "
        f"({st.get('h2d_rows', 0)} rows over "
        f"{st.get('scan_calls', 0)} scan calls, "
        f"ring={st.get('buffer_rows', 0)} rows), "
        f"spill={st['spill_path']}"
    )
    spans = int(st.get("refill_spans", 0) or 0)
    if spans:
        pre = int(st.get("spans_prestaged", 0) or 0)
        wait = float(st.get("h2d_wait_s", 0.0) or 0.0)
        prestage = float(st.get("prestage_wall_s", 0.0) or 0.0)
        # Measured overlap: fraction of the worker's staging wall hidden
        # from the driver's critical path (1 - stall/staging).
        overlap = max(0.0, 1.0 - wait / prestage) if prestage > 0 else 0.0
        print(
            f"pipeline: prefetch={st.get('prefetch_depth', 0)}, "
            f"h2d_wait={wait:.3f}s, prestage_wall={prestage:.3f}s, "
            f"spans={spans} ({pre} prestaged / "
            f"{int(st.get('spans_missed', 0) or 0)} missed), "
            f"overlap={overlap:.0%}"
        )


def run_partition(edges, n, args, trace=None):
    """Partition under one ``partition`` phase span (the registry and
    spotlight routes record no finer spans here, as in the JAX launcher)."""
    from repro_torch.obs import resolve_tracer

    with resolve_tracer(trace).span("partition", cat="phase", strategy=args.strategy, k=args.k):
        return _run_partition(edges, n, args)


def _run_partition(edges, n, args):
    if args.parallel > 1:
        cfg = None
        strategy_cfg = None
        if args.strategy == "adwise":
            cfg = AdwiseConfig(k=args.k, **_adwise_cfg_kwargs(args))
        elif args.strategy in _ADWISE_LIKE:
            strategy_cfg = _adwise_cfg_kwargs(args)
            if args.strategy == "adwise-restream":
                strategy_cfg["passes"] = args.passes
                if args.eps is not None:
                    strategy_cfg["eps"] = args.eps
        return spotlight_partition(
            edges, n, args.k, z=args.parallel, spread=args.spread,
            strategy=args.strategy, cfg=cfg, seed=args.seed,
            strategy_cfg=strategy_cfg, backend=args.backend, device=args.device,
        )
    cfg = {}
    if args.strategy in _ADWISE_LIKE:
        cfg = _adwise_cfg_kwargs(args)
    if args.strategy == "adwise":
        cfg["oracle"] = args.oracle
    elif args.strategy == "adwise-restream":
        cfg["passes"] = args.passes
        if args.eps is not None:
            cfg["eps"] = args.eps
    return run_partitioner(args.strategy, edges, n, args.k, seed=args.seed,
                           device=args.device, **cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="brain_like",
                    help="generator preset (brain_like/orkut_like/web_like/...)"
                         " OR a path to a graph file: a binary edge-stream "
                         "file (repro_torch.graph.io format) is partitioned "
                         "out-of-core with bounded edge memory; with "
                         "--ingest, a SNAP-style text edge list is converted "
                         "to the binary format first")
    ap.add_argument("--ingest", action="store_true",
                    help="treat --graph as a text edge list (u v per line, "
                         "#/%% comments, blank lines) and ingest it to "
                         "<graph>.adw before partitioning (one pass, "
                         "O(chunk) memory)")
    ap.add_argument("--relabel", action="store_true",
                    help="with --ingest: map vertex ids to a dense [0, n) "
                         "space in first-appearance order (required for "
                         "sparse or negative ids)")
    ap.add_argument("--chunk-edges", type=int, default=1 << 16,
                    help="out-of-core chunk size: resident edge rows are "
                         "bounded by ~2x this per spotlight instance "
                         "(file-driven path only)")
    ap.add_argument("--spill-dir", default=None,
                    help="directory for the assignment spill (file-driven "
                         "path). Default: a temp dir, removed when the run "
                         "finishes; pass a path to keep the spill")
    ap.add_argument("--prefetch", type=int, default=None,
                    help="read-ahead depth for the file-driven ring refill "
                         "pipeline: 0 = synchronous, N>=1 overlaps file reads "
                         "with the running scan. Default: $ADWISE_PREFETCH or 2")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--strategy", default="adwise",
                    help=f"one of {', '.join(available_strategies())}")
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--parallel", "--z", type=int, default=1, dest="parallel",
                    help="z partitioner instances (spotlight parallel loading)")
    ap.add_argument("--spread", type=int, default=4)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "batched", "vmap", "shard_map", "loop"],
                    help="spotlight execution: one batched scan for all z "
                         "instances (auto — every registry strategy batches; "
                         "under several ranks auto, batched and shard_map "
                         "split the instances over them) or the sequential "
                         "per-instance loop")
    ap.add_argument("--budget", type=float, default=None, help="latency preference L (s)")
    ap.add_argument("--window-max", type=int, default=256)
    ap.add_argument("--no-cs", action="store_true", help="disable clustering score")
    ap.add_argument("--oracle", action="store_true", help="sequential reference impl")
    ap.add_argument("--passes", type=int, default=2,
                    help="re-streaming passes (adwise-restream)")
    ap.add_argument("--eps", type=float, default=None,
                    help="adwise-restream early stop: stop once a pass improves "
                         "RD by less than this (default: run every pass)")
    ap.add_argument("--workload", default="pagerank",
                    choices=["pagerank", "coloring", "wcc", "triangles", "none"])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None)
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend under torchrun (default: nccl "
                         "on cuda, gloo on cpu)")
    ap.add_argument("--dist-init", default="env://",
                    help="process-group init method under torchrun")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record a span timeline of the run (repro_torch.obs) "
                         "and write Chrome trace-event JSON here — open in "
                         "https://ui.perfetto.dev. Host-side only: no added "
                         "device syncs")
    args = ap.parse_args(argv)

    from_file = args.ingest or os.path.exists(args.graph)
    if not from_file and args.graph not in GRAPH_PRESETS:
        ap.error(f"unknown graph preset {args.graph!r}; presets: {', '.join(GRAPH_PRESETS)}")
    if args.strategy not in available_strategies():
        ap.error(f"unknown strategy {args.strategy!r}; "
                 f"available: {', '.join(available_strategies())}")

    owns_group = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        owns_group = True
        backend = args.dist_backend or ("nccl" if args.device == "cuda" else "gloo")
        meshes.init_ranks(backend, torch.device(args.device), args.dist_init)
    # Every rank runs the pipeline; rank 0 alone reports.
    quiet = contextlib.redirect_stdout(io.StringIO()) if meshes.rank() else contextlib.nullcontext()
    try:
        with quiet:
            return _run(args, from_file)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, from_file):
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    reader = None
    spill_tmp = ingest_tmp = None
    if from_file:
        reader, res, spill_tmp, ingest_tmp = run_partition_file(args.graph, args, trace=tracer)
        n = reader.num_vertices
        edges = None  # never resident during partitioning
    else:
        edges, n = make_graph(args.graph, seed=args.seed, scale=args.scale)
        print(f"graph={args.graph} |V|={n} |E|={len(edges)} k={args.k}")
        res = run_partition(edges, n, args, trace=tracer)
    try:
        return _report(args, res, edges, n, reader, tracer)
    finally:
        if from_file:
            # The temp spill dies with the run (POSIX keeps the live mapping
            # valid past the unlink); --spill-dir keeps it instead. The
            # reader always closes.
            reader.close()
            _remove(spill_tmp, ingest_tmp)


def _report(args, res, edges, n, reader, tracer) -> dict:
    """Quality, workload and total-latency report of a partition result."""
    n_unassigned = unassigned_count(res.assign)
    if reader is not None:
        rd, imb = _chunked_quality(res, reader, args)
    else:
        rep = replica_sets_from_assignment(edges, res.assign, n, args.k, unassigned="drop")
        rd = replication_degree(rep)
        imb = partition_balance(res.assign, args.k, unassigned="drop")
    t_part = res.stats.get("wall_time_s", 0.0)
    print(f"partitioner={args.strategy} RD={rd:.3f} imbalance={imb:.4f} "
          f"unassigned={n_unassigned} partition_latency={t_part:.2f}s")
    if reader is not None:
        _print_file_io(res.stats)
    out = dict(
        graph=args.graph, strategy=args.strategy, k=args.k, device=args.device,
        replication_degree=rd, imbalance=imb, unassigned=n_unassigned,
        partition_latency_s=t_part,
        stats={k: v for k, v in res.stats.items()
               if isinstance(v, (int, float, str))
               or (isinstance(v, list) and all(isinstance(x, (int, float)) for x in v))},
    )
    if args.workload != "none":
        if reader is not None:
            # Partitioning ran out-of-core; the processing engine builds a
            # resident partitioned graph, so the edges are loaded only now.
            print("loading edges for the processing engine (partitioning "
                  "itself ran out-of-core)")
            edges = reader.read_all()
        g = build_partitioned_graph(edges, res.assign, n, args.k, device=args.device)
        t0 = time.perf_counter()
        if args.workload == "pagerank":
            _, info = pagerank(g, iters=min(args.iters, 30), trace=tracer)
            info["supersteps"] = args.iters
        elif args.workload == "coloring":
            _, info = coloring(g, trace=tracer)
        elif args.workload == "wcc":
            _, info = label_propagation(g, trace=tracer)
        else:
            _, info = triangle_count(g, trace=tracer)
        t_proc_local = time.perf_counter() - t0
        model = process_latency(g, info["supersteps"], info["msg_width"], PAPER_CLUSTER)
        total = t_part + model["t_total_s"]
        print(
            f"workload={args.workload} supersteps={info['supersteps']} "
            f"modeled_processing={model['t_total_s']:.2f}s (cluster: {model['profile']}) "
            f"local_exec={t_proc_local:.2f}s\n"
            f"TOTAL latency (partition + modeled processing) = {total:.2f}s"
        )
        out.update(workload=args.workload, processing_model=model, total_latency_s=total)
    if tracer is not None:
        n_events = tracer.export(args.trace) if meshes.rank() == 0 else 0
        summ = tracer.summary()
        cats = ", ".join(
            f"{c}:{d['count']}x/{d['wall_s']:.3f}s"
            for c, d in sorted(summ.categories.items())
        )
        print(f"trace: {n_events} events -> {args.trace} "
              f"(wall={summ.wall_s:.3f}s; {cats})")
        out["trace"] = dict(path=args.trace, **summ.as_dict())
    if args.json and meshes.rank() == 0:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
