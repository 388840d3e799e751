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

A graph file path (out-of-core) is not ported yet and exits with a message
that names its ROADMAP.md item, never falling through to something else.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core import AdwiseConfig, available_strategies, run_partitioner, spotlight_partition
from repro_torch.engine import (
    PAPER_CLUSTER,
    build_partitioned_graph,
    coloring,
    label_propagation,
    pagerank,
    process_latency,
    triangle_count,
)
from repro_torch.graph import (
    GRAPH_PRESETS,
    make_graph,
    partition_balance,
    replica_sets_from_assignment,
    replication_degree,
    unassigned_count,
)

# Strategies that take AdwiseConfig-style knobs from the CLI.
_ADWISE_LIKE = ("adwise", "adwise-restream", "2ps")


def _unported(what: str, item: str) -> SystemExit:
    return SystemExit(
        f"repro_torch.launch.partition: {what} is not ported yet — "
        f"ROADMAP.md, port queue 1, {item}"
    )


def _adwise_cfg_kwargs(args) -> dict:
    return dict(window_max=args.window_max, latency_budget=args.budget,
                use_clustering=not args.no_cs)


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
                    help="generator preset (brain_like/orkut_like/web_like/...)")
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
                         "instances (auto — every registry strategy batches) "
                         "or the sequential per-instance loop")
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
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record a span timeline of the run (repro_torch.obs) "
                         "and write Chrome trace-event JSON here — open in "
                         "https://ui.perfetto.dev. Host-side only: no added "
                         "device syncs")
    args = ap.parse_args(argv)

    if args.graph not in GRAPH_PRESETS:
        if os.path.exists(args.graph):
            raise _unported("partitioning a graph file", "item 10 (out-of-core)")
        ap.error(f"unknown graph preset {args.graph!r}; presets: {', '.join(GRAPH_PRESETS)}")
    if args.strategy not in available_strategies():
        ap.error(f"unknown strategy {args.strategy!r}; "
                 f"available: {', '.join(available_strategies())}")

    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    edges, n = make_graph(args.graph, seed=args.seed, scale=args.scale)
    print(f"graph={args.graph} |V|={n} |E|={len(edges)} k={args.k}")
    res = run_partition(edges, n, args, trace=tracer)
    n_unassigned = unassigned_count(res.assign)
    rep = replica_sets_from_assignment(edges, res.assign, n, args.k, unassigned="drop")
    rd = replication_degree(rep)
    imb = partition_balance(res.assign, args.k, unassigned="drop")
    t_part = res.stats.get("wall_time_s", 0.0)
    print(f"partitioner={args.strategy} RD={rd:.3f} imbalance={imb:.4f} "
          f"unassigned={n_unassigned} partition_latency={t_part:.2f}s")
    out = dict(
        graph=args.graph, strategy=args.strategy, k=args.k, device=args.device,
        replication_degree=rd, imbalance=imb, unassigned=n_unassigned,
        partition_latency_s=t_part,
        stats={k: v for k, v in res.stats.items()
               if isinstance(v, (int, float, str))
               or (isinstance(v, list) and all(isinstance(x, (int, float)) for x in v))},
    )
    if args.workload != "none":
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
        n_events = tracer.export(args.trace)
        summ = tracer.summary()
        cats = ", ".join(
            f"{c}:{d['count']}x/{d['wall_s']:.3f}s"
            for c, d in sorted(summ.categories.items())
        )
        print(f"trace: {n_events} events -> {args.trace} "
              f"(wall={summ.wall_s:.3f}s; {cats})")
        out["trace"] = dict(path=args.trace, **summ.as_dict())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
