"""Graph partition→process launcher of the port — the paper's pipeline.

    PYTHONPATH=src python -m repro_torch.launch.partition --graph brain_like \
        --scale 1.0 --k 32 --device cuda

Runs: a generator preset → stream partitioning (a strategy of
``repro_torch.core.registry``) → vertex-cut engine build → workload → total
latency report (partitioning wall-clock + modeled cluster processing
latency), printing the same lines as the JAX package's
``repro.launch.partition``. ``--device`` picks ``cuda`` (default) or ``cpu``.

What this slice does not port exits with a message that names its
ROADMAP.md item, and never falls through to something else: ``--z``/
``--parallel`` > 1 (spotlight), a graph file path (out-of-core), and the
strategies still to be ported.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core import available_strategies, run_partitioner
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

# Strategies of the JAX package this slice has not ported, with their
# ROADMAP.md item (port queue 1).
_NOT_PORTED = {
    "hdrf": "item 7 (HDRF/Greedy step-cores)",
    "greedy": "item 7 (HDRF/Greedy step-cores)",
    "adwise-restream": "item 9 (re-streaming)",
    "2ps": "item 9 (re-streaming)",
    "2ps-l": "item 9 (re-streaming)",
}


def _unported(what: str, item: str) -> SystemExit:
    return SystemExit(
        f"repro_torch.launch.partition: {what} is not ported yet — "
        f"ROADMAP.md, port queue 1, {item}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="brain_like",
                    help="generator preset (brain_like/orkut_like/web_like/...)")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--strategy", default="adwise",
                    help=f"one of {', '.join(available_strategies())}")
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--parallel", "--z", type=int, default=1, dest="parallel",
                    help="z partitioner instances (spotlight; not ported)")
    ap.add_argument("--budget", type=float, default=None, help="latency preference L (s)")
    ap.add_argument("--window-max", type=int, default=256)
    ap.add_argument("--no-cs", action="store_true", help="disable clustering score")
    ap.add_argument("--oracle", action="store_true", help="sequential reference impl")
    ap.add_argument("--workload", default="pagerank",
                    choices=["pagerank", "coloring", "wcc", "triangles", "none"])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.parallel > 1:
        raise _unported("--z/--parallel > 1 (spotlight)", "item 8 (spotlight)")
    if args.graph not in GRAPH_PRESETS:
        if os.path.exists(args.graph):
            raise _unported("partitioning a graph file", "item 10 (out-of-core)")
        ap.error(f"unknown graph preset {args.graph!r}; presets: {', '.join(GRAPH_PRESETS)}")
    if args.strategy in _NOT_PORTED:
        raise _unported(f"strategy {args.strategy!r}", _NOT_PORTED[args.strategy])
    if args.strategy not in available_strategies():
        ap.error(f"unknown strategy {args.strategy!r}; "
                 f"available: {', '.join(available_strategies())}")

    edges, n = make_graph(args.graph, seed=args.seed, scale=args.scale)
    print(f"graph={args.graph} |V|={n} |E|={len(edges)} k={args.k}")
    cfg = {}
    if args.strategy == "adwise":
        cfg = dict(window_max=args.window_max, latency_budget=args.budget,
                   use_clustering=not args.no_cs, oracle=args.oracle)
    res = run_partitioner(args.strategy, edges, n, args.k, seed=args.seed,
                          device=args.device, **cfg)
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
        stats={k: v for k, v in res.stats.items() if isinstance(v, (int, float, str))},
    )
    if args.workload != "none":
        g = build_partitioned_graph(edges, res.assign, n, args.k, device=args.device)
        t0 = time.perf_counter()
        if args.workload == "pagerank":
            _, info = pagerank(g, iters=min(args.iters, 30))
            info["supersteps"] = args.iters
        elif args.workload == "coloring":
            _, info = coloring(g)
        elif args.workload == "wcc":
            _, info = label_propagation(g)
        else:
            _, info = triangle_count(g)
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
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
