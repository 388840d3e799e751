#!/usr/bin/env python3
"""Time a partitioner of the port on the card, for A/B runs across checkouts.

    PYTHONPATH=<checkout>/src python3 tools/time_partition.py --label NAME \
        [--strategy adwise] [--scale 0.1] [--reps 2] [--z 8 --spread 4]

Runs ``repro_torch.core.registry.run_partitioner`` on the ``brain_like``
preset (k = 32, window_max = 256 for the ADWISE family) once to warm up and
``--reps`` times more on the card, and prints one line per run: the wall,
the set-up (upload, step build, graph capture) and the µs per step of the
replayed loop. With ``--z N`` (N > 1) it runs
``repro_torch.core.spotlight_partition`` instead: N instances on blocks of
``--spread`` partitions, one batched step for all of them. The card's name and power limit come first. Run it once per
checkout in one call (parent, change, change, parent) to compare two
versions on one card; it reads whichever ``repro_torch`` is on
``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--strategy", default="adwise")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--z", type=int, default=1, help="spotlight instances (1: none)")
    ap.add_argument("--spread", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_partition: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import registry
    from repro_torch.graph import make_graph

    def run(edges, n, cfg):
        if args.z > 1:
            from repro_torch.core import AdwiseConfig, spotlight_partition

            adwise = args.strategy == "adwise"
            return spotlight_partition(
                edges, n, 32, z=args.z, spread=args.spread, strategy=args.strategy,
                cfg=AdwiseConfig(k=32, **cfg) if adwise else None,
                strategy_cfg=None if adwise or not cfg else cfg, device="cuda")
        return registry.run_partitioner(args.strategy, edges, n, 32, device="cuda", **cfg)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    edges, n = make_graph("brain_like", seed=0, scale=args.scale)
    cfg = dict(window_max=256) if args.strategy in ("adwise", "adwise-restream", "2ps") else {}
    spot = f" z={args.z} spread={args.spread}" if args.z > 1 else ""
    print(f"{args.label}: {card}; {args.strategy} brain_like scale={args.scale} "
          f"m={len(edges)} k=32{spot} {cfg}", flush=True)
    for rep in range(args.reps + 1):
        res = run(edges, n, cfg)
        torch.cuda.synchronize()
        st = res.stats
        steps = st.get("steps_run", 0)
        loop = st["wall_time_s"] - st.get("setup_s", 0.0)
        per = f"{loop / steps * 1e6:.2f}" if steps else "n/a"
        print(f"{args.label} {'warm-up' if rep == 0 else f'run {rep}'}: "
              f"wall_s={st['wall_time_s']:.3f} setup_s={st.get('setup_s', 0.0):.3f} "
              f"steps={steps} us_per_step={per}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
