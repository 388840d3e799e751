#!/usr/bin/env python3
"""Time the collectives of the port's tensor-parallel serving on the card.

    PYTHONPATH=src python3 tools/time_collectives.py

Two gloo ranks on cuda:0 (what ``chip_smoke.py`` phase 14 runs: NCCL
refuses two ranks on one device), then one NCCL rank, and two NCCL ranks
on cuda:0-1 when there are two cards. Each group checks ``all_reduce``
(sum, max) and the list form of ``all_gather`` on CUDA tensors in fp32
and bf16, then times ``all_reduce`` (sum) of a decode-sized tensor
(4 x 3,072) and of a prefill-sized one (4 x 512 x 3,072 fp32), host
clock around calls ended by a device synchronise. Prints the card's name
and power limit first, and one line per group.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

SIZES = [(4 * 3072, "float32", 50), (4 * 3072, "bfloat16", 50), (4 * 512 * 3072, "float32", 5)]


def rank_fn(rank, backend, store):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh

    _, world, dev = mesh.init_ranks(backend, torch.device("cuda"), f"file://{store}")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for op, red in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX)):
            x = torch.full((4, 5), float(rank + 1), device=dev, dtype=dtype)
            dist.all_reduce(x, op=red)
            want = sum(range(1, world + 1)) if op == "sum" else world
            out[f"all_reduce_{op}_{dtype}"] = float(x[0, 0]) == want
        parts = [torch.empty(3, device=dev, dtype=dtype) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev, dtype=dtype))
        out[f"all_gather_{dtype}"] = [float(p[0]) for p in parts] == list(range(world))
    for n, dtype, reps in SIZES:
        x = torch.ones(n, device=dev, dtype=getattr(torch, dtype))
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out[f"ms all_reduce {n} {dtype}"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def main() -> int:
    import torch

    from repro_torch.launch import mesh

    if not torch.cuda.is_available():
        print("time_collectives: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    groups = [("gloo", 2), ("nccl", 1)]
    if torch.cuda.device_count() >= 2:
        groups.append(("nccl", 2))
    stores = os.path.join(HERE, "..", "build", "time_collectives")
    os.makedirs(stores, exist_ok=True)
    for backend, world in groups:
        store = os.path.join(stores, f"{backend}-{world}")
        if os.path.exists(store):
            os.remove(store)
        res = mesh.spawn(rank_fn, world, (backend, store), timeout=300)
        cards = min(world, torch.cuda.device_count())
        print(f"{backend} world {world} on {cards} card(s): rank 0 {res[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
