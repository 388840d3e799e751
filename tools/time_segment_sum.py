#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's ``segment_sum`` kernel at the engine's shapes.

    PYTHONPATH=<checkout>/src python3 tools/time_segment_sum.py [--label NAME]

Imports ``repro_torch`` from the path, so one run on one card can time
two checkouts in turn (A, B, B, A) with the same script; it uses only the
API both sides share (``segment_layout(seg, S, device)``,
``ops.segment_sum_sorted``). Shapes: the engine's message layout of the
brain_like graph at scale 1.0 (E = 704,942 rows, S = 40,000 segments, the
longest run 37,078 rows) at D = 1 (pagerank) and D = 256 (the triangle
round) in float32, the same in float16, and a hub-heavy synthetic (E =
1,048,576 rows, S = 40,000, four hubs of 131,072 rows) at D = 1. For each it
prints one JSON line: the kernel's device time per call (calls captured in
one CUDA graph, replayed three times, CUDA events), ``index_add_`` on the
same inputs, the bound (bytes / 3.35 TB/s), and the largest difference
from an fp64 sum. The card's name and power limit (nvidia-smi) come first.
It needs one CUDA card and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * 3)


def brain_like_segments() -> tuple[np.ndarray, int]:
    """The engine's destination-sorted message segments of brain_like."""
    from repro_torch.graph import make_graph

    edges, n = make_graph("brain_like", seed=0, scale=1.0)
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    return np.sort(dst, kind="stable").astype(np.int32), n


def hub_segments(rng) -> tuple[np.ndarray, int]:
    s, hub = 40_000, 131_072
    rest = rng.integers(0, s, 1_048_576 - 4 * hub)
    hubs = np.repeat(np.array([7, 9_000, 20_011, 39_999]), hub)
    return np.sort(np.concatenate([rest, hubs])).astype(np.int32), s


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="", help="a name for the checkout, echoed in each line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_segment_sum: no CUDA card")
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_sum import segment_layout

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    brain = brain_like_segments()
    cases = [("brain_like D=1", brain, 1, torch.float32),
             ("brain_like D=256", brain, 256, torch.float32),
             ("hub-heavy D=1", hub_segments(rng), 1, torch.float32),
             ("brain_like D=1 f16", brain, 1, torch.float16),
             ("brain_like D=256 f16", brain, 256, torch.float16)]
    for tag, (seg, s), d, dtype in cases:
        lay = segment_layout(seg, s, dev)
        e = len(seg)
        data = torch.as_tensor(rng.normal(size=(e, d)).astype(np.float32)).to(device=dev, dtype=dtype)
        idx = torch.as_tensor(seg, device=dev).long()
        exact = torch.zeros((s, d), dtype=torch.float64, device=dev).index_add_(0, idx, data.double())
        got = ops.segment_sum_sorted(data, lay)
        diff = (got.double() - exact).abs().max().item()
        iters = 20 if d > 1 else 200
        ms = cuda_ms(lambda: ops.segment_sum_sorted(data, lay), iters)
        lib = cuda_ms(lambda: torch.zeros((s, d), dtype=torch.float32, device=dev)
                      .index_add_(0, idx, data.float()), iters)
        nbytes = e * d * data.element_size() + (s + 1) * 4 + s * d * 4
        print(json.dumps(dict(label=args.label, shape=tag, E=e, S=s, D=d, dtype=str(dtype)[6:],
                              ms=ms, index_add_ms=lib, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                              max_abs_diff_vs_fp64=diff)), flush=True)
        del data, exact, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
