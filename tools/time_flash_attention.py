#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's ``flash_attention`` kernel at its serving shapes.

    PYTHONPATH=<checkout>/src python3 tools/time_flash_attention.py [--label NAME]

Imports ``repro_torch`` from the path, so one session on one card can time
two checkouts in turn (A, B, B, A) with the same script. For each shape
(bf16, causal, inputs from a seed) it prints one JSON line: the kernel's
device time per call (50 or 10 calls captured in one CUDA graph, replayed
three times, CUDA events), the same for PyTorch's
``scaled_dot_product_attention`` on the same inputs, and the largest
difference between the two outputs. The card's name and power limit
(nvidia-smi) come first. It needs one CUDA card and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

# b, hq, hkv, tq, tk, dh
SHAPES = {
    "serve": (4, 24, 8, 2048, 2048, 128),
    "serve Dh=64": (4, 24, 8, 2048, 2048, 64),
    "ragged": (1, 24, 8, 2000, 2000, 128),
    "long": (1, 24, 8, 8192, 8192, 128),
}


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="", help="a name for the checkout, echoed in each line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_attention: no CUDA card")
        return 1
    from repro_torch.kernels import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(12)
    for tag, (b, hq, hkv, tq, tk, dh) in SHAPES.items():
        q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32))
                   .to(device="cuda", dtype=torch.bfloat16)
                   for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
        iters = 10 if tq >= 4096 else 50
        got = ops.flash_attention(q, k, v, causal=True)
        want = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        diff = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True), iters)
        print(json.dumps(dict(label=args.label, shape=tag, q=[b, hq, tq, dh], kv=[b, hkv, tk, dh],
                              ms=ms, sdpa_ms=sdpa, max_abs_diff_vs_sdpa=diff)), flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
