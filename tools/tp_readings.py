#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 14's tolerances, on the card.

    python3 tools/tp_readings.py

Serves llama3.2-3b and granite-moe-1b-a400m at full width (bf16, batch 4,
prompt 512, 8 tokens: phase 14's runs) at tp 1 in this process, then at
tp 2 as two gloo ranks on cuda:0 under each variant below, and prints for
each run how far it lies from tp 1 as phase 14 measures it
(``chip_smoke.tp_diff``: logits per step against their scale, the first MoE
layer's input, routes and output, the routes of the later layers), beside
its prefill and decode walls. A variant is a change made at run time in
the ranks (the code on disk is not touched):

  sound           — the port as it is
  parent_product  — the row-split products as fp32 GEMMs of fp32 copies of
                    both operands (the port before it took cuBLAS's fp32
                    result of the 16-bit GEMM); timed against ``sound``
  row_sum_bf16    — each rank's partial product rounded to bf16 and the
                    bf16 partials summed (GSPMD's rounding of a row split)
  merge_unscaled  — a fault: decode's softmax merge without the rescale
                    exp(m_r - M) (the max all-reduce skipped)
  ep_no_combine   — a fault: the MoE's combine not summed over the ranks
  ep_wrong_rows   — a fault: each rank runs its experts on the other
                    rank's capacity rows

Then times the row-split product alone at llama's tp 2 shapes (CUDA
events): the 16-bit GEMM into an fp32 result, the fp32 GEMM of fp32 copies,
and the one-device bf16 GEMM. Prints the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (phase 14's runs and measures)

LLAMA, GRANITE = smoke.TP_RUNS
# variant -> the archs it is read on, in the order the variants run (the
# product A/B as sound, parent, ..., parent, sound)
VARIANTS = [
    ("sound", (LLAMA, GRANITE)),
    ("parent_product", (LLAMA, GRANITE)),
    ("row_sum_bf16", (LLAMA, GRANITE)),
    ("merge_unscaled", (LLAMA,)),
    ("ep_no_combine", (GRANITE,)),
    ("ep_wrong_rows", (GRANITE,)),
    ("parent_product", (LLAMA, GRANITE)),
    ("sound", (LLAMA, GRANITE)),
]


def install(variant: str) -> None:
    """Makes ``variant``'s change in this process."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models.tp import Shard

    if variant == "parent_product":
        layers._fp32_product = lambda a, w: torch.matmul(a.float(), w.float())
    elif variant == "row_sum_bf16":
        layers._row_split_product = lambda a, w, shard: shard.all_reduce(torch.matmul(a, w))
    elif variant == "merge_unscaled":
        real = Shard.all_reduce
        Shard.all_reduce = lambda self, x, op="sum": x if op == "max" else real(self, x, op)
    elif variant in ("ep_no_combine", "ep_wrong_rows"):
        real_moe, real_reduce = layers.moe_ffn, Shard.all_reduce
        inside = []

        def moe(params, x, shard=None, **kw):
            if variant == "ep_wrong_rows":
                coords = tuple(1 - c if a == "model" else c
                               for a, c in zip(shard.mesh.axis_names, shard.coords))
                return real_moe(params, x, shard=dataclasses.replace(shard, coords=coords), **kw)
            inside.append(1)
            try:
                return real_moe(params, x, shard=shard, **kw)
            finally:
                inside.pop()

        layers.moe_ffn = moe
        Shard.all_reduce = lambda self, x, op="sum": x if inside else real_reduce(self, x, op)
    elif variant != "sound":
        raise ValueError(variant)


def variant_rank(rank, variant, argvs):
    install(variant)
    return smoke.tp_serve(argvs)


def time_products() -> None:
    import torch

    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, m, k in (("prefill wo", 4 * 512, 1536), ("prefill w_down", 4 * 512, 4096),
                       ("decode wo", 4, 1536), ("decode w_down", 4, 4096)):
        a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, 3072, generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
        new, old = layers._fp32_product(a, w), torch.matmul(a.float(), w.float())
        err = float((new - old).abs().max()) / float(old.abs().max())
        ms = {name: smoke.cuda_ms(fn) for name, fn in (
            ("bf16 GEMM, fp32 result", lambda: layers._fp32_product(a, w)),
            ("fp32 GEMM of fp32 copies", lambda: torch.matmul(a.float(), w.float())),
            ("bf16 GEMM, bf16 result (tp 1)", lambda: a @ w))}
        print(f"product {what} ({m} x {k} @ {k} x 3072): "
              + ", ".join(f"{n} {v:.5f} ms" for n, v in ms.items())
              + f"; fp32 results differ by {err:.2e} of their scale", flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as meshes

    if not torch.cuda.is_available():
        print("tp_readings: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line(), flush=True)
    _build.build()
    time_products()
    base = {arch: ["--arch", arch] + smoke.TP_ARGS for arch in smoke.TP_RUNS}
    ref = dict(zip(smoke.TP_RUNS, smoke.tp_serve([base[a] for a in smoke.TP_RUNS])))
    steps = smoke.TP_GEN - 1
    for variant, archs in VARIANTS:
        t0 = time.perf_counter()
        argvs = [base[a] + ["--tp", "2", "--dist-backend", "gloo", "--dist-init",
                            f"file://{smoke.tp_store('readings-' + a)}"] for a in archs]
        ranks = meshes.spawn(variant_rank, 2, (variant, argvs), timeout=smoke.TP_TIMEOUT)
        for i, arch in enumerate(archs):
            got = ranks[0][i]
            info = got[1]
            d = smoke.tp_diff(ref[arch], got)
            worst = max(d["errs"], default=float("nan")) / d["scale"]
            print(f"{variant} {arch}: prefill_ms={info['prefill_s'] * 1e3:.3f} "
                  f"decode_ms_per_step={info['decode_s'] / steps * 1e3:.3f} "
                  f"worst logits err / scale={worst:.5f}; {smoke.tp_diff_line(d)}", flush=True)
        print(f"{variant}: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
