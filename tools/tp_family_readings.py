#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 16's tolerances, on the card.

    python3 tools/tp_family_readings.py

Runs phase 16 (``chip_smoke.phase_tp_families``: whisper-tiny, rwkv6-7b
cut to 4 layers and zamba2-7b cut to 13 at full width, bf16, tp 2 as two
gloo ranks on cuda:0 against tp 1; then 2 full-width layers of each in
fp32) once per variant below, each in a process of its own, with every
check logged instead of raised, and prints the phase's readings and the
checks that failed under each. A variant is a change made at run time in
the ranks (the code on disk is not touched; tp 1 runs as it is):

  sound           — the port as it is
  norm_unsummed   — a fault: the norms over split channels (RWKV-6's
                    ``ln_x``, Mamba-2's gated norm) take the rank's own
                    sum of squares, not the model group's
  gate_rank0      — a fault: every rank of RWKV-6's channel mix gates
                    rank 0's columns of the summed ``kk @ wv``
  merge_unscaled  — a fault: the decode merge (self- and cross-attention)
                    without its rescale exp(m_r - M) (the max all-reduce
                    skipped)

Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

VARIANTS = ("sound", "norm_unsummed", "gate_rank0", "merge_unscaled")
ENV = "TP_FAMILY_VARIANT"


def install(variant: str) -> None:
    """Makes ``variant``'s change in this process (at import, so that the
    ranks phase 16 spawns, which import this module as their main, make it
    too)."""
    import torch

    from repro_torch.models import layers, ssm
    from repro_torch.models.tp import Shard

    if variant == "norm_unsummed":
        ssm.rms_norm_tp = lambda x, gamma, shard, width, eps=1e-6: layers.rms_norm(x, gamma, eps)
    elif variant == "gate_rank0":
        real = ssm.rwkv6_channel_mix

        def channel_mix(params, x, last_x=None, shard=layers.NO_SHARD, d_ff=None):
            if shard.tp == 1:
                return real(params, x, last_x, shard, d_ff)
            xx = ssm._token_shift(x, last_x)
            xk = x + (xx - x) * params["mu"][0]
            xr = x + (xx - x) * params["mu"][1]
            kv = layers._row_split_product(torch.square(torch.relu(xk @ params["wk"])),
                                           params["wv"], shard)
            r = torch.sigmoid(xr @ params["wr"])
            return shard.all_gather(r * kv[..., :r.shape[-1]], -1), x[:, -1]

        ssm.rwkv6_channel_mix = channel_mix
    elif variant == "merge_unscaled":
        real_reduce = Shard.all_reduce
        Shard.all_reduce = lambda self, x, op="sum": x if op == "max" else real_reduce(self, x, op)
    elif variant != "sound":
        raise ValueError(variant)


if os.environ.get(ENV):
    install(os.environ[ENV])


def run_variant(variant: str) -> int:
    """Phase 16 under ``variant`` in this process, checks logged."""
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []

    def check(cond, what):
        if not cond:
            failed.append(what)
            print(f"{variant}: CHECK FAILED: {what}", flush=True)
        smoke.CHECKS.append(what)

    smoke.check = check
    _build.build()
    smoke.phase_tp_families()
    print(f"{variant}: {len(failed)} of {len(smoke.CHECKS)} checks failed", flush=True)
    return 0


def main() -> int:
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("tp_family_readings: needs a CUDA device", file=sys.stderr)
        return 1
    if os.environ.get(ENV):
        return run_variant(os.environ[ENV])
    print(smoke.card_line(), flush=True)
    for variant in VARIANTS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                              env=dict(os.environ, **{ENV: variant}))
        if proc.returncode:
            print(f"{variant}: exited {proc.returncode}", flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
