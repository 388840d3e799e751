#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 17's tolerances, on the card.

    python3 tools/tp_train_readings.py

Runs phase 17 (``chip_smoke.phase_tp_train``: Llama-3.2-3B cut to 2 layers
and whisper-tiny in bf16, granite-moe cut to 2 layers in fp32, two
full-width fp32 layers of llama, granite and internvl, and rwkv6 (1
layer), zamba2 (3) and whisper (4 + 4) in fp32, each trained over two
gloo ranks on cuda:0 at meshes (1, 2) and (2, 1) against tp 1) once per
variant below,
each in a process of its own, with every check logged instead of raised,
and prints the phase's readings and the checks that failed under each. A
variant is a change made at run time in the ranks (the code on disk is not
touched; tp 1 runs as it is):

  sound             — the port as it is
  enter_unsummed    — a fault: ``Shard.enter`` (a whole tensor entering
                      split compute) keeps the rank's partial gradient,
                      not the model group's sum
  scatter_unsummed  — a fault: the FSDP gathers' backward keeps the rank's
                      own chunk of its gradient, not the data group's sum
  grads_unreduced   — a fault: ``lm.reduce_grads`` does nothing (the
                      leaves FSDP leaves whole keep the rank's rows'
                      gradient)
  plan_per_rank     — a repaired fault: the MoE plans over the
                      rank's rows only (``Shard.gather_rows`` the identity)
  moments_misplaced — a fault of AdamW on pieces: rank 1's moments lie one
                      row off their piece (rolled by one along their first
                      dim before each update), as a layout that placed
                      them at another piece's rows would leave them; the
                      first step reads zeros, the second the wrong rows
  norm_overcounted  — a fault of AdamW's ``global_norm`` on pieces: every
                      rank counts its piece of every leaf (``Shard.counted``
                      True inside it), so a piece that several ranks hold
                      is counted several times in the clip's norm
  norm_unentered    — a fault of a norm over split channels (RWKV-6's
                      ``ln_x``, Mamba-2's gated norm): the summed squares'
                      gradient reaches each rank's own squares unsummed
                      over the model group (``layers.rms_norm_tp`` without
                      its ``Shard.enter``)

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

VARIANTS = ("sound", "enter_unsummed", "scatter_unsummed", "grads_unreduced", "plan_per_rank",
            "moments_misplaced", "norm_overcounted", "norm_unentered")
ENV = "TP_TRAIN_VARIANT"


def install(variant: str) -> None:
    """Makes ``variant``'s change in this process (at import, so that the
    ranks phase 17 spawns, which import this module as their main, make it
    too)."""
    from repro_torch.models import lm, tp

    if variant == "enter_unsummed":
        tp.Shard.enter = lambda self, x: x
    elif variant == "scatter_unsummed":
        def own_row(shard, buf):
            shard._count("data_reduce_scatter", buf)
            return buf[shard.data_rank].clone()

        tp._reduce_scatter = own_row
    elif variant == "grads_unreduced":
        lm.reduce_grads = lambda model, shard: None
    elif variant == "plan_per_rank":
        tp.Shard.gather_rows = lambda self, x: x
        tp.Shard.row_offset = lambda self, n_local: 0
    elif variant == "moments_misplaced":
        import torch
        import torch.distributed as dist

        from repro_torch.launch import train
        from repro_torch.optim import adamw

        real = adamw.adamw_update

        def misplaced(grads, state, params, lr, **kw):
            shard = kw.get("shard", tp.NO_SHARD)
            if shard.mesh.size > 1 and dist.get_rank() == 1:
                with torch.no_grad():
                    for tree in (state["m"], state["v"]):
                        for t in tree.values():
                            t.copy_(t.roll(1, 0))
            return real(grads, state, params, lr, **kw)

        train.adamw_update = adamw.adamw_update = misplaced
    elif variant == "norm_overcounted":
        from repro_torch.optim import adamw

        real_norm, real_counted = adamw.global_norm, tp.Shard.counted

        def overcounted(tree, shard=tp.NO_SHARD):
            tp.Shard.counted = lambda self, name: True
            try:
                return real_norm(tree, shard)
            finally:
                tp.Shard.counted = real_counted

        adamw.global_norm = overcounted
    elif variant == "norm_unentered":
        import torch

        from repro_torch.models import layers, ssm

        def unentered(x, gamma, shard, width, eps=1e-6):
            if shard.tp == 1 or x.shape[-1] == width:
                return layers.rms_norm(x, gamma, eps)
            xf = x.float()
            sq = shard.all_reduce((xf * xf).sum(dim=-1, keepdim=True))
            return (xf * torch.rsqrt(sq / width + eps)).to(x.dtype) * gamma

        layers.rms_norm_tp = ssm.rms_norm_tp = unentered
    elif variant != "sound":
        raise ValueError(variant)


if os.environ.get(ENV):
    install(os.environ[ENV])


def run_variant(variant: str) -> int:
    """Phase 17 under ``variant`` in this process, checks logged."""
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
    smoke.phase_tp_train()
    print(f"{variant}: {len(failed)} of {len(smoke.CHECKS)} checks failed", flush=True)
    return 0


def main() -> int:
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("tp_train_readings: needs a CUDA device", file=sys.stderr)
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
