"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule — the JAX package's ``optim/adamw.py`` arithmetic, in torch.

The parameters, gradients and moments are flat mappings from a parameter
name (``LM.named_parameters()``: ``embed``, ``blocks.3.attn.wq``, ...) to a
tensor. The moments are fp32 whatever the parameter dtype; ``step`` is a
0-dim int32 tensor on the parameters' device, so the schedule and the bias
corrections run on the device with no host sync.

:func:`adamw_update` updates the parameters and the state **in place**
(the JAX function returns new trees; the port has no donation, and a copy
of the moments would not fit beside them at full width). Per leaf it keeps
JAX's operation order, each product rounded to fp32 on its own: g·scale;
m = b1·m + (1−b1)·g; v = b2·v + ((1−b2)·g)·g; bias correction by b**step
in fp32; delta = m̂/(√v̂ + eps) + wd·p; p − lr·delta in fp32, cast back to
the parameter dtype. ``torch.optim.AdamW`` applies the decay as a separate
multiply first and would round differently.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models.names import jax_leaves
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "global_norm"]

Tree = Mapping[str, torch.Tensor]


def adamw_init(params: Tree) -> Dict[str, object]:
    """dict(m, v, step): fp32 zero moments per parameter, step 0."""
    dev = next(iter(params.values())).device
    f32 = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
    return dict(
        m=f32,
        v={n: torch.zeros_like(t) for n, t in f32.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree: Tree, shard: Shard = NO_SHARD) -> torch.Tensor:
    """√(Σ x²) over every leaf, in fp32, the leaves added in the order of
    JAX's tree (a stacked ``blocks`` leaf is the sum of its layers).

    Under a ``shard`` of more than one rank the tree holds this rank's
    pieces (``shard.param_spec``): each JAX leaf's squares are summed over
    the rank's pieces that it counts (a piece held by several ranks is
    counted by one, ``Shard.counted``), the per-leaf sums are summed over
    every rank in one all-reduce, then added in the tree's order."""
    groups = jax_leaves(tree).values()
    if shard.mesh.size == 1:
        return torch.sqrt(sum(
            sum(torch.sum(torch.square(tree[n].float())) for n in group) for group in groups))
    dev = next(iter(tree.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sums = torch.stack([
        sum((torch.sum(torch.square(tree[n].float())) if shard.counted(n) else zero
             for n in group), zero)
        for group in groups])
    sums = shard.world_sum(sums)
    return torch.sqrt(sum(sums.unbind()))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up over ``warmup`` steps, then a cosine to 0 at
    ``total``; fp32, on the device of ``step`` (an int or a tensor)."""

    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)

    return lr


@torch.no_grad()
def adamw_update(
    grads: Tree,
    state: Dict[str, object],
    params: Tree,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    shard: Shard = NO_SHARD,
) -> Tuple[Tree, Dict[str, object]]:
    """One AdamW step, in place on ``params`` and ``state``; returns them.

    ``lr`` is a float or a 0-dim tensor (see :func:`cosine_schedule`). The
    update runs inside a profiler range named ``adamw_update``. Under a
    ``shard`` every tree holds this rank's pieces, laid out alike
    (``launch.sharding.opt_specs``): the clip reads the whole tree's norm
    (:func:`global_norm`), and each piece is updated where it lies; the
    ``step`` counter is replicated."""
    with torch.profiler.record_function("adamw_update"):
        step = state["step"]
        step.add_(1)
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        gnorm = global_norm(grads, shard)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        for name, p in params.items():
            m, v = state["m"][name], state["v"][name]
            g = grads[name].float() * scale
            m.mul_(b1).add_(g * (1 - b1))
            gg = g * (1 - b2)
            gg.mul_(g)
            del g
            v.mul_(b2).add_(gg)
            del gg
            delta = m / bc1
            vh = v / bc2
            delta.div_(vh.sqrt_().add_(eps))
            del vh
            pf = p.float()
            delta.add_(pf * weight_decay)
            p.copy_(pf - delta.mul_(lr))
    return params, state
