"""Gradient compression for data-parallel reduction: top-k with error
feedback (counterpart of ``repro.optim.compress``).

Per leaf of the JAX tree, the gradient plus the carried residual keeps its
⌊ρ·n⌋ (at least one) largest magnitudes — every element at or above the
k-th largest, so ties at the threshold are all kept, as ``jax.lax.top_k``'s
threshold keeps them — and the rest goes back into the residual (error
feedback). The port's per-layer parameters of one stacked JAX leaf
(``blocks.<i>.attn.wq`` for i = 0..L-1) are selected together, over all
their layers, as JAX selects over the stacked leaf.

The reduction, as the JAX function's ``axis_name`` decides it:

* a process ``group`` (JAX's ``axis_name``, inside ``shard_map`` or
  ``pmap``): each rank selects on its own gradient and residual, then the
  selections are averaged over the group (``pmean``);
* no group (JAX's ``None``: the launcher's path, after GSPMD's implicit
  reduction): the gradients are already reduced. On one device only the
  selection runs. Under a ``shard`` of more than one rank the gradients
  and the residual are this rank's pieces of each leaf (the train layout),
  and a leaf is selected as the whole leaf is: each rank offers its
  pieces' top min(k, n) magnitudes, the offers of the ranks that hold
  distinct pieces are gathered over the mesh (a repeated piece offers
  nothing), and the k-th largest of them is the whole leaf's threshold.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.names import jax_leaves
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = ["topk_compress_allreduce"]


def _threshold(gs: Dict[str, torch.Tensor], k: int, shard: Shard) -> torch.Tensor:
    """The k-th largest magnitude of a whole leaf whose pieces here are
    ``gs``."""
    mag = torch.cat([g.abs().reshape(-1) for g in gs.values()])
    if shard.mesh.size > 1:
        top = torch.topk(mag, min(k, mag.numel()), sorted=False).values
        if not shard.counted(next(iter(gs))):
            top.fill_(-1.0)  # a repeated piece: every magnitude is >= 0, so never chosen
        mag = shard.world_gather(top)
    return torch.topk(mag, k, sorted=False).values.min()


@torch.no_grad()
def topk_compress_allreduce(
    grads: Mapping[str, torch.Tensor],
    residual: Dict[str, torch.Tensor],
    group=None,
    ratio: float = 0.05,
    shard: Shard = NO_SHARD,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (selected fp32 gradients, residual). The residual (fp32, one
    tensor per leaf, laid out like its parameter) is updated **in place**
    and returned. ``group``: a ``torch.distributed`` process group over
    which the selections are averaged (``dist.group.WORLD`` for every
    rank); ``shard``: the layout of sharded gradients (no group then)."""
    if group is not None and not dist.is_initialized():
        raise ValueError("repro_torch.optim.topk_compress_allreduce: a reduction group needs an "
                         "initialised process group")
    if group is not None and shard.mesh.size > 1:
        raise ValueError("repro_torch.optim.topk_compress_allreduce: a reduction group averages "
                         "whole gradients; sharded ones are reduced already (pass no group)")
    out = {}
    for names in jax_leaves(grads).values():
        gs = {n: grads[n].float() + residual[n] for n in names}
        local = sum(g.numel() for g in gs.values())
        size = shard.whole_numel(names[0], local) if shard.mesh.size > 1 else local
        k = max(1, int(ratio * size))
        if k < size:
            thresh = _threshold(gs, k, shard)
        for n, g in gs.items():
            sel = g if k >= size else torch.where(g.abs() >= thresh, g, 0.0)
            torch.sub(g, sel, out=residual[n])
            if group is not None:
                dist.all_reduce(sel, group=group)
                sel = sel / dist.get_world_size(group)
            out[n] = sel
    return out, residual
