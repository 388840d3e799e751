"""Gradient compression for data-parallel reduction: top-k with error
feedback (counterpart of ``repro.optim.compress``).

Per leaf of the JAX tree, the gradient plus the carried residual keeps its
⌊ρ·n⌋ (at least one) largest magnitudes — every element at or above the
k-th largest, so ties at the threshold are all kept, as ``jax.lax.top_k``'s
threshold keeps them — and the rest goes back into the residual (error
feedback). The port's per-layer parameters of one stacked JAX leaf
(``blocks.<i>.attn.wq`` for i = 0..L-1) are selected together, over all
their layers, as JAX selects over the stacked leaf. On one device the
reduction is the identity: a reduction group (the JAX function's
``axis_name``) belongs to data-parallel training, which is not ported, and
raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models.names import jax_leaves

__all__ = ["topk_compress_allreduce"]


@torch.no_grad()
def topk_compress_allreduce(
    grads: Mapping[str, torch.Tensor],
    residual: Dict[str, torch.Tensor],
    group=None,
    ratio: float = 0.05,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (selected fp32 gradients, residual). The residual (fp32, one
    tensor per leaf) is updated **in place** and returned."""
    if group is not None:
        raise NotImplementedError(
            "repro_torch.optim.topk_compress_allreduce: a reduction group (data-parallel "
            "training) is not ported; see ROADMAP.md port queue 1, item 15c"
        )
    out = {}
    for names in jax_leaves(grads).values():
        gs = {n: grads[n].float() + residual[n] for n in names}
        size = sum(g.numel() for g in gs.values())
        k = max(1, int(ratio * size))
        if k < size:
            mag = torch.cat([g.abs().reshape(-1) for g in gs.values()])
            thresh = torch.topk(mag, k, sorted=False).values.min()
            del mag
        for n, g in gs.items():
            sel = g if k >= size else torch.where(g.abs() >= thresh, g, 0.0)
            torch.sub(g, sel, out=residual[n])
            out[n] = sel
    return out, residual
