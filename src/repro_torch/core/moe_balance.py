"""ADWISE-style adaptive balancing applied to MoE token routing (the port's
copy of ``repro.core.moe_balance``).

The paper's partitioner balances edge→partition assignment with an
adaptive weight λ(ι, α)·B(p) (Eq. 3/4) instead of a fixed balance
coefficient. The token→expert assignment of a capacity-constrained MoE is
the same bipartite streaming-assignment problem: tokens ≙ edges, experts ≙
partitions, dropped tokens ≙ imbalance cost, router score ≙ replication
score.

:func:`adwise_router_bias` keeps running expert loads across steps and
returns the additive bias λ·B(e) for the router logits
(``repro_torch.models.layers.moe_ffn(router_bias=...)``):

  B(e) = (maxload − load_e) / (maxload − minload + ε)            (Eq. 3)
  λ   += (ι − tolerance(α)),  clipped to [λ_lo, λ_hi]            (Eq. 4)

with ι the current load imbalance and α the fraction of the training
horizon elapsed. The same fp32 operations as the JAX package, on tensors of
the state's device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import compat

__all__ = ["MoeBalanceState", "init_moe_balance", "adwise_router_bias", "update_loads",
           "LOAD_EMA"]


class MoeBalanceState(NamedTuple):
    loads: torch.Tensor  # (E,) f32: the routed-token estimate per expert
    lam: torch.Tensor  # () f32


def init_moe_balance(n_experts: int, lam_init: float = 1.0, device=None) -> MoeBalanceState:
    """Zero loads and λ = ``lam_init`` on ``device`` (default ``cuda``)."""
    dev = compat.resolve_device(device)
    return MoeBalanceState(
        loads=torch.zeros((n_experts,), dtype=torch.float32, device=dev),
        lam=torch.tensor(lam_init, dtype=torch.float32, device=dev),
    )


LOAD_EMA = 0.65  # responsiveness of the load estimate (distribution drift)


def adwise_router_bias(
    state: MoeBalanceState,
    progress: torch.Tensor | float,  # in [0, 1]: step / total_steps (the α analogue)
    eps: float = 0.01,
    lam_lo: float = 0.4,
    lam_hi: float = 5.0,
) -> Tuple[torch.Tensor, MoeBalanceState]:
    """Returns (router bias (E,), state with the updated λ). Call
    :func:`update_loads` after the step."""
    loads = state.loads
    progress = torch.as_tensor(progress, dtype=torch.float32, device=loads.device)
    mx = loads.max()
    mn = loads.min()
    bal = (mx - loads) / (mx - mn + eps)
    iota = torch.where(mx > 0, (mx - mn) / mx.clamp_min(1.0), 0.0)
    tol = (1.0 - progress).clamp_min(0.0)
    lam = torch.clamp(state.lam + (iota - tol), lam_lo, lam_hi)
    return lam * bal, MoeBalanceState(loads=loads, lam=lam)


def update_loads(state: MoeBalanceState, expert_counts: torch.Tensor) -> MoeBalanceState:
    """An EMA of the routed counts, not a cumulative sum: the edge-stream
    analogue is the current partition fill, which an EMA tracks under
    distribution drift."""
    loads = LOAD_EMA * state.loads + (1.0 - LOAD_EMA) * expert_counts
    return MoeBalanceState(loads=loads, lam=state.lam)
