"""Elastic mesh planning — a copy of ``repro.runtime.elastic`` (host-only
Python and numpy).

`plan_mesh(n_chips)` picks the best (pod, data, model) factorization for an
arbitrary healthy-chip count; `replan_after_failure` shrinks the data axis
(keeping TP intact — TP shards hold non-replicated parameter state, so losing
a TP group member means that whole group's replica is lost anyway) and
reports the gradient-accumulation factor that keeps the global batch
constant. Sharding rules in `launch.sharding` are mesh-shape-agnostic, so a
re-mesh only requires re-jitting the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MeshPlan", "plan_mesh", "replan_after_failure"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pod: int
    data: int
    model: int
    grad_accum: int = 1

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def axes(self):
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def shape(self):
        return (
            (self.pod, self.data, self.model)
            if self.pod > 1
            else (self.data, self.model)
        )


def plan_mesh(n_chips: int, model_parallel: int = 16, pods: int = 1) -> MeshPlan:
    """Largest usable mesh: data = floor(chips / (pods·model))."""
    per_pod = n_chips // pods
    data = per_pod // model_parallel
    assert data >= 1, f"{n_chips} chips cannot host model_parallel={model_parallel}"
    return MeshPlan(pod=pods, data=data, model=model_parallel)


def replan_after_failure(
    plan: MeshPlan, lost_chips: int, global_batch: int
) -> Optional[MeshPlan]:
    """Shrink the data axis to survive `lost_chips` failures.

    A lost chip removes its whole TP group (model_parallel chips) from
    service. Keeps global batch via gradient accumulation. Returns None if
    no viable mesh remains.
    """
    lost_groups = -(-lost_chips // plan.model)
    total_groups = plan.pod * plan.data - lost_groups
    if total_groups < 1:
        return None
    # Prefer keeping pods balanced; fold odd groups into a single-pod mesh.
    if plan.pod > 1 and total_groups % plan.pod == 0:
        pod, data = plan.pod, total_groups // plan.pod
    else:
        pod, data = 1, total_groups
    dp_old = plan.pod * plan.data * plan.grad_accum
    accum = -(-dp_old // (pod * data))
    # Global batch must stay divisible across the new data-parallel width.
    while global_batch % (pod * data) != 0 and data > 1:
        data -= 1
        accum = -(-dp_old // (pod * data))
    return MeshPlan(pod=pod, data=data, model=plan.model, grad_accum=accum)
