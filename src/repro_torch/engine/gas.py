"""Gather-Apply-Scatter supersteps on one device.

Port of the JAX package's ``engine/gas.py``, single-device. One superstep:

  gather : every directed message (u→v and v→u of each valid edge) is
           computed and accumulated into its destination vertex —
           ``add`` through the hand-written ``segment_sum`` kernel
           (``kernels.ops.segment_sum_sorted``) over the graph's
           destination-sorted message layout; ``min`` through
           ``Tensor.scatter_reduce_(..., "amin")``, as the JAX package leaves
           it to ``.at[].min``;
  apply  : the vertex update on the accumulated values.

The JAX engine accumulates per partition, masks each partition's
accumulator to its replica set and combines across partitions. A
partition's accumulator is zero (``add``) or the identity (``min``) off its
own edges' endpoints, so the mask never changes the result: the port keys
the accumulation by vertex directly. ``min`` is exact in any order; ``add``
sums in another order than the JAX engine, so results agree to fp32
rounding (the tests hold pagerank at rtol 1e-5).

``msg_fn(x_u, x_v, deg_u, deg_v) -> (msg_to_v, msg_to_u)`` has the JAX
package's signature; the gather evaluates it on (source, destination)
pairs and uses the first output, so it must treat its two sides alike
(every workload here does).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.engine.partitioned import PartitionedGraph
from repro_torch.kernels import ops

__all__ = ["make_superstep", "gather", "BIG"]

BIG = 3.0e38


def gather(
    g: PartitionedGraph,
    state: torch.Tensor,  # (V, d)
    msg_fn: Callable,
    combine: str = "add",
) -> torch.Tensor:
    """(V, d) accumulated messages per destination vertex."""
    src, dst = g.msg_src, g.msg_layout.seg_ids
    msg, _ = msg_fn(state[src], state[dst], g.degrees[src], g.degrees[dst])
    if combine == "add":
        return ops.segment_sum_sorted(msg, g.msg_layout)
    if combine == "min":
        acc = torch.full((g.num_vertices, msg.shape[1]), BIG, dtype=msg.dtype,
                         device=msg.device)
        idx = dst.long()[:, None].expand_as(msg)
        return acc.scatter_reduce_(0, idx, msg, "amin", include_self=True)
    raise ValueError(combine)


def make_superstep(
    g: PartitionedGraph,
    msg_fn: Callable,
    apply_fn: Callable,  # (state, synced_acc, degrees) -> state
    combine: str = "add",
    trace=None,
):
    """Build a superstep: state (V, d) -> state (V, d), on the graph's device.

    The returned callable carries ``.slab_occupancy`` — partitions per
    device, ``(k,)`` on one device — and, when ``trace`` is a tracer with a
    ``span(name, cat=..., **attrs)`` context manager (e.g. the JAX
    package's ``repro.obs.Tracer``), records one host-side ``superstep``
    span per call (dispatch only: no added sync).
    """
    if combine not in ("add", "min"):
        raise ValueError(combine)
    slab_occupancy = (g.k,)

    def superstep(state: torch.Tensor) -> torch.Tensor:
        acc = gather(g, state, msg_fn, combine)
        return apply_fn(state, acc, g.degrees)

    if trace is None:
        superstep.slab_occupancy = slab_occupancy
        return superstep

    def traced_superstep(state: torch.Tensor) -> torch.Tensor:
        with trace.span("superstep", cat="engine", k=g.k, combine=combine,
                        n_shards=1, slab_occupancy=list(slab_occupancy)):
            return superstep(state)

    traced_superstep.slab_occupancy = slab_occupancy
    return traced_superstep
