"""Gather-Apply-Scatter supersteps over a mesh of ranks.

Port of the JAX package's ``engine/gas.py``. The partitions are sharded
over the ranks of a 1-D ``parts`` mesh (:func:`engine_mesh`); vertex state
is replicated on every rank. One superstep:

  gather : every directed message (u→v and v→u of each valid edge of the
           rank's slab of partitions) is computed and accumulated into its
           destination vertex — ``add`` through the hand-written
           ``segment_sum`` kernel (``kernels.ops.segment_sum_sorted``) over
           the slab's destination-sorted message layout; ``min`` through
           ``Tensor.scatter_reduce_(..., "amin")``, as the JAX package leaves
           it to ``.at[].min``;
  sync   : one ``all_reduce`` (SUM or MIN) of the (V, d) accumulator over
           the ranks — JAX's ``psum`` / ``pmin`` over ``parts``; none with
           a world of 1;
  apply  : the vertex update on the synchronised accumulator.

The JAX engine accumulates per partition, masks each partition's
accumulator to its replica set and combines across partitions. A
partition's accumulator is zero (``add``) or the identity (``min``) off its
own edges' endpoints, so the mask never changes the result; the same holds
for a slab, the union of its partitions, whose accumulator is zero or the
identity off its edges' endpoints, and for a rank holding no partition.
So the port keys the accumulation by vertex directly. ``min`` is exact in
any order; ``add`` sums in another order than the JAX engine, so results
agree to fp32 rounding (the tests hold pagerank at rtol 1e-5). The
all-reduce leaves the same bits on every rank, and ``apply_fn`` then runs
on identical inputs, so every rank holds the same state after every
superstep: the algorithms' convergence tests agree without another
collective.

``msg_fn(x_u, x_v, deg_u, deg_v) -> (msg_to_v, msg_to_u)`` has the JAX
package's signature; the gather evaluates it on (source, destination)
pairs and uses the first output, so it must treat its two sides alike
(every workload here does).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.partitioned import (
    PartitionedGraph,
    Slab,
    engine_mesh_size,
    slab_placement,
    slab_range,
)
from repro_torch.kernels import ops
from repro_torch import dist as rdist

__all__ = [
    "make_superstep",
    "engine_mesh",
    "engine_mesh_size",
    "slab_placement",
    "slab_range",
    "gather",
    "BIG",
]

BIG = 3.0e38


def engine_mesh(n_devices: Optional[int] = None, k: Optional[int] = None) -> rdist.RankMesh:
    """1-D ``parts`` mesh over the ranks of the default process group.

    Any rank count works for any k — :func:`make_superstep` places the k
    partitions in slabs whose sizes differ by at most one — so the mesh
    keeps every rank, capped at ``n_devices``, and at k when k is smaller
    than the world (extra ranks would carry nothing). With no process
    group: one rank."""
    return rdist.rank_mesh("parts", engine_mesh_size(rdist.world_size(), n_devices, k))


def gather(
    g: PartitionedGraph,
    state: torch.Tensor,  # (V, d)
    msg_fn: Callable,
    combine: str = "add",
    slab: Optional[Slab] = None,
) -> torch.Tensor:
    """(V, d) accumulated messages per destination vertex, over the
    messages of ``slab`` (default: every partition the graph holds)."""
    if slab is None:
        slab = g.slab(*g.parts)
    src, dst = slab.msg_src, slab.msg_layout.seg_ids
    msg, _ = msg_fn(state[src], state[dst], g.degrees[src], g.degrees[dst])
    if combine == "add":
        return ops.segment_sum_sorted(msg, slab.msg_layout)
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
    mesh: Optional[rdist.RankMesh] = None,
    combine: str = "add",
    trace=None,
):
    """Build a superstep: state (V, d) -> state (V, d), on the graph's device.

    The partitions are sharded over ``mesh`` (default
    ``engine_mesh(k=g.k)``) as :func:`slab_placement` places them: this
    rank gathers its slab's messages (``g`` must hold the slab: build it
    with the same mesh), then one all-reduce over the ranks combines the
    slabs. The returned callable carries ``.slab_occupancy`` — real
    partitions per rank, the JAX package's tuple for the same mesh size and
    k, ``(k,)`` on one rank — and ``.parts``, this rank's slab ``(lo,
    hi)``, and, when ``trace`` is a tracer
    with a ``span(name, cat=..., **attrs)`` context manager (e.g. the JAX
    package's ``repro.obs.Tracer``), records one host-side ``superstep``
    span per call with ``n_shards`` and ``slab_occupancy`` (dispatch only:
    no added sync).
    """
    if combine not in ("add", "min"):
        raise ValueError(combine)
    if mesh is None:
        mesh = engine_mesh(k=g.k)
    n_shards = mesh.size
    _, slab_occupancy = slab_placement(g.k, n_shards)
    slab = g.slab(*slab_range(g.k, mesh))
    reduce_op = "sum" if combine == "add" else "min"

    def superstep(state: torch.Tensor) -> torch.Tensor:
        acc = mesh.all_reduce(gather(g, state, msg_fn, combine, slab), reduce_op)
        return apply_fn(state, acc, g.degrees)

    if trace is None:
        superstep.slab_occupancy = slab_occupancy
        superstep.parts = (slab.lo, slab.hi)
        return superstep

    def traced_superstep(state: torch.Tensor) -> torch.Tensor:
        with trace.span("superstep", cat="engine", k=g.k, combine=combine,
                        n_shards=n_shards, slab_occupancy=list(slab_occupancy)):
            return superstep(state)

    traced_superstep.slab_occupancy = slab_occupancy
    traced_superstep.parts = (slab.lo, slab.hi)
    return traced_superstep
