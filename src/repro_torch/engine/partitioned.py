"""Partitioned-graph device representation for the vertex-cut engine.

Port of the JAX package's ``engine/partitioned.py``: per-partition padded
edge lists plus the replica table, as tensors on the rank's device. On an
engine mesh of several ranks a rank keeps on its device only the edges of
its slab of partitions (``PartitionedGraph.parts``); the replica table,
the masters and the degrees are whole on every rank, since the vertex state
is replicated, as in the JAX package. The graph also holds, built once on
the host, the layout the ``segment_sum`` kernel consumes: the directed
messages of the held edges (u→v and v→u) sorted by destination (stable),
and a ``SegmentLayout`` of their destinations. :meth:`PartitionedGraph.slab`
gives the same for a contiguous range of the held partitions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch import dist as rdist
from repro_torch.graph import metrics
from repro_torch.kernels.segment_sum import SegmentLayout, segment_layout

__all__ = [
    "PartitionedGraph",
    "Slab",
    "build_partitioned_graph",
    "message_layout",
    "engine_mesh_size",
    "slab_placement",
    "slab_range",
]


def engine_mesh_size(world: int, n_devices: Optional[int] = None,
                     k: Optional[int] = None) -> int:
    """The JAX package's ``engine_mesh`` sizing on ``world`` devices: all of
    them, capped at ``n_devices`` and at ``k`` (at least one)."""
    n = world if n_devices is None else min(int(n_devices), world)
    if k is not None:
        n = max(min(n, int(k)), 1)
    return n


def slab_placement(k: int, n_shards: int) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The JAX package's placement of k partitions on ``n_shards`` devices:
    ``(perm, occupancy)``. The partition axis is padded to a multiple of
    ``n_shards`` with empty slabs; ``perm`` (k_pad,) orders real partitions
    and pads so that device d's contiguous block holds ``occupancy[d]`` real
    partitions (real counts differ by at most one) followed by its pads.
    Device d's real partitions are therefore the contiguous range starting
    at ``sum(occupancy[:d])``."""
    if k < 1 or n_shards < 1:
        raise ValueError(f"slab_placement: k={k} and n_shards={n_shards} must be >= 1")
    k_pad = -(-k // n_shards) * n_shards
    kp_per = k_pad // n_shards
    base, rem = divmod(k, n_shards)
    occupancy = np.full(n_shards, base, np.int64)
    occupancy[:rem] += 1
    perm = np.arange(k_pad, dtype=np.int64)
    if k_pad != k:
        next_real, next_pad, pos = 0, k, 0
        for d in range(n_shards):
            c = int(occupancy[d])
            perm[pos : pos + c] = np.arange(next_real, next_real + c)
            perm[pos + c : pos + kp_per] = np.arange(next_pad, next_pad + kp_per - c)
            next_real += c
            next_pad += kp_per - c
            pos += kp_per
    return perm, tuple(int(c) for c in occupancy)


def slab_range(k: int, mesh: rdist.RankMesh) -> Tuple[int, int]:
    """This rank's partitions ``[lo, hi)`` on ``mesh`` as
    :func:`slab_placement` places k of them; empty (k, k) on a rank past
    the mesh."""
    if mesh.coord is None:
        return k, k
    _, occupancy = slab_placement(k, mesh.size)
    lo = sum(occupancy[: mesh.coord])
    return lo, lo + occupancy[mesh.coord]


@dataclasses.dataclass
class Slab:
    """The messages of the edges of partitions ``lo .. hi - 1``: sources
    and a ``segment_sum`` layout of their destinations, sorted by
    destination as :func:`message_layout` sorts them."""

    lo: int
    hi: int
    msg_src: torch.Tensor  # (2E_slab,) int32
    msg_layout: SegmentLayout


@dataclasses.dataclass
class PartitionedGraph:
    """Static-shape vertex-cut partitioned graph on a device.

    Attributes:
      edges: (hi - lo, e_max, 2) int32 — global vertex ids, zero-padded, of
        the held partitions ``parts = (lo, hi)`` (all k on one rank).
      evalid: (hi - lo, e_max) bool — padding mask.
      replicas: (V, k) bool — R_v membership.
      masters: (V,) int32 — owning partition per vertex (first replica).
      degrees: (V,) int32 — global degrees (undirected).
      msg_src: (2E_held,) int32 — sources of the held edges' directed
        messages, sorted by destination.
      msg_layout: their destinations (``msg_layout.seg_ids``, (2E_held,)
        int32) and the ``segment_sum`` kernel's tile plan of them.
      num_vertices, k: sizes.
      parts: (lo, hi), the partitions whose edges this graph holds.
      sizes: (k,) int64 on the host — every partition's edge count.
    """

    edges: torch.Tensor
    evalid: torch.Tensor
    replicas: torch.Tensor
    masters: torch.Tensor
    degrees: torch.Tensor
    msg_src: torch.Tensor
    msg_layout: SegmentLayout
    num_vertices: int
    k: int
    parts: Tuple[int, int]
    sizes: np.ndarray
    _slabs: Dict[Tuple[int, int], Slab] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.degrees.device

    @property
    def replication_degree(self) -> float:
        return metrics.replication_degree(self.replicas.cpu().numpy())

    @property
    def sync_volume_bytes(self) -> int:
        return metrics.sync_volume(self.replicas.cpu().numpy())

    @property
    def edges_per_partition(self) -> np.ndarray:
        return self.sizes.copy()

    def part_edges(self, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(edges, evalid) of the held partitions ``lo .. hi - 1``: views,
        partition axis first."""
        held_lo, held_hi = self.parts
        if not held_lo <= lo <= hi <= held_hi:
            raise ValueError(f"partitions [{lo}, {hi}) are not within the held [{held_lo}, "
                             f"{held_hi}) of k={self.k}: build the graph with the mesh "
                             "it runs on (build_partitioned_graph(mesh=))")
        return self.edges[lo - held_lo : hi - held_lo], self.evalid[lo - held_lo : hi - held_lo]

    def slab(self, lo: int, hi: int) -> Slab:
        """The messages of partitions ``lo .. hi - 1`` (empty when lo ==
        hi), which the graph must hold. The held range reuses the graph's
        layout; another range gets a layout of its own, built once: a
        layout is the kernel's scratch and records the stream it runs on."""
        e, ev = self.part_edges(lo, hi)
        if (lo, hi) == self.parts:
            return Slab(lo, hi, self.msg_src, self.msg_layout)
        if (lo, hi) not in self._slabs:
            src, dst = message_layout(e.cpu().numpy(), ev.cpu().numpy(), self.num_vertices)
            self._slabs[(lo, hi)] = Slab(lo, hi, torch.as_tensor(src, device=self.device),
                                         segment_layout(dst, self.num_vertices, self.device))
        return self._slabs[(lo, hi)]


def message_layout(
    edges: np.ndarray, evalid: np.ndarray, num_vertices: int
) -> tuple[np.ndarray, np.ndarray]:
    """(msg_src, msg_dst) of the valid edges' 2E directed messages, sorted by
    destination (stable: partition order, then slot, u→v before v→u)."""
    e = np.asarray(edges, np.int32)[np.asarray(evalid, bool)]
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    return src, dst


def build_partitioned_graph(
    edges: np.ndarray, assign: np.ndarray, num_vertices: int, k: int,
    pad_multiple: int = 8, *, device=None, mesh: Optional[rdist.RankMesh] = None,
) -> PartitionedGraph:
    """Scatter the edge stream into per-partition padded lists on ``device``.

    ``mesh`` is the engine mesh the graph is processed on (default: the
    JAX package's ``engine_mesh(k=k)``, every rank capped at k, so one
    rank with no process group): the device keeps only this rank's slab of
    partitions (:func:`slab_range`) and its messages, beside the whole
    replica table and degrees. Every rank must run the workloads on that
    mesh."""
    dev = compat.resolve_device(device)
    if mesh is None:
        mesh = rdist.rank_mesh("parts", engine_mesh_size(rdist.world_size(), None, k))
    edges = np.asarray(edges, np.int32)
    assign = np.asarray(assign, np.int32)
    m = len(edges)
    if assign.shape != (m,):
        raise ValueError(f"assign must have shape ({m},), got {assign.shape}")
    bad = (assign < 0) | (assign >= k)
    if bad.any():
        idx = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"build_partitioned_graph: {int(bad.sum())} of {m} edges have "
            f"partition ids outside [0, {k}) (first: assign[{idx}] = "
            f"{int(assign[idx])}). Unassigned (-1) edges cannot be built "
            "into an engine graph — partition the full stream, or drop "
            "unassigned edges before building."
        )
    sizes = np.bincount(assign, minlength=k)
    e_max = max(int(sizes.max()), 1)
    e_max = -(-e_max // pad_multiple) * pad_multiple
    part_edges = np.zeros((k, e_max, 2), np.int32)
    evalid = np.zeros((k, e_max), bool)
    order = np.argsort(assign, kind="stable")
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for p in range(k):
        rows = order[offs[p] : offs[p + 1]]
        part_edges[p, : len(rows)] = edges[rows]
        evalid[p, : len(rows)] = True
    replicas = metrics.replica_sets_from_assignment(edges, assign, num_vertices, k)
    # Master = lowest partition id holding the vertex (vertices absent from
    # the graph point at partition 0; they never participate).
    first = np.where(replicas.any(axis=1), replicas.argmax(axis=1), 0)
    degrees = np.zeros(num_vertices, np.int64)
    np.add.at(degrees, edges[:, 0], 1)
    np.add.at(degrees, edges[:, 1], 1)
    lo, hi = slab_range(k, mesh)
    return from_arrays(
        part_edges[lo:hi], evalid[lo:hi], replicas, first.astype(np.int32),
        degrees.astype(np.int32), num_vertices, k, dev, parts=(lo, hi), sizes=sizes,
    )


def from_arrays(
    edges: np.ndarray, evalid: np.ndarray, replicas: np.ndarray,
    masters: np.ndarray, degrees: np.ndarray, num_vertices: int, k: int,
    device: torch.device, *, parts: Optional[Tuple[int, int]] = None,
    sizes: Optional[np.ndarray] = None,
) -> PartitionedGraph:
    """A PartitionedGraph on ``device`` from its numpy fields; builds the
    message layout. ``edges`` / ``evalid`` are the partitions ``parts``
    (default all k), ``sizes`` every partition's edge count (default
    counted from ``evalid``, which must then hold all k)."""
    parts = (0, int(k)) if parts is None else (int(parts[0]), int(parts[1]))
    if sizes is None:
        if parts != (0, int(k)):
            raise ValueError("from_arrays: a graph holding part of the partitions needs sizes=")
        sizes = np.asarray(evalid, bool).sum(1)
    src, dst = message_layout(edges, evalid, num_vertices)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return PartitionedGraph(
        edges=put(edges, torch.int32),
        evalid=put(evalid, torch.bool),
        replicas=put(replicas, torch.bool),
        masters=put(masters, torch.int32),
        degrees=put(degrees, torch.int32),
        msg_src=put(src, torch.int32),
        msg_layout=segment_layout(dst, num_vertices, device),
        num_vertices=int(num_vertices),
        k=int(k),
        parts=parts,
        sizes=np.asarray(sizes, np.int64),
    )
