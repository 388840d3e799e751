"""Partitioned-graph device representation for the vertex-cut engine.

Port of the JAX package's ``engine/partitioned.py``: per-partition padded
edge lists plus the replica table, as tensors on one device. It also holds,
built once per graph on the host, the layout the ``segment_sum`` kernel
consumes: the 2E directed messages of the undirected edges (u→v and v→u)
sorted by destination (stable), and a ``SegmentLayout`` of their
destinations.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import compat
from repro_torch.graph import metrics
from repro_torch.kernels.segment_sum import SegmentLayout, segment_layout

__all__ = ["PartitionedGraph", "build_partitioned_graph", "message_layout"]


@dataclasses.dataclass
class PartitionedGraph:
    """Static-shape vertex-cut partitioned graph on one device.

    Attributes:
      edges: (k, e_max, 2) int32 — global vertex ids, zero-padded.
      evalid: (k, e_max) bool — padding mask.
      replicas: (V, k) bool — R_v membership.
      masters: (V,) int32 — owning partition per vertex (first replica).
      degrees: (V,) int32 — global degrees (undirected).
      msg_src: (2E,) int32 — sources of the directed messages, sorted by
        destination.
      msg_layout: their destinations (``msg_layout.seg_ids``, (2E,) int32)
        and the ``segment_sum`` kernel's chunking of them.
      num_vertices, k: sizes.
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

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @property
    def replication_degree(self) -> float:
        return metrics.replication_degree(self.replicas.cpu().numpy())

    @property
    def sync_volume_bytes(self) -> int:
        return metrics.sync_volume(self.replicas.cpu().numpy())

    @property
    def edges_per_partition(self) -> np.ndarray:
        return self.evalid.sum(1).cpu().numpy()


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
    pad_multiple: int = 8, *, device=None,
) -> PartitionedGraph:
    """Scatter the edge stream into per-partition padded lists on ``device``."""
    dev = compat.resolve_device(device)
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
    return from_arrays(
        part_edges, evalid, replicas, first.astype(np.int32),
        degrees.astype(np.int32), num_vertices, k, dev,
    )


def from_arrays(
    edges: np.ndarray, evalid: np.ndarray, replicas: np.ndarray,
    masters: np.ndarray, degrees: np.ndarray, num_vertices: int, k: int,
    device: torch.device,
) -> PartitionedGraph:
    """A PartitionedGraph on ``device`` from its numpy fields; builds the
    message layout."""
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
    )
