"""Edge-stream abstraction.

Copy of the JAX package's ``graph/stream.py``. A streaming partitioner consumes edges
in a fixed order; the stream splits into ``z`` disjoint sub-streams for
parallel loading (one per partitioner instance, as in the paper's
evaluation setup where each of 8 machines loads 1/8 of the graph).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

__all__ = ["EdgeStream"]


@dataclasses.dataclass
class EdgeStream:
    """An ordered stream of graph edges.

    Attributes:
      edges: (m, 2) int32 array in stream order.
      num_vertices: |V|.
    """

    edges: np.ndarray
    num_vertices: int

    def __post_init__(self) -> None:
        if self.edges.ndim != 2 or self.edges.shape[1] != 2:
            raise ValueError(f"edges must be (m, 2), got {self.edges.shape}")
        self.edges = np.ascontiguousarray(self.edges, dtype=np.int32)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def shuffled(self, seed: int = 0) -> "EdgeStream":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_edges)
        return EdgeStream(self.edges[perm], self.num_vertices)

    def chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for start in range(0, self.num_edges, chunk_size):
            yield self.edges[start : start + chunk_size]

    def split(self, z: int) -> Sequence["EdgeStream"]:
        """Split into z contiguous disjoint sub-streams (parallel loading model).

        Instance boundaries are the ceil(m/z)-row chunks of
        :meth:`split_padded`, so the sequential (loop) and batched spotlight
        backends govern identical edge ranges per instance for any z and m
        (trailing instances may be shorter or empty when z does not divide m).
        """
        bounds = self.split_bounds(self.num_edges, z)
        return [
            EdgeStream(self.edges[bounds[i] : bounds[i + 1]], self.num_vertices)
            for i in range(z)
        ]

    @staticmethod
    def split_bounds(m: int, z: int) -> np.ndarray:
        """(z+1,) int64 instance boundaries shared by split / split_padded."""
        per = -(-m // z) if m else 0
        return np.minimum(np.arange(z + 1, dtype=np.int64) * per, m)

    def split_padded(self, z: int) -> tuple[np.ndarray, np.ndarray]:
        """Split into z equal, padded chunks.

        Returns (edges[z, ceil(m/z), 2], valid[z, ceil(m/z)]); padding edges
        are (0, 0) with valid=False — the batched spotlight layout.
        """
        per = -(-self.num_edges // z)
        padded = np.zeros((z * per, 2), dtype=np.int32)
        padded[: self.num_edges] = self.edges
        valid = np.zeros((z * per,), dtype=bool)
        valid[: self.num_edges] = True
        return padded.reshape(z, per, 2), valid.reshape(z, per)

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_vertices, dtype=np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def save(self, path: str) -> None:
        np.savez_compressed(path, edges=self.edges, num_vertices=self.num_vertices)

    @staticmethod
    def load(path: str) -> "EdgeStream":
        # NpzFile holds the archive open until closed; copy the arrays out
        # under a context manager so the file handle never leaks.
        with np.load(path) as data:
            return EdgeStream(data["edges"].copy(), int(data["num_vertices"]))

    def to_file(self, path: str) -> None:
        """Write as a binary edge-stream file (`repro_torch.graph.io` format)."""
        from repro_torch.graph.io.format import write_edge_file

        write_edge_file(path, self.edges, self.num_vertices)

    @staticmethod
    def from_file(path: str) -> "EdgeStream":
        """Load a binary edge-stream file fully resident (small graphs /
        tests; large graphs should stay behind an ``EdgeFileReader``)."""
        from repro_torch.graph.io.format import read_edge_file

        edges, n = read_edge_file(path)
        return EdgeStream(edges, n)
