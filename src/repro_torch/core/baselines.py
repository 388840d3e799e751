"""Single-edge streaming baselines the paper compares ADWISE against.

Copied from the JAX package's ``core/baselines.py`` (the numpy parts):

* Hashing — edge hash (PowerGraph/GraphX default);
* Grid    — 2D grid-constrained hashing (GraphBuilder);
* DBH     — Degree-Based Hashing (Xie et al., NIPS'14).

These are stateless hashes over the whole stream, computed on the host; the
same edges and seed give bit-identical assignments in both packages. HDRF and
Greedy (and their numpy oracles) are the next slice (ROADMAP.md, port
queue 1, item 7).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.types import PartitionResult

__all__ = [
    "dbh_partition",
    "hash_partition",
    "grid_partition",
    "hash_assign",
    "grid_assign",
    "dbh_assign",
]


def _hash_vec(x: np.ndarray, k: int, salt: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic integer hash -> [0, k)."""
    h = (x.astype(np.uint64) + np.uint64(salt)) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC2B2AE3D27D4EB4F)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(k)).astype(np.int32)



def _local_to_global(allowed: np.ndarray) -> np.ndarray:
    l2g = np.flatnonzero(np.asarray(allowed, bool)).astype(np.int32)
    assert len(l2g) > 0, "allowed mask selects no partition"
    return l2g



def hash_assign(edges: np.ndarray, num_vertices: int, k: int, seed: int = 0) -> np.ndarray:
    key = edges[:, 0].astype(np.uint64) * np.uint64(num_vertices) + edges[:, 1].astype(np.uint64)
    return _hash_vec(key, k, salt=seed + 1)


def grid_assign(edges: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    g = max(int(np.floor(np.sqrt(k))), 1)
    ru = _hash_vec(edges[:, 0].astype(np.uint64), g, salt=seed + 11)
    cv = _hash_vec(edges[:, 1].astype(np.uint64), g, salt=seed + 13)
    return (ru * g + cv).astype(np.int32) % k


def dbh_assign(edges: np.ndarray, degrees: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """DBH placement given the *full-stream* degree table."""
    u, v = edges[:, 0], edges[:, 1]
    pick_u = degrees[u] < degrees[v]
    # Tie: lower id (deterministic).
    tie = degrees[u] == degrees[v]
    pick_u = np.where(tie, u < v, pick_u)
    key = np.where(pick_u, u, v).astype(np.uint64)
    return _hash_vec(key, k, salt=seed + 29)


def hash_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """Random edge hashing (the PowerGraph default loader).

    ``allowed`` restricts placements to a partition subset by hashing into
    it by rank (spotlight masked form).
    """
    t0 = time.perf_counter()
    if allowed is None:
        assign = hash_assign(edges, num_vertices, k, seed=seed)
    else:
        l2g = _local_to_global(allowed)
        assign = l2g[hash_assign(edges, num_vertices, len(l2g), seed=seed)]
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="hash"))


def grid_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """GraphBuilder grid hashing: p drawn from intersection of row(u) and col(v).

    Constrains each vertex's replicas to a sqrt(k)-sized subset.
    """
    if allowed is not None:
        raise ValueError(
            "grid imposes its own replica constraint and cannot honour a "
            "spotlight spread mask"
        )
    t0 = time.perf_counter()
    assign = grid_assign(edges, k, seed=seed)
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="grid"))


def dbh_partition(
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    degrees: Optional[np.ndarray] = None,
    allowed: Optional[np.ndarray] = None,
) -> PartitionResult:
    """Degree-Based Hashing: hash the lower-degree endpoint of each edge."""
    t0 = time.perf_counter()
    if degrees is None:
        degrees = np.zeros(num_vertices, dtype=np.int64)
        np.add.at(degrees, edges[:, 0], 1)
        np.add.at(degrees, edges[:, 1], 1)
    if allowed is None:
        assign = dbh_assign(edges, degrees, k, seed=seed)
    else:
        l2g = _local_to_global(allowed)
        assign = l2g[dbh_assign(edges, degrees, len(l2g), seed=seed)]
    return PartitionResult(assign, dict(k=k, wall_time_s=time.perf_counter() - t0, name="dbh"))

