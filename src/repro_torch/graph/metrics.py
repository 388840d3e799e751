"""Partitioning-quality metrics (Eq. 1 and Eq. 2 of the paper).

Copied from the JAX package's ``graph/metrics.py`` (numpy only), with its
chunked out-of-core variants. All metrics take an
assignment ``assign[m] in [0, k)`` in stream order, with an explicit
``unassigned=`` policy for ``-1`` entries: ``"raise"`` (default) or
``"drop"`` (compute over the assigned subset).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "replica_sets_from_assignment",
    "replica_sets_from_chunks",
    "replication_degree",
    "partition_sizes",
    "partition_balance",
    "sync_volume",
    "unassigned_count",
    "quality_from_chunks",
]


def unassigned_count(assign: np.ndarray) -> int:
    """Number of unassigned (``< 0``) entries in an assignment array."""
    assign = np.asarray(assign)
    return int((assign < 0).sum())


def _assigned_mask(assign: np.ndarray, k: int, unassigned: str) -> np.ndarray:
    """Validate ``assign`` against ``[0, k)`` and return the assigned mask."""
    if unassigned not in ("raise", "drop"):
        raise ValueError(f"unassigned policy must be 'raise' or 'drop', got {unassigned!r}")
    assign = np.asarray(assign)
    neg = assign < 0
    n_neg = int(neg.sum())
    if n_neg and unassigned == "raise":
        raise ValueError(
            f"assignment contains {n_neg} unassigned (-1) edges; pass "
            "unassigned='drop' to compute the metric over the assigned subset"
        )
    if assign.size and int(assign.max()) >= k:
        raise ValueError(f"assignment contains partition id {int(assign.max())} >= k={k}")
    return ~neg


def replica_sets_from_assignment(
    edges: np.ndarray,
    assign: np.ndarray,
    num_vertices: int,
    k: int,
    *,
    unassigned: str = "raise",
) -> np.ndarray:
    """bool[V, k]: replicas[v, p] == vertex v has >=1 incident edge on partition p.

    Unassigned (``-1``) edges contribute no replicas under ``"drop"`` —
    fancy-indexing with ``-1`` would silently attribute them to partition
    ``k-1`` — and raise under the default policy.
    """
    assign = np.asarray(assign)
    ok = _assigned_mask(assign, k, unassigned)
    rep = np.zeros((num_vertices, k), dtype=bool)
    rep[edges[ok, 0], assign[ok]] = True
    rep[edges[ok, 1], assign[ok]] = True
    return rep


def replication_degree(replicas: np.ndarray) -> float:
    """Eq. 1: mean |R_v| over vertices that appear in the graph."""
    counts = replicas.sum(axis=1)
    present = counts > 0
    if not present.any():
        return 0.0
    return float(counts[present].mean())


def partition_sizes(
    assign: np.ndarray, k: int, *, unassigned: str = "raise"
) -> np.ndarray:
    """int64[k]: edges per partition. ``-1`` entries raise or are dropped —
    ``np.bincount`` raises on negatives, so they never reach it either way."""
    assign = np.asarray(assign)
    ok = _assigned_mask(assign, k, unassigned)
    return np.bincount(assign[ok], minlength=k).astype(np.int64)


def partition_balance(
    assign: np.ndarray, k: int, *, unassigned: str = "raise"
) -> float:
    """Imbalance iota = (maxsize - minsize) / maxsize  (0 = perfectly balanced)."""
    sizes = partition_sizes(assign, k, unassigned=unassigned)
    mx = sizes.max()
    if mx == 0:
        return 0.0
    return float((mx - sizes.min()) / mx)


def replica_sets_from_chunks(
    pairs,
    num_vertices: int,
    k: int,
    *,
    unassigned: str = "raise",
) -> np.ndarray:
    """Chunked accumulation of :func:`replica_sets_from_assignment`.

    ``pairs`` is an iterable of ``(edges_chunk, assign_chunk)`` — e.g. a
    zip of ``EdgeFileReader.chunks(c)`` with slices of an assignment spill
    memmap — so replica tables for file-resident graphs build with O(chunk)
    edge memory (the (V, k) bool table is vertex-sized state, as everywhere).
    Bitwise identical to the in-memory function on the concatenated stream.
    """
    rep = np.zeros((num_vertices, k), dtype=bool)
    for edges, assign in pairs:
        assign = np.asarray(assign)
        assert len(edges) == len(assign), (len(edges), len(assign))
        ok = _assigned_mask(assign, k, unassigned)
        rep[edges[ok, 0], assign[ok]] = True
        rep[edges[ok, 1], assign[ok]] = True
    return rep


def quality_from_chunks(
    pairs,
    num_vertices: int,
    k: int,
    *,
    unassigned: str = "raise",
) -> dict:
    """One chunked pass → the standard quality dict for a file-driven run:
    ``replication_degree`` (Eq. 1), ``imbalance`` (iota), ``sizes``,
    ``unassigned``, plus the accumulated ``replicas`` table itself (callers
    that need both the numbers and the table — e.g. re-streaming warm starts
    — get them from the single read). Matches the in-memory metrics exactly.
    """
    rep = np.zeros((num_vertices, k), dtype=bool)
    sizes = np.zeros(k, dtype=np.int64)
    n_unassigned = 0
    for edges, assign in pairs:
        assign = np.asarray(assign)
        assert len(edges) == len(assign), (len(edges), len(assign))
        ok = _assigned_mask(assign, k, unassigned)
        n_unassigned += int((~ok).sum())
        rep[edges[ok, 0], assign[ok]] = True
        rep[edges[ok, 1], assign[ok]] = True
        sizes += np.bincount(assign[ok], minlength=k).astype(np.int64)
    mx = sizes.max() if k else 0
    imbalance = float((mx - sizes.min()) / mx) if mx > 0 else 0.0
    return dict(
        replication_degree=replication_degree(rep),
        imbalance=imbalance,
        sizes=sizes,
        unassigned=n_unassigned,
        sync_volume=sync_volume(rep),
        replicas=rep,
    )


def sync_volume(replicas: np.ndarray, bytes_per_replica: int = 8) -> int:
    """Per-iteration replica-synchronisation traffic.

    Every replicated vertex must exchange its accumulator with its master each
    superstep; a vertex with |R_v| replicas costs (|R_v| - 1) messages up and
    (|R_v| - 1) messages down. This is the quantity the paper's 'processing
    latency' is driven by (GrapH replica synchronisation).
    """
    counts = replicas.sum(axis=1)
    msgs = np.maximum(counts - 1, 0).sum() * 2
    return int(msgs) * bytes_per_replica
