"""External (on-disk) chunked shuffle of a binary edge-stream file.

Copy of the JAX package's ``graph/io/shuffle.py`` (numpy and the standard library
only).

Stream-order sensitivity experiments (paper §IV — file order vs adversarial
random order) need a *shuffled copy* of the stream. In-memory that is
``EdgeStream.shuffled``; out-of-core it is the classic recursive external
shuffle:

  scatter: read the source in bounded chunks; deal each row uniformly at
    random into one of B bucket files. B is capped at ``max_open`` (file-
    descriptor budget — a 1e9-row shuffle must not open 30k files at once).
  gather: for each bucket in order — if it fits the chunk budget, load it,
    permute it in memory, append to the destination; otherwise scatter it
    again recursively (depth is log_B(m / chunk), i.e. 2 for anything that
    fits on one disk).

The resident-memory bound is **hard**, not expected-case: a bucket is only
ever loaded whole once it holds at most ``2 * chunk_edges`` rows — any
larger bucket (whether from the ``max_open`` cap, an adversarial seed, or a
pathologically skewed source order) is re-scattered instead, and the bound
is asserted at every load. :class:`ShuffleReport` surfaces the realized
maxima (``max_loaded_rows``, recursion ``depth``, ``buckets``) so tests and
benches can prove the bound rather than trust it.

Dealing rows to uniform buckets and uniformly permuting each bucket yields a
uniform permutation of the file, deterministic in ``seed`` (a single
generator threads through scatter and gather in bucket order). Peak edge
memory is O(chunk); open files are O(max_open).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
from typing import Optional

import numpy as np

from repro_torch.graph.io.format import EdgeFileReader, EdgeFileWriter

__all__ = ["shuffle_file", "ShuffleReport"]

_MAX_OPEN = 256  # default simultaneous bucket files per scatter level


@dataclasses.dataclass
class ShuffleReport:
    """Realized resource profile of one external shuffle."""

    num_edges: int
    chunk_edges: int
    max_open: int
    buckets: int = 0  # bucket files created across all levels
    depth: int = 0  # deepest recursive re-scatter level reached
    max_loaded_rows: int = 0  # largest bucket permuted in memory

    @property
    def bound_rows(self) -> int:
        """The hard in-memory bound every loaded bucket satisfied."""
        return max(2 * self.chunk_edges, 1)


def _scatter(chunks, n_rows: int, chunk_edges: int, max_open: int, rng, td,
             ids, report: ShuffleReport):
    """Deal rows from a chunk iterator into <= max_open bucket files.

    Returns the bucket paths (creation order == gather order)."""
    n_buckets = min(max(1, -(-2 * n_rows // chunk_edges)), max_open)
    paths = [os.path.join(td, f"bucket_{next(ids)}.bin") for _ in range(n_buckets)]
    report.buckets += n_buckets
    handles = [open(p, "wb") for p in paths]
    try:
        for chunk in chunks:
            which = rng.integers(0, n_buckets, size=len(chunk))
            # One stable sort groups the chunk by bucket (a per-bucket mask
            # loop would re-scan the chunk n_buckets times).
            order = np.argsort(which, kind="stable")
            grouped = chunk[order]
            counts = np.bincount(which, minlength=n_buckets)
            stops = np.cumsum(counts)
            for b in range(n_buckets):
                if counts[b]:
                    rows = grouped[stops[b] - counts[b] : stops[b]]
                    handles[b].write(np.ascontiguousarray(rows).tobytes())
    finally:
        for f in handles:
            f.close()
    return paths


def _raw_chunks(path: str, chunk_edges: int):
    """Iterate a raw headerless int32-pair file in bounded chunks."""
    with open(path, "rb") as f:
        while True:
            raw = np.fromfile(f, dtype=np.int32, count=chunk_edges * 2)
            if raw.size == 0:
                return
            yield raw.reshape(-1, 2)


def _gather(paths, chunk_edges: int, max_open: int, rng, td, ids, emit,
            report: ShuffleReport, depth: int = 0) -> None:
    """Permute each bucket into ``emit``; oversized buckets scatter again."""
    report.depth = max(report.depth, depth)
    bound = max(2 * chunk_edges, 1)
    for p in paths:
        n_rows = os.path.getsize(p) // 8
        if n_rows <= bound:
            raw = np.fromfile(p, dtype=np.int32)
            rows = raw.reshape(-1, 2)
            # The hard O(chunk) residency bound: every whole-bucket load is
            # within 2x the chunk budget, no matter how skewed the input or
            # how small max_open forced the fan-out to be.
            assert len(rows) <= bound, (len(rows), bound)
            report.max_loaded_rows = max(report.max_loaded_rows, len(rows))
            emit(rows[rng.permutation(len(rows))])
        else:
            # Re-scatter an oversized bucket. n_rows > 2*chunk forces
            # n_buckets = min(ceil(2*n/chunk), max_open) >= min(5, max_open),
            # and max_open >= 2 is enforced at the entry point, so the
            # expected bucket size strictly shrinks every level — the
            # recursion terminates with probability 1 and each level is
            # logged in the report.
            sub = _scatter(_raw_chunks(p, chunk_edges), n_rows, chunk_edges,
                           max_open, rng, td, ids, report)
            _gather(sub, chunk_edges, max_open, rng, td, ids, emit, report,
                    depth + 1)
        os.remove(p)


def shuffle_file(
    src: str,
    dst: str,
    *,
    seed: int = 0,
    chunk_edges: int = 1 << 16,
    max_open: Optional[int] = None,
    tmpdir: Optional[str] = None,
) -> ShuffleReport:
    """Write a uniformly shuffled copy of edge file ``src`` to ``dst``.

    Returns a :class:`ShuffleReport` with the realized bucket/recursion
    profile (``max_loaded_rows <= 2 * chunk_edges`` is the hard memory
    bound). ``max_open`` caps simultaneously open bucket files per scatter
    level; small values force deeper recursion, never larger buckets.
    """
    assert chunk_edges >= 1
    if max_open is None:
        max_open = _MAX_OPEN  # resolved at call time (tests patch the module)
    if max_open < 2:
        raise ValueError(
            f"max_open must be >= 2 (a single bucket cannot shrink on "
            f"re-scatter), got {max_open}"
        )
    rng = np.random.default_rng(seed)
    ids = itertools.count()
    with EdgeFileReader(src) as r:
        m, n = r.num_edges, r.num_vertices
        report = ShuffleReport(num_edges=m, chunk_edges=chunk_edges,
                               max_open=max_open)
        with tempfile.TemporaryDirectory(dir=tmpdir) as td:
            paths = _scatter(r.chunks(chunk_edges), m, chunk_edges, max_open,
                             rng, td, ids, report)
            with EdgeFileWriter(dst, num_vertices=n) as w:
                _gather(paths, chunk_edges, max_open, rng, td, ids, w.append,
                        report)
    return report
