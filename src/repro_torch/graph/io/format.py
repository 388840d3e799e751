"""Versioned binary edge-stream file format (the out-of-core substrate).

Copy of the JAX package's ``graph/io/format.py`` (numpy and the standard library
only).

Layout (little-endian, 64-byte fixed header + flat payload):

    offset  size  field
    0       8     magic   b"ADWSTRM\\0"
    8       4     version uint32 (currently 1)
    12      4     dtype   uint32 code (1 = int32 (u, v) pairs)
    16      8     m       uint64 — number of edges
    24      8     n       uint64 — number of vertices
    32      8     flags   uint64 (reserved, 0)
    40      24    zero padding (reserved)
    64      m*8   payload: int32[m, 2] edge rows in stream order

The payload is a flat, aligned int32 array, so the file can be ``np.memmap``-ed
directly (``EdgeFileReader(path, mmap=True)``) or read in bounded chunks with
plain seek+read (the default — every ``read()`` returns a fresh owned array,
which is what the bounded-memory driver in ``repro_torch.core.oocore`` wants and
what the memory-accounting tests count).

Writers stream: ``append()`` takes (c, 2) chunks, the header's ``m`` (and,
when not pinned up front, ``n``) is back-patched on ``close()``, so a text
ingest or an external shuffle never holds more than one chunk of edges.
"""
from __future__ import annotations

import io
import os
import struct
import time
from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "MAGIC",
    "VERSION",
    "HEADER_BYTES",
    "EdgeFileWriter",
    "EdgeFileReader",
    "write_edge_file",
    "read_edge_file",
]

MAGIC = b"ADWSTRM\x00"
VERSION = 1
HEADER_BYTES = 64
DTYPE_INT32_PAIR = 1
_ROW_BYTES = 8  # 2 * int32
_HEADER_FMT = "<8sIIQQQ"  # magic, version, dtype, m, n, flags


def _pack_header(m: int, n: int, flags: int = 0) -> bytes:
    head = struct.pack(_HEADER_FMT, MAGIC, VERSION, DTYPE_INT32_PAIR, m, n, flags)
    return head.ljust(HEADER_BYTES, b"\x00")


def _unpack_header(head: bytes, path: str) -> tuple[int, int, int]:
    if len(head) < HEADER_BYTES:
        raise ValueError(f"{path}: truncated header ({len(head)} < {HEADER_BYTES} bytes)")
    magic, version, dtype, m, n, flags = struct.unpack_from(_HEADER_FMT, head)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an ADWISE edge-stream file (magic {magic!r})")
    if version != VERSION:
        raise ValueError(
            f"{path}: unsupported edge-stream format version {version} "
            f"(this build reads version {VERSION})"
        )
    if dtype != DTYPE_INT32_PAIR:
        raise ValueError(f"{path}: unknown payload dtype code {dtype}")
    return int(m), int(n), int(flags)


class EdgeFileWriter:
    """Streaming writer: append (c, 2) int32 chunks, header patched on close.

    ``num_vertices=None`` infers n = max vertex id + 1 over everything
    appended (0 for an empty file). Usable as a context manager.
    """

    def __init__(self, path: str, num_vertices: Optional[int] = None):
        self.path = path
        self._n = num_vertices
        self._max_id = -1
        self._m = 0
        self._f: Optional[io.BufferedWriter] = open(path, "wb")
        self._f.write(_pack_header(0, 0))

    def append(self, edges: np.ndarray) -> None:
        edges = np.ascontiguousarray(edges, dtype=np.int32)
        assert edges.ndim == 2 and edges.shape[1] == 2, edges.shape
        if self._f is None:
            raise ValueError("writer is closed")
        if len(edges) == 0:
            return
        if self._n is None:
            self._max_id = max(self._max_id, int(edges.max()))
        self._f.write(edges.tobytes())
        self._m += len(edges)

    @property
    def num_edges(self) -> int:
        return self._m

    def close(self) -> None:
        if self._f is None:
            return
        n = self._n if self._n is not None else self._max_id + 1
        self._f.seek(0)
        self._f.write(_pack_header(self._m, n))
        self._f.close()
        self._f = None

    def abort(self) -> None:
        """Discard a partial file (the header is never finalized)."""
        if self._f is not None:
            self._f.close()
            self._f = None
        try:
            os.remove(self.path)
        except OSError:
            pass

    def __enter__(self) -> "EdgeFileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # A raised body must not leave a valid-looking truncated file behind
        # (a later run would silently partition the partial stream).
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class EdgeFileReader:
    """Bounded-chunk reader over a binary edge-stream file (or a row range).

    ``read(start, count)`` returns an owned (count, 2) int32 array — O(count)
    memory per call; ``chunks(c)`` iterates the whole range in c-row chunks.
    ``sub(start, stop)`` / ``split(z)`` present row sub-ranges as readers with
    local 0-based addressing (the spotlight per-instance byte ranges; ``z``
    uses the same ceil(m/z) boundaries as ``EdgeStream.split_bounds``).

    IO accounting for the latency model: ``rows_read`` / ``read_seconds``
    accumulate across every ``read`` (shared by all ``sub`` views, so a
    driver's total measured ingest wall is the root reader's counter).

    ``mmap=True`` exposes the payload as a read-only ``np.memmap`` instead
    (zero-copy; resident set then belongs to the page cache, not the process
    heap — reads still return views, so the counting tests use the default).
    """

    def __init__(self, path: str, *, mmap: bool = False):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(HEADER_BYTES)
        m, n, flags = _unpack_header(head, path)
        payload = os.path.getsize(path) - HEADER_BYTES
        if payload < m * _ROW_BYTES:
            raise ValueError(
                f"{path}: payload truncated ({payload} bytes < {m} rows)"
            )
        self.num_edges = m
        self.num_vertices = n
        self.flags = flags
        self._mmap: Optional[np.memmap] = None
        self._f: Optional[io.BufferedReader] = None
        if mmap:
            self._mmap = np.memmap(
                path, dtype=np.int32, mode="r", offset=HEADER_BYTES, shape=(m, 2)
            )
        else:
            self._f = open(path, "rb")
        # IO accounting (shared with sub-readers).
        self.rows_read = 0
        self.read_seconds = 0.0

    # -- core access -------------------------------------------------------
    def read(self, start: int, count: int) -> np.ndarray:
        """(count', 2) int32 rows [start, start+count) clipped to the file."""
        start = max(0, int(start))
        stop = min(self.num_edges, start + max(0, int(count)))
        c = stop - start
        if c <= 0:
            return np.zeros((0, 2), np.int32)
        t0 = time.perf_counter()
        if self._mmap is not None:
            out = np.asarray(self._mmap[start:stop])
        else:
            self._f.seek(HEADER_BYTES + start * _ROW_BYTES)
            out = np.fromfile(self._f, dtype=np.int32, count=c * 2).reshape(c, 2)
        self.read_seconds += time.perf_counter() - t0
        self.rows_read += c
        return out

    def chunks(self, chunk_edges: int) -> Iterator[np.ndarray]:
        assert chunk_edges >= 1
        for start in range(0, self.num_edges, chunk_edges):
            yield self.read(start, chunk_edges)

    def read_all(self) -> np.ndarray:
        return self.read(0, self.num_edges)

    # -- range views -------------------------------------------------------
    def sub(self, start: int, stop: int) -> "EdgeFileSubReader":
        """Reader over rows [start, stop) with local 0-based addressing."""
        assert 0 <= start <= stop <= self.num_edges, (start, stop, self.num_edges)
        return EdgeFileSubReader(self, start, stop)

    def split(self, z: int) -> Sequence["EdgeFileSubReader"]:
        """z contiguous sub-readers over the ceil(m/z) instance boundaries
        shared with ``EdgeStream.split_bounds`` / ``split_padded``."""
        from repro_torch.graph.stream import EdgeStream

        bounds = EdgeStream.split_bounds(self.num_edges, z)
        return [self.sub(int(bounds[i]), int(bounds[i + 1])) for i in range(z)]

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        self._mmap = None

    def __enter__(self) -> "EdgeFileReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EdgeFileSubReader:
    """View over a row range of a parent reader (local 0-based rows).

    Duck-types the full reader surface the out-of-core driver uses:
    ``num_edges``, ``num_vertices``, ``read``, ``chunks``, ``read_all``,
    ``sub``, ``split``, and the ``rows_read`` / ``read_seconds`` accounting
    (which flows to — and reads from — the root reader).
    """

    def __init__(self, parent, start: int, stop: int):
        self._parent = parent
        self._start = start
        self.num_edges = stop - start
        self.num_vertices = parent.num_vertices
        self.path = getattr(parent, "path", None)

    @property
    def rows_read(self) -> int:
        return self._parent.rows_read

    @property
    def read_seconds(self) -> float:
        return self._parent.read_seconds

    def read(self, start: int, count: int) -> np.ndarray:
        start = max(0, int(start))
        count = min(max(0, int(count)), max(self.num_edges - start, 0))
        return self._parent.read(self._start + start, count)

    def chunks(self, chunk_edges: int) -> Iterator[np.ndarray]:
        assert chunk_edges >= 1
        for start in range(0, self.num_edges, chunk_edges):
            yield self.read(start, chunk_edges)

    def read_all(self) -> np.ndarray:
        return self.read(0, self.num_edges)

    def sub(self, start: int, stop: int) -> "EdgeFileSubReader":
        assert 0 <= start <= stop <= self.num_edges
        return EdgeFileSubReader(self._parent, self._start + start, self._start + stop)

    def split(self, z: int) -> Sequence["EdgeFileSubReader"]:
        from repro_torch.graph.stream import EdgeStream

        bounds = EdgeStream.split_bounds(self.num_edges, z)
        return [self.sub(int(bounds[i]), int(bounds[i + 1])) for i in range(z)]


def write_edge_file(path: str, edges: np.ndarray, num_vertices: int) -> None:
    """One-shot convenience: write a resident (m, 2) array as an edge file."""
    with EdgeFileWriter(path, num_vertices=num_vertices) as w:
        w.append(np.asarray(edges))


def read_edge_file(path: str) -> tuple[np.ndarray, int]:
    """One-shot convenience: load the whole file (resident)."""
    with EdgeFileReader(path) as r:
        return r.read_all(), r.num_vertices
