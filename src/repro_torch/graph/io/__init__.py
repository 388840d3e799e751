"""Out-of-core graph I/O: binary edge-stream files, text ingest, external shuffle.

Copy of the JAX package's ``graph/io/__init__.py`` (numpy and the standard library
only).

The disk-backed substrate for graphs that do not fit in memory (ROADMAP:
real, huge workloads). Three pieces:

* :mod:`repro_torch.graph.io.format` — versioned binary edge-stream format
  (64-byte header: magic / version / dtype / m / n; mmap-able int32 payload)
  with bounded-chunk writer/reader classes and row-range sub-readers (the
  spotlight per-instance byte ranges).
* :mod:`repro_torch.graph.io.ingest` — one-pass SNAP-style text → binary ingester
  (comments, blank lines, whitespace variants, optional dense relabeling,
  inferred n) with O(chunk) edge memory. Three parse tiers behind one
  semantics: a C-tokenizer fast path for strict numeric blocks, a vectorized
  ``np.frombuffer`` block parser, and the per-line reference loop (the
  parity oracle, ``parser="python"``).
* :mod:`repro_torch.graph.io.shuffle` — two-pass external shuffle, O(chunk) memory
  as a *hard* bound (oversized buckets recursively re-scatter; the realized
  profile comes back as a :class:`ShuffleReport`), for stream-order
  sensitivity experiments on file-resident graphs.

``repro_torch.core.oocore.partition_file`` drives any registry partitioner over an
:class:`EdgeFileReader` with bounded resident edge memory.
"""
from repro_torch.graph.io.format import (
    HEADER_BYTES,
    MAGIC,
    VERSION,
    EdgeFileReader,
    EdgeFileWriter,
    read_edge_file,
    write_edge_file,
)
from repro_torch.graph.io.ingest import IngestReport, ingest_text
from repro_torch.graph.io.shuffle import ShuffleReport, shuffle_file

__all__ = [
    "MAGIC",
    "VERSION",
    "HEADER_BYTES",
    "EdgeFileReader",
    "EdgeFileWriter",
    "read_edge_file",
    "write_edge_file",
    "IngestReport",
    "ingest_text",
    "ShuffleReport",
    "shuffle_file",
]
