"""One-pass text → binary edge-stream ingestion (SNAP-style edge lists).

Copy of the JAX package's ``graph/io/ingest.py`` (numpy and the standard library
only).

Accepts the format real graph dumps (SNAP Orkut / LiveJournal / web graphs)
ship in: one ``u v`` pair per line, arbitrary whitespace between fields,
``#`` / ``%`` / ``//`` comment lines, blank lines, optional trailing fields
(weights / timestamps — ignored). Edges keep file order (stream order),
self-loops and duplicates are preserved — the file IS the stream, cleaning
it is a policy decision that belongs to the consumer, not the ingester.

Two parsers, one semantics:

* ``parser="bytes"`` (default) — the vectorized fast path: the file is read
  in newline-aligned binary blocks, each block is dropped into one
  ``np.frombuffer`` uint8 array, and comment/blank classification, token
  boundaries, and integer values all come out of whole-block numpy ops (no
  per-line Python). A block containing anything the vector path does not
  model exactly (a ``+`` sign, underscore separators, non-ASCII digits,
  malformed rows) falls back to the per-line parser *for that block*, which
  reproduces the reference semantics — including the exact ``file:line``
  error messages — bit for bit.
* ``parser="python"`` — the original per-line ``str.split`` loop, kept as
  the parity oracle (tests assert both parsers produce identical binaries
  and reports on the same input).

Parity bound: on a file with ONE problem, both parsers raise the identical
error (message, id, exact line). When several *distinct* problems coexist
tens of thousands of lines apart, which one is reported first depends on
chunk granularity — inherently so: the reference parser itself reports a
different error for different ``chunk_lines`` settings (parse errors raise
while batching, id-policy errors raise per flushed batch). Each parser
still reports a real problem with its exact line.

Memory is O(chunk) either way: blocks/batches are parsed into one (c, 2)
array and appended to an :class:`repro_torch.graph.io.format.EdgeFileWriter`
(which back-patches m/n on close). With ``relabel=True`` vertex ids are
mapped to a dense [0, n) space in first-appearance order (the id map is
O(V) — vertex-sized state, like every streaming partitioner's tables;
*edge* memory stays bounded by the chunk).
"""
from __future__ import annotations

import dataclasses
import io
import os
import time
import warnings
from typing import Iterator, Optional

import numpy as np

from repro_torch.graph.io.format import EdgeFileWriter, _pack_header

__all__ = ["IngestReport", "ingest_text"]

_COMMENT_PREFIXES = ("#", "%", "//")
_I32_MAX = np.iinfo(np.int32).max
_POW10 = 10 ** np.arange(19, dtype=np.int64)  # int64 holds < 9.3e18


def _classify_line(line: str) -> str:
    """'blank' | 'comment' | 'data' — THE reference classification. Every
    per-line code path (the python parser, the bytes tiers' fallback, and
    the error-line resolver) must share this single definition; the
    vectorized byte-level classification in :func:`_parse_block_bytes`
    mirrors it and is pinned to it by the parity tests."""
    s = line.strip()
    if not s:
        return "blank"
    if s.startswith(_COMMENT_PREFIXES):
        return "comment"
    return "data"


class _DenseIdMap:
    """Incremental raw-id → dense-id map in global first-appearance order.

    Fully vectorized (a sorted key table + ``searchsorted``, merged as new
    ids appear) — a per-element dict loop would cost ~2 Python lookups per
    edge, dwarfing the parse time on real SNAP-scale inputs.
    """

    def __init__(self):
        self._keys = np.empty((0,), np.int64)  # sorted raw ids
        self._vals = np.empty((0,), np.int64)  # dense id per sorted key

    def __len__(self) -> int:
        return len(self._keys)

    def translate(self, flat: np.ndarray) -> np.ndarray:
        flat = np.asarray(flat, np.int64)
        if len(self._keys):
            pos = np.searchsorted(self._keys, flat)
            pos_c = np.minimum(pos, len(self._keys) - 1)
            known = self._keys[pos_c] == flat
        else:
            known = np.zeros(flat.shape, bool)
        if not known.all():
            fresh = flat[~known]
            # Unique new ids, ordered by first appearance within this chunk
            # (earlier chunks are already in the table, so this IS the global
            # first-appearance order).
            uniq, first = np.unique(fresh, return_index=True)
            order = np.argsort(first, kind="stable")
            new_keys = uniq[order]
            new_vals = len(self._keys) + np.arange(len(new_keys), dtype=np.int64)
            keys = np.concatenate([self._keys, new_keys])
            vals = np.concatenate([self._vals, new_vals])
            resort = np.argsort(keys, kind="stable")
            self._keys, self._vals = keys[resort], vals[resort]
        return self._vals[np.searchsorted(self._keys, flat)]


@dataclasses.dataclass(frozen=True)
class IngestReport:
    """What one ingest pass did (``bytes_read`` drives the MB/s bench)."""

    num_edges: int
    num_vertices: int
    lines: int
    comment_lines: int
    blank_lines: int
    bytes_read: int
    wall_s: float
    relabeled: bool
    parser: str = "python"


def _parse_batch(batch: list[tuple[int, str]], path: str) -> np.ndarray:
    """Parse (lineno, line) pairs into an (c, 2) int64 array (the reference
    per-line parser — also the fallback target of the vectorized path)."""
    rows = np.empty((len(batch), 2), dtype=np.int64)
    for i, (lineno, line) in enumerate(batch):
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(
                f"{path}:{lineno}: expected at least two fields, got {line.strip()!r}"
            )
        try:
            rows[i, 0] = int(parts[0])
            rows[i, 1] = int(parts[1])
        except (ValueError, OverflowError):
            raise ValueError(
                f"{path}:{lineno}: non-integer vertex id in {line.strip()!r}"
            ) from None
    return rows


# ----------------------------------------------------------------------------
# Vectorized bytes-level block parser
# ----------------------------------------------------------------------------


def _parse_block_python(
    block: bytes, lineno0: int, path: str
) -> tuple[np.ndarray, int, int, int]:
    """Reference per-line parse of one newline-terminated block; returns
    (rows int64[c, 2], lines, comments, blanks). Raises the exact reference
    errors (with absolute line numbers) on malformed content."""
    # Universal-newline translation, exactly as text-mode file iteration
    # does it (\r\n and lone \r both become \n; splitlines() would also
    # split on \v / \f / \x85, which file iteration does not).
    text = block.decode().replace("\r\n", "\n").replace("\r", "\n")
    batch: list[tuple[int, str]] = []
    comments = blanks = nlines = 0
    for i, line in enumerate(text.split("\n")[:-1]):
        nlines += 1
        cls = _classify_line(line)
        if cls == "blank":
            blanks += 1
        elif cls == "comment":
            comments += 1
        else:
            batch.append((lineno0 + i, line))
    rows = _parse_batch(batch, path) if batch else np.empty((0, 2), np.int64)
    return rows, nlines, comments, blanks


# Byte-class lookup table: one gather replaces a cascade of comparisons.
_SEP_LUT = np.zeros(256, bool)
_SEP_LUT[[9, 10, 11, 12, 13, 32]] = True  # \t \n \v \f \r ' '


def _universal_nl_idx(a: np.ndarray) -> np.ndarray:
    """Positions of universal-newline terminators in a byte array, exactly
    as text-mode iteration counts lines: \\n terminates, a lone \\r
    terminates, \\r\\n counts once (its \\r half is plain whitespace then).
    Blocks only ever split at \\n, so a \\r\\n pair is never torn apart.
    Block segmentation and token parsing MUST share this definition — the
    dirty-segment line offsets are computed from it."""
    is_lf = a == 10
    is_cr = a == 13
    before_lf = np.empty_like(is_lf)
    before_lf[-1] = False
    before_lf[:-1] = is_lf[1:]
    return np.flatnonzero(is_lf | (is_cr & ~before_lf))

# Bytes a block may contain for the tier-0 (np.loadtxt C tokenizer) path:
# digits, signs, and ASCII whitespace sans \r. Anything else — comment
# chars, '.', '_', letters — means loadtxt could diverge from the reference
# semantics, so such blocks take the numpy tier instead. One C-speed
# ``bytes.translate`` scan decides.
_STRICT_BYTES = bytes(sorted(b"0123456789+-\t\n\x0b\x0c "))
_WS_BYTES = b" \t\x0b\x0c\n"


_STRICT_LUT = np.zeros(256, bool)
_STRICT_LUT[list(_STRICT_BYTES)] = True


def _parse_strict(block: bytes):
    """Tier-0 parse via numpy's C loadtxt tokenizer (~10-20x the per-line
    reference parser) for a segment already verified to contain ONLY the
    strict digit/sign/whitespace byte set. Returns None when loadtxt cannot
    prove equivalence after all (a row it rejects, or an overflow) — the
    caller re-parses the segment through the exact tiers, which own ALL
    error reporting (this tier never raises toward the user).

    Within the strict byte set the semantics provably coincide: no comment
    or blank-classification ambiguity can occur, ``usecols=(0, 1)`` takes
    the first two whitespace fields exactly like ``line.split()[:2]``, and
    float64 holds every integer below 4e15 exactly.
    """
    nlines = block.count(b"\n")
    if not block.strip(_WS_BYTES):
        return np.empty((0, 2), np.int64), nlines, 0, nlines
    try:
        with warnings.catch_warnings():
            # loadtxt falls back to a *silently wrapping* float path for
            # ints beyond int64 and warns (DeprecationWarning today,
            # FutureWarning is the usual next stop); escalating exactly
            # those makes overflow land in the exact tiers instead, while
            # benign warning categories cannot silently demote every clean
            # block to the slow tiers. The overflow parity test pins this:
            # if numpy moves the warning category, that test fails loudly.
            warnings.simplefilter("error", DeprecationWarning)
            warnings.simplefilter("error", FutureWarning)
            rows = np.loadtxt(
                io.BytesIO(block), dtype=np.int64, usecols=(0, 1), ndmin=2,
                comments=None,
            )
    except Exception:
        return None  # the exact tiers reproduce the reference error
    return rows, nlines, 0, nlines - len(rows)


def _parse_block(block: bytes, lineno0: int, path: str):
    """Parse one newline-terminated block through the fastest applicable
    tier. A fully strict block goes straight to loadtxt; otherwise the
    *lines* containing non-strict bytes (comments, \\r, exotic tokens) are
    segmented out — each maximal dirty run parses through the vectorized
    numpy tier (tier 1, which itself may delegate to the per-line reference
    parser), while the clean runs between them still ride tier 0. A SNAP
    file's ``#`` header therefore costs a few header-sized segments, not the
    whole surrounding block.
    """
    clean = block.find(b"\r") < 0 and not block.translate(None, _STRICT_BYTES)
    if clean:
        parsed = _parse_strict(block)
        return parsed if parsed is not None else _parse_block_bytes(
            block, lineno0, path
        )
    a = np.frombuffer(block, np.uint8)
    if (a >= 128).any():
        # The text-mode reference parser decodes every byte of the file;
        # invalid UTF-8 must fail here exactly as it fails there (valid
        # non-ASCII text — accented comments, unicode whitespace — then
        # flows through the dirty-line tiers, whose python fallback applies
        # the reference str semantics).
        block.decode()
    ok = _STRICT_LUT[a]
    # Segment in UNIVERSAL-newline space (lone \r terminates a line in text
    # mode): line numbers handed to sub-parsers must match the reference
    # parser's counting even when \r-terminated lines precede a bad line.
    # Every \r byte is outside the strict set, so \r-bearing lines are
    # always dirty lines — clean segments never contain one.
    nl_idx = _universal_nl_idx(a)
    bad_line = np.unique(np.searchsorted(nl_idx, np.flatnonzero(~ok)))
    runs = np.split(bad_line, np.flatnonzero(np.diff(bad_line) > 1) + 1)
    segs = []  # (line0, line1, dirty)
    cur = 0
    for r in runs:
        l0, l1 = int(r[0]), int(r[-1]) + 1
        if l0 > cur:
            segs.append((cur, l0, False))
        segs.append((l0, l1, True))
        cur = l1
    if cur < len(nl_idx):
        segs.append((cur, len(nl_idx), False))
    rows_parts, nlines = [], 0
    comments = blanks = 0
    for l0, l1, dirty in segs:
        b0 = 0 if l0 == 0 else int(nl_idx[l0 - 1]) + 1
        b1 = int(nl_idx[l1 - 1]) + 1
        seg = block[b0:b1]
        if not seg.endswith(b"\n"):
            # A lone-\r terminator ended this (necessarily dirty) segment;
            # completing it with \n forms a \r\n pair — still one line.
            seg += b"\n"
        parsed = None if dirty else _parse_strict(seg)
        if parsed is None:
            parsed = _parse_block_bytes(seg, lineno0 + l0, path)
        rows, nl, nc, nb = parsed
        rows_parts.append(rows)
        nlines += nl
        comments += nc
        blanks += nb
    rows = (
        np.concatenate(rows_parts) if rows_parts else np.empty((0, 2), np.int64)
    )
    return rows, nlines, comments, blanks


def _token_values(a: np.ndarray, ts_s: np.ndarray, te_s: np.ndarray):
    """int64 values of the tokens spanning [ts_s, te_s] bytes of ``a``, or
    None when any token is not ``-?[0-9]{1,18}`` (fallback trigger).

    Right-aligned digit matrix: one broadcast gather pulls every token's
    last ``lmax`` bytes into an (nt, lmax) block (column j = the 10^j
    place), masked by token length and contracted against the power table —
    a handful of whole-matrix C ops, no per-character index arrays and no
    per-token Python.
    """
    nt = len(ts_s)
    neg = a[ts_s] == 45
    if nt == 0:
        return np.zeros(0, np.int64), neg
    length = te_s - ts_s + 1 - neg
    lmax = int(length.max())
    if int(length.min()) < 1 or lmax > 18:
        return None, None  # lone '-' or an id beyond the int64 digit budget
    # 9 digits fit int32 — half the matrix traffic for typical SNAP ids.
    dt = np.int64 if lmax > 9 else np.int32
    places = np.arange(lmax)
    # Negative indices only occur in masked (j >= length) cells and wrap
    # safely within the block.
    digits = a[te_s[:, None] - places[None, :]].astype(dt)
    digits -= 48
    mask = places[None, :] < length[:, None]
    if (((digits < 0) | (digits > 9)) & mask).any():
        # '+' signs, '_' separators, unicode digits, stray punctuation — the
        # reference parser decides (accepts or raises) per line.
        return None, None
    np.multiply(digits, mask, out=digits, casting="unsafe")
    vals = (digits @ _POW10[:lmax].astype(dt)).astype(np.int64)
    return np.where(neg, -vals, vals), neg


def _parse_block_bytes(
    block: bytes, lineno0: int, path: str
) -> tuple[np.ndarray, int, int, int]:
    """Vectorized parse of one newline-terminated block.

    One ``np.frombuffer`` view; newline positions, token boundaries,
    comment/blank classes, and the integer values themselves are all
    whole-block numpy ops. Anything the vector model does not cover exactly
    (``+`` signs, ``_`` separators, unicode digits, malformed rows,
    > 18-digit ids) delegates the block to :func:`_parse_block_python`,
    which preserves the reference semantics and error messages.
    """
    a = np.frombuffer(block, np.uint8)
    assert a[-1] == 10, "blocks must be newline-terminated"
    if block.find(b"\r") < 0:
        nl_idx = np.flatnonzero(a == 10)
    else:
        nl_idx = _universal_nl_idx(a)  # rare path: \r-bearing segment
    nlines = len(nl_idx)
    tok = ~_SEP_LUT[a]
    dt = np.diff(tok.view(np.int8))
    tr = np.flatnonzero(dt)  # one pass finds every token boundary
    sign = dt[tr]
    ts = tr[sign == 1] + 1  # first byte of every token
    if tok[0]:
        ts = np.concatenate([np.zeros(1, ts.dtype), ts])
    te = tr[sign == -1]  # last byte (block ends with \n: every token closes)
    if len(ts) == 0:
        return np.empty((0, 2), np.int64), nlines, 0, nlines
    # Tokens per line, line-major: the number of token starts before each
    # terminator is cumulative, so one searchsorted of the (smaller) line
    # array into the token starts yields every per-line count.
    cnt = np.searchsorted(ts, nl_idx)
    line_counts = np.diff(cnt, prepend=0)
    nonblank = line_counts > 0
    n_nonblank = int(nonblank.sum())
    blanks = nlines - n_nonblank
    first_tok = (cnt - line_counts)[nonblank]  # first token index per line
    # Comment classification off the first token: '#', '%', or '//' (the
    # second byte is in-bounds — every line ends with \n past the token).
    c0 = a[ts[first_tok]]
    comment = (c0 == 35) | (c0 == 37) | ((c0 == 47) & (a[ts[first_tok] + 1] == 47))
    comments = int(comment.sum())
    if comments == n_nonblank:
        return np.empty((0, 2), np.int64), nlines, comments, blanks

    counts = line_counts[nonblank]
    if comments == 0 and len(ts) == 2 * n_nonblank and (counts == 2).all():
        # Dominant clean shape: every non-blank line is exactly ``u v`` —
        # skip the per-line rank machinery entirely.
        vals, _ = _token_values(a, ts, te)
        if vals is None:
            return _parse_block_python(block, lineno0, path)
        return vals.reshape(-1, 2), nlines, comments, blanks

    data_line = ~comment
    if (counts[data_line] < 2).any():
        # A data line with < 2 fields — the reference parser raises with the
        # exact file:line message.
        return _parse_block_python(block, lineno0, path)
    rank = np.arange(len(ts)) - np.repeat(first_tok, counts)
    sel = np.repeat(data_line, counts) & (rank < 2)
    vals, _ = _token_values(a, ts[sel], te[sel])
    if vals is None:
        return _parse_block_python(block, lineno0, path)
    return vals.reshape(-1, 2), nlines, comments, blanks


def _newline_blocks(f, chunk_bytes: int) -> Iterator[bytes]:
    """Yield newline-terminated byte blocks of ~chunk_bytes (a final line
    without a trailing newline is completed with one)."""
    rem = b""
    while True:
        buf = f.read(chunk_bytes)
        if not buf:
            if rem:
                yield rem + b"\n"
            return
        if rem:
            buf = rem + buf
        cut = buf.rfind(b"\n")
        if cut < 0:
            rem = buf
            continue
        yield buf[: cut + 1]
        rem = buf[cut + 1 :]


# ----------------------------------------------------------------------------
# The ingest driver
# ----------------------------------------------------------------------------


class _Densifier:
    """Shared id policy of both parsers: relabel to dense first-appearance
    ids, or validate raw ids against int32 / a pinned n.

    ``lineno_of(i)`` maps the i-th data row of the batch/block to its exact
    file line — resolved only on the error path, so the happy path stays
    vectorized while every id-policy error points at the offending line
    (identically for both parsers)."""

    def __init__(self, src: str, relabel: bool, num_vertices: Optional[int]):
        self.src = src
        self.relabel = relabel
        self.num_vertices = num_vertices
        self.max_id = -1
        self.id_map = _DenseIdMap()

    def __call__(self, rows: np.ndarray, lineno_of) -> np.ndarray:
        if self.relabel:
            return self.id_map.translate(rows.reshape(-1)).reshape(-1, 2)
        if not rows.size:
            return rows
        # One combined mask, first violation in STREAM order: the raised
        # error is then independent of batch/block granularity, so both
        # parsers report the identical id and line no matter how their
        # chunking differs.
        flat = rows.reshape(-1)
        hi = _I32_MAX if self.num_vertices is None else min(
            _I32_MAX, self.num_vertices
        )
        bad = np.flatnonzero((flat < 0) | (flat >= hi))
        if len(bad):
            i = int(bad[0])
            v = int(flat[i])
            if v < 0:
                raise ValueError(
                    f"{self.src}: negative vertex id {v} near line "
                    f"{lineno_of(i // 2)} (pass relabel=True)"
                )
            if v >= _I32_MAX:
                raise ValueError(
                    f"{self.src}: vertex id {v} overflows int32 "
                    "(pass relabel=True to densify)"
                )
            raise ValueError(
                f"{self.src}: vertex id {v} >= pinned "
                f"num_vertices={self.num_vertices} near line "
                f"{lineno_of(i // 2)}"
            )
        self.max_id = max(self.max_id, int(rows.max()))
        return rows


def _data_lineno_resolver(block: bytes, lineno0: int):
    """Error-path-only map from data-row index (within one block) to its
    absolute file line, replaying the reference classification (universal
    newlines, comment/blank skipping) — every tier yields exactly one row
    per data line, so the i-th row IS the i-th data line."""

    def lineno_of(i: int) -> int:
        text = block.decode().replace("\r\n", "\n").replace("\r", "\n")
        count = 0
        for j, line in enumerate(text.split("\n")[:-1]):
            if _classify_line(line) != "data":
                continue
            if count == i:
                return lineno0 + j
            count += 1
        return lineno0

    return lineno_of


def ingest_text(
    src: str,
    dst: str,
    *,
    relabel: bool = False,
    num_vertices: Optional[int] = None,
    chunk_lines: int = 1 << 16,
    parser: str = "bytes",
    chunk_bytes: int = 1 << 24,
) -> IngestReport:
    """Convert a text edge list at ``src`` into a binary edge file at ``dst``.

    Args:
      relabel: map vertex ids to a dense [0, n) space in first-appearance
        order (required for files with sparse / huge / negative ids).
        Without it, ids must fit non-negative int32 and n is inferred as
        ``max id + 1``.
      num_vertices: pin n instead of inferring it (ignored with ``relabel``,
        where n is the number of distinct ids).
      chunk_lines: lines parsed per batch under ``parser="python"`` — the
        O(chunk) memory bound of the reference parser.
      parser: ``"bytes"`` (vectorized block parser, the default) or
        ``"python"`` (the reference per-line loop — the parity oracle).
      chunk_bytes: bytes per block under ``parser="bytes"`` — the O(chunk)
        memory bound of the fast parser.

    Returns an :class:`IngestReport`; raises ``ValueError`` on malformed
    lines (with file:line in the message) and on out-of-range ids.
    """
    if parser not in ("bytes", "python"):
        raise ValueError(f"parser must be 'bytes' or 'python', got {parser!r}")
    t0 = time.perf_counter()
    lines = comments = blanks = 0
    densify = _Densifier(src, relabel, num_vertices)

    if parser == "bytes":
        with open(src, "rb") as f, EdgeFileWriter(dst, num_vertices=None) as w:
            for block in _newline_blocks(f, chunk_bytes):
                rows, nlines, ncomment, nblank = _parse_block(
                    block, lines + 1, src
                )
                if len(rows):
                    w.append(
                        densify(
                            rows, _data_lineno_resolver(block, lines + 1)
                        ).astype(np.int32)
                    )
                lines += nlines
                comments += ncomment
                blanks += nblank
            m = w.num_edges
    else:
        with open(src, "r") as f, EdgeFileWriter(dst, num_vertices=None) as w:
            batch: list[tuple[int, str]] = []
            for line in f:
                lines += 1
                cls = _classify_line(line)
                if cls == "blank":
                    blanks += 1
                    continue
                if cls == "comment":
                    comments += 1
                    continue
                batch.append((lines, line))
                if len(batch) >= chunk_lines:
                    rows = densify(_parse_batch(batch, src),
                                   lambda i, b=batch: b[i][0])
                    w.append(rows.astype(np.int32))
                    batch = []
            if batch:
                rows = densify(_parse_batch(batch, src),
                               lambda i, b=batch: b[i][0])
                w.append(rows.astype(np.int32))
            m = w.num_edges
    # The writer inferred n = max id + 1 (== max_id + 1 here); re-patch when
    # the caller pinned n or relabeling fixed it as the distinct-id count.
    if relabel:
        n_final = len(densify.id_map)
        _patch_header(dst, m, n_final)
    elif num_vertices is not None:
        n_final = num_vertices
        _patch_header(dst, m, n_final)
    else:
        n_final = densify.max_id + 1
    return IngestReport(
        num_edges=m,
        num_vertices=n_final,
        lines=lines,
        comment_lines=comments,
        blank_lines=blanks,
        bytes_read=os.path.getsize(src),
        wall_s=time.perf_counter() - t0,
        relabeled=relabel,
        parser=parser,
    )


def _patch_header(path: str, m: int, n: int) -> None:
    with open(path, "r+b") as f:
        f.write(_pack_header(m, n))
