"""The port's graph-file substrate (``repro_torch.graph.io``, the file
methods of ``EdgeStream`` and the chunked metrics) against the JAX
package's ``repro.graph.io``.

Mirrors ``tests/test_io.py``, each case held against ``repro`` on the same
input: the same bytes written, the same rows read through ``read`` /
``chunks`` / ``sub`` / ``split``, the same header rejections, the three
ingest tiers (the ``np.loadtxt`` fast path on strict blocks, the
``np.frombuffer`` block parser, ``parser="python"``) giving identical
binaries, :class:`IngestReport` fields and error messages, ``shuffle_file``
giving the same output and :class:`ShuffleReport` for a seed, and the
chunked metrics equal to the in-memory ones.
"""
import dataclasses
import os
import struct

import numpy as np
import pytest

from repro.graph import EdgeStream as JaxStream
from repro.graph import metrics as jmetrics
from repro.graph import io as jio
import repro.graph.io.shuffle as jshuffle
from repro_torch.graph import (
    EdgeStream,
    make_graph,
    partition_balance,
    quality_from_chunks,
    replica_sets_from_assignment,
    replica_sets_from_chunks,
    replication_degree,
    rmat,
)
from repro_torch.graph import io as pio
import repro_torch.graph.io.shuffle as pshuffle

from conftest import random_edges


def _rng_edges(seed, n, m):
    return random_edges(np.random.default_rng(seed), n, m)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    edges, n = make_graph("tiny_social", seed=4)
    path = str(tmp_path_factory.mktemp("tio") / "g.adw")
    pio.write_edge_file(path, edges, n)
    return path, edges, n


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------------------------------
# Binary format
# ----------------------------------------------------------------------------


def test_public_names_and_constants_equal_repro():
    assert pio.__all__ == jio.__all__
    assert (pio.MAGIC, pio.VERSION, pio.HEADER_BYTES) == (jio.MAGIC, jio.VERSION, jio.HEADER_BYTES)


@pytest.mark.parametrize("pinned", [False, True])
def test_written_bytes_equal_repro(tmp_path, pinned):
    chunks = [_rng_edges(s, 50, 40) for s in range(5)]
    edges = np.concatenate(chunks)
    n = 77 if pinned else None
    out = {}
    for name, mod in (("port", pio), ("jax", jio)):
        one = str(tmp_path / f"{name}.adw")
        mod.write_edge_file(one, edges, n if pinned else int(edges.max()) + 1)
        streamed = str(tmp_path / f"{name}.s.adw")
        with mod.EdgeFileWriter(streamed, num_vertices=n) as w:
            for c in chunks:
                w.append(c)
        out[name] = (_bytes(one), _bytes(streamed))
    assert out["port"] == out["jax"]
    got, n_got = pio.read_edge_file(str(tmp_path / "port.s.adw"))
    assert (got == edges).all() and n_got == (77 if pinned else int(edges.max()) + 1)


@pytest.mark.parametrize("mmap", [False, True])
def test_reads_equal_repro(graph_file, mmap):
    path, edges, n = graph_file
    m = len(edges)
    with pio.EdgeFileReader(path, mmap=mmap) as r, jio.EdgeFileReader(path, mmap=mmap) as j:
        assert (r.num_edges, r.num_vertices) == (j.num_edges, j.num_vertices) == (m, n)
        assert (r.read_all() == j.read_all()).all()
        for start, count in ((100, 37), (m - 3, 100), (m + 5, 10), (0, 0)):
            np.testing.assert_array_equal(r.read(start, count), j.read(start, count))
        for a, b in zip(r.chunks(251), j.chunks(251), strict=True):
            np.testing.assert_array_equal(a, b)
        assert r.rows_read == j.rows_read


@pytest.mark.parametrize("z", [1, 3, 7])
def test_sub_and_split_equal_repro(graph_file, z):
    path, edges, _ = graph_file
    bounds = EdgeStream.split_bounds(len(edges), z)
    np.testing.assert_array_equal(bounds, JaxStream.split_bounds(len(edges), z))
    with pio.EdgeFileReader(path) as r, jio.EdgeFileReader(path) as j:
        for i, (s, t) in enumerate(zip(r.split(z), j.split(z), strict=True)):
            assert s.num_edges == t.num_edges == int(bounds[i + 1] - bounds[i])
            np.testing.assert_array_equal(s.read_all(), t.read_all())
            if s.num_edges >= 2:
                np.testing.assert_array_equal(s.sub(1, s.num_edges).read_all(),
                                              t.sub(1, t.num_edges).read_all())
            for a, b in zip(s.chunks(100), t.chunks(100), strict=True):
                np.testing.assert_array_equal(a, b)
        # Sub-reader IO flows to the root counters, as in repro.
        assert r.rows_read == j.rows_read and r.read_seconds >= 0.0


_HEADER_FMT = "<8sIIQQQ"
_BAD_FILES = [
    ("v99", struct.pack(_HEADER_FMT, jio.MAGIC, 99, 1, 0, 0, 0).ljust(64, b"\0")),
    ("magic", struct.pack(_HEADER_FMT, b"NOTADWSE", 1, 1, 0, 0, 0).ljust(64, b"\0")),
    ("dtype", struct.pack(_HEADER_FMT, jio.MAGIC, 1, 7, 0, 0, 0).ljust(64, b"\0")),
    ("trunc", struct.pack(_HEADER_FMT, jio.MAGIC, 1, 1, 1000, 10, 0).ljust(64, b"\0") + b"\0" * 16),
    ("short", b"ADW"),
]


@pytest.mark.parametrize("name,blob", _BAD_FILES, ids=[b[0] for b in _BAD_FILES])
def test_header_rejections_equal_repro(tmp_path, name, blob):
    path = str(tmp_path / f"{name}.adw")
    with open(path, "wb") as f:
        f.write(blob)
    errs = []
    for mod in (pio, jio):
        with pytest.raises(ValueError) as e:
            mod.EdgeFileReader(path)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_writer_abort_on_exception(tmp_path):
    path = str(tmp_path / "partial.adw")
    with pytest.raises(RuntimeError):
        with pio.EdgeFileWriter(path) as w:
            w.append(np.array([[0, 1]], np.int32))
            raise RuntimeError("body failed")
    assert not os.path.exists(path)


def test_rmat_roundtrip_property(tmp_path):
    for seed in range(3):
        edges, n = rmat(8, 500, seed=seed)
        p = str(tmp_path / f"r{seed}.adw")
        pio.write_edge_file(p, edges, n)
        got, n2 = pio.read_edge_file(p)
        assert n2 == n and (got == edges).all()
        assert _bytes(p) == _bytes_of_jax(tmp_path, edges, n, seed)


def _bytes_of_jax(tmp_path, edges, n, tag):
    p = str(tmp_path / f"jax{tag}.adw")
    jio.write_edge_file(p, edges, n)
    return _bytes(p)


# ----------------------------------------------------------------------------
# Text ingest: three tiers, identical binaries, reports and errors
# ----------------------------------------------------------------------------

_REPORT_FIELDS = [f.name for f in dataclasses.fields(pio.IngestReport) if f.name != "wall_s"]


def _mixed_text():
    rng = np.random.default_rng(11)
    body = []
    for i, (u, v) in enumerate(random_edges(rng, 300, 900)):
        sep = ["\t", " ", "  ", " \t "][i % 4]
        trail = " 7 0" if i % 5 == 0 else ""
        body.append(f"{u}{sep}{v}{trail}")
        if i % 97 == 0:
            body.append("")
        if i % 131 == 0:
            body.append(["# note", "% note", "// note"][i % 3])
    return "# header\n% header2\n// header3\n" + "\n".join(body) + "\n"


_TEXTS = {
    "adversarial": ("# SNAP-style comment\n% matrix-market-style comment\n// c-style comment\n\n"
                    "5\t7\n  7   5\n3 3\n5 7 99 extra fields ignored\n\n\t\n9\t2\n", {}),
    "mixed": (_mixed_text(), {}),
    "clean": ("\n".join(f"{u} {v}" for u, v in _rng_edges(3, 99, 500)) + "\n", {}),
    "crlf": ("1 2\r\n3 4\r\n5 6", {}),
    "mac": ("1 2\r3 4\r# c\r5 6", {}),
    "plus": ("+1 2\n3 +4\n", {}),
    "neg-relabel": ("-3 -9\n-9 -3\n", dict(relabel=True)),
    "sparse-relabel": ("1000000 42\n42 -3\n1000000 7\n", dict(relabel=True)),
    "pinned": ("0 1\n1 2\n", dict(num_vertices=500)),
    "empty": ("", {}),
    "comments-only": ("# a\n\n% b\n", {}),
    "unicode": ("# café\n1 2\n3 4\n", {}),
    "few-fields": ("1 2\n3\n", {}),
    "non-integer": ("1 2\nx y\n", {}),
    "float-id": ("1 2\n3 4.5\n", {}),
    "negative": ("-1 5\n", {}),
    "overflow": ("99999999999999999999 1\n", {}),
    "lone-dash": ("1 2\n- 3\n", {}),
    "lone-cr-then-bad": ("1 2\r3 4\n5 6\nx y\n", {}),
    "pinned-violation": ("# head\n\n10 11\n999 1\n", dict(num_vertices=100)),
}
_TIERS = [("python", {}), ("python", dict(chunk_lines=3)),
          ("bytes", {}), ("bytes", dict(chunk_bytes=16))]


def _ingest(mod, src, dst, **kw):
    try:
        rep = mod.ingest_text(src, dst, **kw)
    except ValueError as e:
        return ("err", str(e), None)
    return ("ok", {f: getattr(rep, f) for f in _REPORT_FIELDS}, _bytes(dst))


@pytest.mark.parametrize("name", list(_TEXTS))
def test_ingest_tiers_equal_repro(tmp_path, name):
    content, kw = _TEXTS[name]
    src = str(tmp_path / f"{name}.txt")
    with open(src, "w", newline="") as f:
        f.write(content)
    binaries = set()
    for parser, extra in _TIERS:
        got = _ingest(pio, src, str(tmp_path / "p.adw"), parser=parser, **extra, **kw)
        want = _ingest(jio, src, str(tmp_path / "j.adw"), parser=parser, **extra, **kw)
        assert got == want, (name, parser, extra)
        binaries.add(got[0] + str(got[2] if got[0] == "ok" else got[1]))
    # Every tier gives the same binary (or the same error) as the others.
    assert len(binaries) == 1, name


def test_ingest_rejects_invalid_utf8_as_repro(tmp_path):
    src = str(tmp_path / "latin1.txt")
    with open(src, "wb") as f:
        f.write(b"# caf\xe9 header\n1 2\n3 4\n")
    for parser in ("python", "bytes"):
        for mod in (pio, jio):
            with pytest.raises(UnicodeDecodeError):
                mod.ingest_text(src, str(tmp_path / f"{parser}.adw"), parser=parser)


def test_ingest_failure_leaves_no_binary(tmp_path):
    src = str(tmp_path / "bad.txt")
    dst = str(tmp_path / "bad.adw")
    with open(src, "w") as f:
        f.write("1 2\n# ok\nonly_one_field\n")
    with pytest.raises(ValueError, match=r"bad\.txt:3"):
        pio.ingest_text(src, dst)
    assert not os.path.exists(dst)
    with pytest.raises(ValueError, match="parser must be"):
        pio.ingest_text(src, dst, parser="nope")


def test_ingest_of_written_stream_is_write_edge_file(tmp_path):
    """A text dump of a stream ingests to the very bytes write_edge_file
    writes for it (what the chip smoke checks at full size)."""
    edges, n = make_graph("tiny_social", seed=4)
    src = str(tmp_path / "g.txt")
    with open(src, "w") as f:
        f.write("# u v\n" + "\n".join(f"{u}\t{v}" for u, v in edges) + "\n")
    pio.ingest_text(src, str(tmp_path / "a.adw"), num_vertices=n)
    pio.write_edge_file(str(tmp_path / "b.adw"), edges, n)
    assert _bytes(str(tmp_path / "a.adw")) == _bytes(str(tmp_path / "b.adw"))


# ----------------------------------------------------------------------------
# External shuffle: same permutation and report as repro
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed,chunk,max_open", [(3, 300, None), (9, 150, 2), (4, 1 << 16, None)])
def test_shuffle_equal_repro(graph_file, tmp_path, seed, chunk, max_open):
    path, edges, _ = graph_file
    got = pio.shuffle_file(path, str(tmp_path / "p.adw"), seed=seed, chunk_edges=chunk,
                           max_open=max_open)
    want = jio.shuffle_file(path, str(tmp_path / "j.adw"), seed=seed, chunk_edges=chunk,
                            max_open=max_open)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.bound_rows == want.bound_rows
    assert _bytes(str(tmp_path / "p.adw")) == _bytes(str(tmp_path / "j.adw"))
    out, _ = pio.read_edge_file(str(tmp_path / "p.adw"))
    order = lambda e: e[np.lexsort((e[:, 1], e[:, 0]))]  # noqa: E731
    assert (order(out) == order(edges)).all() and not (out == edges).all()


def test_shuffle_recursive_buckets_equal_repro(graph_file, tmp_path, monkeypatch):
    monkeypatch.setattr(pshuffle, "_MAX_OPEN", 2)
    monkeypatch.setattr(jshuffle, "_MAX_OPEN", 2)
    path, _, _ = graph_file
    got = pio.shuffle_file(path, str(tmp_path / "p.adw"), seed=9, chunk_edges=150)
    want = jio.shuffle_file(path, str(tmp_path / "j.adw"), seed=9, chunk_edges=150)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.depth >= 1
    assert _bytes(str(tmp_path / "p.adw")) == _bytes(str(tmp_path / "j.adw"))


def test_shuffle_hard_bound_adversarial(tmp_path):
    m, chunk = 6000, 64
    skew = np.zeros((m // 2, 2), np.int32)
    tail = np.stack([np.arange(m - m // 2), np.arange(m - m // 2)], 1).astype(np.int32)
    edges = np.concatenate([skew, tail])
    src = str(tmp_path / "skew.adw")
    pio.write_edge_file(src, edges, int(edges.max()) + 1)
    rep = pio.shuffle_file(src, str(tmp_path / "p.adw"), seed=5, chunk_edges=chunk, max_open=2)
    ref = jio.shuffle_file(src, str(tmp_path / "j.adw"), seed=5, chunk_edges=chunk, max_open=2)
    assert dataclasses.asdict(rep) == dataclasses.asdict(ref)
    assert rep.depth >= 2 and rep.max_loaded_rows <= rep.bound_rows == 2 * chunk
    assert _bytes(str(tmp_path / "p.adw")) == _bytes(str(tmp_path / "j.adw"))
    with pytest.raises(ValueError, match="max_open"):
        pio.shuffle_file(src, str(tmp_path / "y.adw"), max_open=1)


# ----------------------------------------------------------------------------
# EdgeStream file methods
# ----------------------------------------------------------------------------


def test_edgestream_file_methods_equal_repro(tmp_path, tiny_social):
    edges, n = tiny_social
    EdgeStream(edges, n).to_file(str(tmp_path / "p.adw"))
    JaxStream(edges, n).to_file(str(tmp_path / "j.adw"))
    assert _bytes(str(tmp_path / "p.adw")) == _bytes(str(tmp_path / "j.adw"))
    back = EdgeStream.from_file(str(tmp_path / "j.adw"))
    assert back.num_vertices == n and (back.edges == edges).all()
    EdgeStream(edges, n).save(str(tmp_path / "s.npz"))
    loaded = JaxStream.load(str(tmp_path / "s.npz"))
    assert loaded.num_vertices == n and (loaded.edges == edges).all()
    again = EdgeStream.load(str(tmp_path / "s.npz"))
    again.edges[0, 0] = 123  # owned, mutable arrays
    assert (EdgeStream.load(str(tmp_path / "s.npz")).edges == edges).all()


# ----------------------------------------------------------------------------
# Chunked metrics
# ----------------------------------------------------------------------------


def _pairs(path, assign, chunk):
    r = pio.EdgeFileReader(path)
    return r, ((c, assign[s:s + len(c)]) for s, c in zip(range(0, r.num_edges, chunk),
                                                           r.chunks(chunk)))


@pytest.mark.parametrize("chunk", [200, 301, 1 << 20])
def test_chunked_metrics_equal_in_memory_and_repro(graph_file, chunk):
    path, edges, n = graph_file
    k = 8
    assign = np.random.default_rng(0).integers(0, k, len(edges)).astype(np.int32)
    ref_rep = replica_sets_from_assignment(edges, assign, n, k)
    r, pairs = _pairs(path, assign, chunk)
    with r:
        rep = replica_sets_from_chunks(pairs, n, k)
    assert (rep == ref_rep).all()
    r, pairs = _pairs(path, assign, chunk)
    with r:
        q = quality_from_chunks(pairs, n, k)
    want = jmetrics.quality_from_chunks(((edges, assign),), n, k)
    assert q["replication_degree"] == replication_degree(ref_rep) == want["replication_degree"]
    assert q["imbalance"] == partition_balance(assign, k) == want["imbalance"]
    assert q["sync_volume"] == want["sync_volume"] and q["unassigned"] == 0
    np.testing.assert_array_equal(q["sizes"], want["sizes"])
    np.testing.assert_array_equal(q["replicas"], want["replicas"])


def test_chunked_metrics_unassigned_policies(graph_file):
    path, edges, n = graph_file
    k = 4
    assign = np.zeros(len(edges), np.int32)
    assign[::5] = -1
    r, pairs = _pairs(path, assign, 200)
    with r, pytest.raises(ValueError, match="unassigned"):
        replica_sets_from_chunks(pairs, n, k)
    r, pairs = _pairs(path, assign, 200)
    with r:
        q = quality_from_chunks(pairs, n, k, unassigned="drop")
    want = jmetrics.quality_from_chunks(((edges, assign),), n, k, unassigned="drop")
    assert q["unassigned"] == int((assign < 0).sum()) == want["unassigned"]
    assert q["replication_degree"] == want["replication_degree"]
