"""Out-of-core partitioning in the port (``repro_torch.core.oocore`` and the
ring half of ``repro_torch.core.driver``) against the JAX package's
``repro.core.oocore``, on the CPU.

Mirrors ``tests/test_oocore.py`` and the ring half of
``tests/test_driver.py``: for every registry strategy at z = 1 and every
spotlight-compatible one at z = 4, the port's ``partition_file`` assigns
bit for bit as ``repro.core.oocore.partition_file`` and as the port's own
in-memory path, with ``repro``'s ring counters (``h2d_rows``,
``h2d_bytes``, ``scan_calls``, ``buffer_rows``, ``refill_spans``,
``stream_reads``); ``FileSource`` sizes its ring as ``repro``'s does; the
overrun guard, chunk-size and HDRF tie invariance, the bounded reader
memory, the read-ahead pipeline (prefetch 0 == 1 == 3 under jittered
reads, worker teardown on a reader error) and the cross-pass ring
adoption (``h2d_bytes == 8m + 4m·(passes-1)``). Property tests run with
``deadline=None``: a first example pays for JAX's compilation.
"""
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import AdwiseConfig as JaxConfig
from repro.core import partition_file as jax_partition_file
from repro.core.driver import FileSource as JaxFileSource
from repro.core.driver import ScanDriver as JaxDriver
from repro.graph.io import EdgeFileReader as JaxReader
from repro_torch.core import (
    AdwiseConfig,
    partition_file,
    partition_stream,
    run_partitioner,
    spotlight_partition,
)
from repro_torch.core.baselines import GreedyCore, HdrfCore
from repro_torch.core.driver import FileSource, ScanDriver, resolve_prefetch
from repro_torch.engine import partition_latency
from repro_torch.graph import rmat
from repro_torch.graph.io import EdgeFileReader, write_edge_file
from repro_torch.graph.io.format import EdgeFileSubReader

torch.set_num_threads(1)

K = 8
WMAX = 8
CPU = "cpu"
_RING_KEYS = ("h2d_rows", "h2d_bytes", "scan_calls", "buffer_rows", "refill_spans",
              "stream_reads", "stream_reads_measured", "rows_read", "peak_resident_edges",
              "prefetch_depth", "score_rows", "passes_run", "pass_rd", "best_pass", "n_clusters")


def _write(tmp_path, edges, n, name="g.adw"):
    p = str(tmp_path / name)
    write_edge_file(p, edges, n)
    return p


@pytest.fixture(scope="module")
def rmat_file(tmp_path_factory):
    """The registry-parity graph of tests/test_oocore.py."""
    edges, n = rmat(9, 2500, seed=13)
    path = str(tmp_path_factory.mktemp("toocore") / "rmat.adw")
    write_edge_file(path, edges, n)
    return path, edges, n


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    """The ring-driver graph of tests/test_driver.py."""
    edges, n = rmat(8, 1100, seed=21)
    path = str(tmp_path_factory.mktemp("tring") / "rmat.adw")
    write_edge_file(path, edges, n)
    return path, edges, n


def _both(path, tmp_path, strategy, **kw):
    """(port, repro) partition_file results on the same file and knobs."""
    with EdgeFileReader(path) as r:
        got = partition_file(r, strategy, K, spill_dir=str(tmp_path / "port"), device=CPU, **kw)
    with JaxReader(path) as r:
        want = jax_partition_file(r, strategy, K, spill_dir=str(tmp_path / "jax"), **kw)
    return got, want


def _same_counters(got, want):
    for key in _RING_KEYS:
        if key in want.stats:
            assert got.stats[key] == want.stats[key], key


# ----------------------------------------------------------------------------
# Registry-wide parity: port file == repro file == port in-memory
# ----------------------------------------------------------------------------

_Z1_CASES = [
    ("hash", {}),
    ("grid", {}),
    ("dbh", {}),
    ("hdrf", {}),
    ("hdrf", dict(lam=1.5)),
    ("greedy", {}),
    ("adwise", dict(window_max=WMAX)),
    ("2ps", dict(window_max=WMAX)),
    ("2ps-l", {}),
    ("2ps-l", dict(lam=1.5, cap_slack=1.3)),
    ("adwise-restream", dict(window_max=WMAX, passes=2)),
]


@pytest.mark.parametrize("strategy,cfg", _Z1_CASES,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(_Z1_CASES)])
def test_partition_file_parity_z1(rmat_file, tmp_path, strategy, cfg):
    path, edges, n = rmat_file
    got, want = _both(path, tmp_path, strategy, seed=0, chunk_edges=400, **cfg)
    mem = run_partitioner(strategy, edges, n, K, seed=0, device=CPU, **cfg)
    np.testing.assert_array_equal(np.asarray(got.assign), np.asarray(want.assign))
    np.testing.assert_array_equal(np.asarray(got.assign), mem.assign)
    _same_counters(got, want)
    assert got.stats["unassigned"] == 0 and got.stats["rows_read"] >= len(edges)
    assert got.stats["name"] == want.stats["name"]


_SPOT_CASES = [
    ("hash", {}, None),
    ("dbh", {}, None),
    ("hdrf", {}, None),
    ("greedy", {}, None),
    ("2ps", dict(window_max=WMAX), dict(window_max=WMAX)),
    ("2ps-l", {}, None),
    ("adwise", dict(window_max=WMAX), None),
    ("adwise-restream", dict(window_max=WMAX, passes=2), dict(window_max=WMAX, passes=2)),
]


@pytest.mark.parametrize("strategy,cfg,scfg", _SPOT_CASES, ids=[s for s, _, _ in _SPOT_CASES])
def test_partition_file_parity_spotlight(rmat_file, tmp_path, strategy, cfg, scfg):
    """z = 4, spread 2: port file == repro file == port in-memory spotlight."""
    path, edges, n = rmat_file
    z, spread = 4, 2
    got, want = _both(path, tmp_path, strategy, z=z, spread=spread, seed=0, chunk_edges=400,
                      **cfg)
    acfg = AdwiseConfig(k=K, window_max=WMAX) if strategy == "adwise" else None
    mem = spotlight_partition(edges, n, K, z=z, spread=spread, strategy=strategy, cfg=acfg,
                              seed=0, strategy_cfg=scfg, device=CPU)
    np.testing.assert_array_equal(np.asarray(got.assign), np.asarray(want.assign))
    np.testing.assert_array_equal(np.asarray(got.assign), mem.assign)
    _same_counters(got, want)
    assert got.stats["z"] == z and got.stats["name"] == want.stats["name"]


def test_partition_file_on_sub_reader(rmat_file, tmp_path):
    path, edges, n = rmat_file
    half = len(edges) // 2
    ref = spotlight_partition(edges[:half], n, K, z=2, spread=4, strategy="hdrf", seed=0,
                              device=CPU)
    with EdgeFileReader(path) as r:
        res = partition_file(r.sub(0, half), "hdrf", K, z=2, spread=4, seed=0,
                             chunk_edges=300, spill_dir=str(tmp_path), device=CPU)
        assert (np.asarray(res.assign) == ref.assign).all()
        assert res.stats["rows_read"] == half  # accounting flows to the root


def test_partition_file_rejects_grid_under_spotlight(rmat_file, tmp_path):
    path, _, _ = rmat_file
    with EdgeFileReader(path) as r, pytest.raises(ValueError, match="spotlight"):
        partition_file(r, "grid", K, z=4, spread=2, spill_dir=str(tmp_path), device=CPU)


# ----------------------------------------------------------------------------
# FileSource sizing and refill invariants
# ----------------------------------------------------------------------------

_GEOMETRIES = [(64, 8, 1), (400, 8, 2), (100, 16, 4), (7, 4, 1), (1 << 16, 256, 1),
               (8192, 256, 1), (32768, 256, 1), (48, 4, 2), (500, 32, 1)]


@pytest.mark.parametrize("chunk,wmax,b", _GEOMETRIES)
def test_file_source_sizing_equals_repro(small_file, chunk, wmax, b):
    path, _, n = small_file
    geom = ("scan_steps", "Rq", "B", "max_span")
    with EdgeFileReader(path) as r, JaxReader(path) as j:
        got = FileSource([r], chunk_edges=chunk,
                         cfg=AdwiseConfig(k=K, window_max=wmax, assign_batch=b))
        want = JaxFileSource([j], chunk_edges=chunk,
                             cfg=JaxConfig(k=K, window_max=wmax, assign_batch=b))
        assert [getattr(got, a) for a in geom] == [getattr(want, a) for a in geom]
        f = wmax + got.scan_steps * b
        assert got.B % got.Rq == 0 and got.B >= f + got.Rq - 1
        assert got.Rq & (got.Rq - 1) == 0
        assert got.max_span <= max(chunk, wmax + b)
        for core in (HdrfCore(num_vertices=n, k=K), GreedyCore(num_vertices=n, k=K)):
            one = FileSource([r], chunk_edges=chunk, core=core)
            assert (one.scan_steps, one.B) == (chunk, (-(-chunk // one.Rq) + 2) * one.Rq)


def test_file_source_refill_overrun_guard(small_file):
    path, _, _ = small_file
    cfg = AdwiseConfig(k=K, window_max=8)
    with EdgeFileReader(path) as r, FileSource([r], chunk_edges=100, cfg=cfg) as src:
        buf = src.alloc(torch.device(CPU))
        buf = src.refill(buf, np.zeros(1, np.int64))
        with pytest.raises(RuntimeError, match="overran"):
            src.refill(buf, np.array([int(src.hi[0]) + 1], np.int64))


def test_driver_direct_ring_run_equals_repro(small_file):
    """ScanDriver over a FileSource by hand: the resident path's assignment,
    cursors exactly at the uploaded high-water mark, each row shipped once,
    and repro's counters."""
    path, edges, n = small_file
    m = len(edges)
    cfg = AdwiseConfig(k=K, window_max=8)
    ref = partition_stream(edges, n, cfg, device=CPU)
    got = np.full((m,), -1, np.int32)
    want = np.full((m,), -1, np.int32)

    with EdgeFileReader(path) as r, JaxReader(path) as j:
        src = FileSource([r], chunk_edges=150, cfg=cfg)
        drv = ScanDriver(src, cfg, n, device=CPU)
        res = drv.run(on_assign=lambda i, idx, p: got.__setitem__(idx, p))
        assert (src.hi == m).all()
        st = drv.stats_base(res, 0)
        assert st["ring_handle"] is drv.ring_handle and (st["ring_handle"].hi == m).all()
        assert st["ring_handle"].B == st["buffer_rows"] == src.B
        jcfg = JaxConfig(k=K, window_max=8)
        jsrc = JaxFileSource([j], chunk_edges=150, cfg=jcfg)
        jres = JaxDriver(jsrc, jcfg, n).run(on_assign=lambda i, idx, p: want.__setitem__(idx, p))
    np.testing.assert_array_equal(got, ref.assign)
    np.testing.assert_array_equal(got, want)
    assert int(res.assigned[0]) == m and res.h2d_rows == m and res.h2d_bytes == 8 * m
    for key in ("scan_calls", "h2d_rows", "h2d_bytes", "buffer_rows", "scan_steps_per_call",
                "refill_spans"):
        assert getattr(res, key) == getattr(jres, key), key
    assert res.ring_addrs == 1 and res.steps_run == res.scan_calls * res.scan_steps_per_call


def test_driver_rejects_file_mode_without_sink(small_file):
    path, _, n = small_file
    cfg = AdwiseConfig(k=K, window_max=8)
    with EdgeFileReader(path) as r:
        drv = ScanDriver(FileSource([r], chunk_edges=100, cfg=cfg), cfg, n, device=CPU)
        with pytest.raises(ValueError, match="on_assign"):
            drv.run()


# ----------------------------------------------------------------------------
# Geometry never changes results
# ----------------------------------------------------------------------------


def test_partition_file_chunk_size_invariance(rmat_file, tmp_path):
    path, edges, n = rmat_file
    outs = []
    for chunk in (400, 997):
        with EdgeFileReader(path) as r:
            res = partition_file(r, "adwise", K, seed=0, chunk_edges=chunk, window_max=WMAX,
                                 spill_dir=str(tmp_path / f"c{chunk}"), device=CPU)
        outs.append(np.asarray(res.assign).copy())
    assert (outs[0] == outs[1]).all()


def test_hdrf_tie_noise_invariant_under_chunk_geometry(rmat_file, tmp_path):
    path, edges, n = rmat_file
    ref = run_partitioner("hdrf", edges, n, K, seed=3, device=CPU)
    for chunk in (64, 211, 400, 997, len(edges) + 7):
        with EdgeFileReader(path) as r:
            res = partition_file(r, "hdrf", K, seed=3, chunk_edges=chunk,
                                 spill_dir=str(tmp_path / f"h{chunk}"), device=CPU)
        assert (np.asarray(res.assign) == ref.assign).all(), chunk


def test_partition_file_random_rmat_property(tmp_path):
    """Random R-MAT streams and chunks: the single-edge strategies stay
    bit-identical to the in-memory path and to repro through the file."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        edges, n = rmat(8, int(rng.integers(200, 700)), a=float(rng.uniform(0.3, 0.6)), seed=seed)
        path = _write(tmp_path, edges, n, f"p{seed}.adw")
        chunk = int(rng.integers(37, 300))
        for strategy in ("hash", "grid", "dbh", "hdrf", "greedy"):
            got, want = _both(path, tmp_path / f"s{seed}{strategy}", strategy, seed=seed,
                              chunk_edges=chunk)
            ref = run_partitioner(strategy, edges, n, K, seed=seed, device=CPU)
            assert (np.asarray(got.assign) == ref.assign).all(), (strategy, seed, chunk)
            assert (np.asarray(got.assign) == np.asarray(want.assign)).all()


# ----------------------------------------------------------------------------
# Bounded resident edge memory (counting reader)
# ----------------------------------------------------------------------------


class CountingReader:
    """Reader proxy counting the edge rows of every array it handed out that
    is still alive (weakref finalizers); ``peak`` is the high-water mark."""

    def __init__(self, inner, counter=None):
        self._inner = inner
        self._c = counter if counter is not None else {"live": 0, "peak": 0, "max_req": 0}
        self.num_edges = inner.num_edges
        self.num_vertices = inner.num_vertices
        self.path = getattr(inner, "path", None)

    @property
    def peak(self):
        return self._c["peak"]

    @property
    def max_request(self):
        return self._c["max_req"]

    def _root(self):
        root = self._inner
        while hasattr(root, "_parent"):
            root = root._parent
        return root

    @property
    def rows_read(self):
        return getattr(self._root(), "rows_read", 0)

    @property
    def read_seconds(self):
        return getattr(self._root(), "read_seconds", 0.0)

    def read(self, start, count):
        arr = self._inner.read(start, count)
        c = self._c
        c["live"] += len(arr)
        c["peak"] = max(c["peak"], c["live"])
        c["max_req"] = max(c["max_req"], len(arr))
        weakref.finalize(arr, CountingReader._dec, c, len(arr))
        return arr

    @staticmethod
    def _dec(c, rows):
        c["live"] -= rows

    def chunks(self, chunk_edges):
        for start in range(0, self.num_edges, chunk_edges):
            yield self.read(start, chunk_edges)

    def read_all(self):
        return self.read(0, self.num_edges)

    def sub(self, start, stop):
        return CountingReader(self._inner.sub(start, stop), self._c)

    def split(self, z):
        return [CountingReader(s, self._c) for s in self._inner.split(z)]


@pytest.mark.parametrize("strategy,cfg,z", [
    ("adwise", dict(window_max=WMAX), 1),
    ("adwise-restream", dict(window_max=WMAX, passes=2), 1),
    ("hdrf", {}, 1),
    ("2ps", dict(window_max=WMAX), 1),
    ("adwise", dict(window_max=WMAX), 4),
])
def test_partition_file_memory_bounded(tmp_path, strategy, cfg, z):
    """Peak live edge rows handed out by the reader stay O(chunk), far below
    m, while the output still equals the in-memory path. The chunk keeps
    the staging bound itself under m / 2 at the default read-ahead depth,
    so the bound decides both checks whatever the worker's timing."""
    edges, n = rmat(9 if z == 1 else 11, 2500 * z, seed=13)
    m = len(edges)
    path = _write(tmp_path, edges, n)
    chunk = 200
    with EdgeFileReader(path) as inner:
        r = CountingReader(inner)
        res = partition_file(r, strategy, K, z=z, spread=2 if z > 1 else None, seed=0,
                             chunk_edges=chunk, spill_dir=str(tmp_path / "sp"), device=CPU,
                             **cfg)
    bound = (3 + resolve_prefetch(None)) * max(chunk, WMAX + 1) * z
    assert bound < m / 2
    assert r.max_request <= max(chunk, WMAX + 1)
    assert r.peak <= bound, f"peak live rows {r.peak} > bound {bound}"
    assert r.peak < m / 2
    assert res.stats["peak_resident_edges"] < 4 * chunk * z + 1
    if z == 1:
        ref = run_partitioner(strategy, edges, n, K, seed=0, device=CPU, **cfg)
    else:
        ref = spotlight_partition(edges, n, K, z=z, spread=2, strategy=strategy,
                                  cfg=AdwiseConfig(k=K, **cfg), seed=0, device=CPU)
    assert (np.asarray(res.assign) == ref.assign).all()


# ----------------------------------------------------------------------------
# The read-ahead pipeline
# ----------------------------------------------------------------------------


@settings(max_examples=3, deadline=None)
@given(
    chunk=st.integers(min_value=48, max_value=500),
    b=st.sampled_from([1, 2]),
    z=st.sampled_from([1, 2]),
)
def test_prefetch_0_1_3_equal_under_jittered_reads(small_file, tmp_path_factory, chunk, b, z):
    """The pipeline only moves when spans are staged: prefetch 0, 1 and 3,
    with jittered reads inside the worker, assign bit for bit as the
    in-memory path, and every span is prestaged XOR missed."""
    path, edges, n = small_file
    cfg = dict(window_max=4, assign_batch=b)
    if z == 1:
        ref = run_partitioner("adwise", edges, n, K, seed=0, device=CPU, **cfg)
    else:
        ref = spotlight_partition(edges, n, K, z=z, spread=K // z, strategy="adwise",
                                  cfg=AdwiseConfig(k=K, seed=0, **cfg), device=CPU)
    td = tmp_path_factory.mktemp("pf")
    for pf in (0, 1, 3):
        saved = {}
        if pf:
            for klass in (EdgeFileReader, EdgeFileSubReader):
                saved[klass] = klass.read

                def slow(self, start, count, _orig=klass.read):
                    time.sleep(((start // 64) % 3) * 5e-4)
                    return _orig(self, start, count)
                klass.read = slow
        try:
            with EdgeFileReader(path) as r:
                res = partition_file(r, "adwise", K, z=z, spread=K // z if z > 1 else None,
                                     seed=0, chunk_edges=chunk, spill_dir=str(td / f"p{pf}"),
                                     prefetch=pf, device=CPU, **cfg)
        finally:
            for klass, orig in saved.items():
                klass.read = orig
        s = res.stats
        assert s["prefetch_depth"] == pf
        assert s["spans_prestaged"] + s["spans_missed"] == s["refill_spans"]
        if pf == 0:
            assert s["spans_prestaged"] == 0
        assert s["h2d_rows"] == len(edges)
        assert (np.asarray(res.assign) == ref.assign).all(), (pf, chunk, b, z)


def test_prefetch_worker_prestages(small_file):
    path, _, _ = small_file
    cfg = AdwiseConfig(k=K, window_max=8)
    with EdgeFileReader(path) as r, FileSource([r], chunk_edges=150, cfg=cfg, prefetch=2) as src:
        buf = src.refill(src.alloc(torch.device(CPU)), np.zeros(1, np.int64))
        hi0 = int(src.hi[0])
        assert src._worker is not None
        # The next refill's first span ends at most max_span rows on.
        target = min(hi0 + src.max_span, int(src.m_per[0]))
        deadline = time.monotonic() + 10.0
        while int(src._worker._next[0]) < target:
            assert time.monotonic() < deadline, "worker never got ahead"
            time.sleep(0.005)
        src.refill(buf, np.array([hi0], np.int64))
        assert int(src.hi[0]) > hi0 and src.spans_prestaged >= 1
        assert src.spans_prestaged + src.spans_missed == src.refill_spans


def test_prefetch_worker_teardown_on_error(small_file):
    path, _, _ = small_file

    class _BoomReader:
        def __init__(self, inner):
            self.num_edges = inner.num_edges

        def read(self, start, count):
            raise OSError("disk pulled")

    cfg = AdwiseConfig(k=K, window_max=8)
    before = {t for t in threading.enumerate() if t.name == "adwise-readahead"}
    with EdgeFileReader(path) as r:
        with pytest.raises(RuntimeError, match="read-ahead worker failed"):
            with FileSource([_BoomReader(r)], chunk_edges=100, cfg=cfg, prefetch=2) as src:
                src.refill(src.alloc(torch.device(CPU)), np.zeros(1, np.int64))
    leaked = {t for t in threading.enumerate() if t.name == "adwise-readahead"} - before
    assert not leaked, f"read-ahead thread leaked: {leaked}"


def test_short_read_raises(small_file):
    path, _, _ = small_file

    class _ShortReader:
        def __init__(self, inner):
            self.num_edges = inner.num_edges
            self._inner = inner

        def read(self, start, count):
            return self._inner.read(start, max(count - 1, 0))

    cfg = AdwiseConfig(k=K, window_max=8)
    with EdgeFileReader(path) as r, FileSource([_ShortReader(r)], chunk_edges=100, cfg=cfg,
                                               prefetch=0) as src:
        with pytest.raises(RuntimeError, match="reader returned"):
            src.refill(src.alloc(torch.device(CPU)), np.zeros(1, np.int64))


def test_resolve_prefetch_env(monkeypatch):
    monkeypatch.delenv("ADWISE_PREFETCH", raising=False)
    assert resolve_prefetch(None) == 2
    assert resolve_prefetch(0) == 0 and resolve_prefetch(5) == 5
    monkeypatch.setenv("ADWISE_PREFETCH", "0")
    assert resolve_prefetch(None) == 0
    monkeypatch.setenv("ADWISE_PREFETCH", "3")
    assert resolve_prefetch(None) == 3 and resolve_prefetch(1) == 1


# ----------------------------------------------------------------------------
# Re-streaming from the file: ring adoption and h2d accounting
# ----------------------------------------------------------------------------


def test_restream_ring_h2d_accounting_wrapping(small_file, tmp_path):
    """chunk_edges < m: the ring wraps, so pass 2 ships uv again plus the
    prev table (12 B/row) — repro's counters, the in-memory assignment."""
    path, edges, n = small_file
    m = len(edges)
    cfg = dict(window_max=8, passes=2)
    got, want = _both(path, tmp_path, "adwise-restream", seed=0, chunk_edges=200, **cfg)
    ref = run_partitioner("adwise-restream", edges, n, K, seed=0, device=CPU, **cfg)
    assert (np.asarray(got.assign) == ref.assign).all()
    assert got.stats["h2d_rows"] == 2 * m and got.stats["h2d_bytes"] == m * 8 + m * 12
    _same_counters(got, want)


@pytest.mark.parametrize("passes", [2, 3])
def test_restream_ring_cross_pass_adoption(small_file, tmp_path, passes):
    """chunk_edges >= m keeps the whole stream in the ring: every later pass
    adopts the ring and ships only the 4 B/row prev table, so
    h2d_bytes == 8m + 4m·(passes-1), bit-identically."""
    path, edges, n = small_file
    m = len(edges)
    cfg = dict(window_max=8, passes=passes)
    got, want = _both(path, tmp_path, "adwise-restream", seed=0, chunk_edges=1200, **cfg)
    ref = run_partitioner("adwise-restream", edges, n, K, seed=0, device=CPU, **cfg)
    assert (np.asarray(got.assign) == ref.assign).all()
    assert got.stats["h2d_rows"] == m
    assert got.stats["h2d_bytes"] == 8 * m + 4 * m * (passes - 1)
    assert got.stats["spans_prestaged"] + got.stats["spans_missed"] == got.stats["refill_spans"]
    _same_counters(got, want)


def test_restream_file_stats(small_file, tmp_path):
    path, edges, n = small_file
    with EdgeFileReader(path) as r:
        res = partition_file(r, "adwise-restream", K, seed=0, chunk_edges=500,
                             spill_dir=str(tmp_path), window_max=WMAX, passes=3,
                             keep_best=True, device=CPU)
    s = res.stats
    assert s["passes_run"] == 3 and s["stream_reads"] == 3 and len(s["pass_rd"]) == 3
    spill_files = sorted(p.name for p in tmp_path.iterdir() if p.name.endswith(".i32"))
    assert spill_files == ["assign.i32"]
    ref = run_partitioner("adwise-restream", edges, n, K, seed=0, window_max=WMAX, passes=3,
                          keep_best=True, device=CPU)
    assert (np.asarray(res.assign) == ref.assign).all()
    assert s["pass_rd"] == ref.stats["pass_rd"] and s["best_pass"] == ref.stats["best_pass"]


# ----------------------------------------------------------------------------
# IO accounting, empty streams, errors
# ----------------------------------------------------------------------------


def test_stream_reads_billed_per_strategy(rmat_file, tmp_path):
    path, edges, n = rmat_file
    m = len(edges)
    for strategy, reads in {"hash": 1, "dbh": 2, "2ps": 3}.items():
        cfg = dict(window_max=WMAX) if strategy == "2ps" else {}
        with EdgeFileReader(path) as r:
            res = partition_file(r, strategy, K, seed=0, chunk_edges=500,
                                 spill_dir=str(tmp_path / strategy), device=CPU, **cfg)
        assert res.stats["stream_reads"] == res.stats["stream_reads_measured"] == reads
        assert res.stats["rows_read"] == reads * m
        lat = partition_latency(res.stats, m, K)
        assert lat >= partition_latency(dict(res.stats, stream_reads=1), m, K)


def test_partition_file_empty_and_errors(tmp_path):
    p = _write(tmp_path, np.zeros((0, 2), np.int32), 5, "empty.adw")
    with EdgeFileReader(p) as r:
        res = partition_file(r, "adwise", K, spill_dir=str(tmp_path), device=CPU)
    with JaxReader(p) as r:
        want = jax_partition_file(r, "adwise", K, spill_dir=str(tmp_path))
    assert res.assign.shape == (0,) and res.stats == want.stats

    edges, n = rmat(8, 200, seed=0)
    p = _write(tmp_path, edges, n, "e.adw")
    with EdgeFileReader(p) as r:
        with pytest.raises(KeyError, match="out-of-core"):
            partition_file(r, "nope", K, spill_dir=str(tmp_path), device=CPU)
        with pytest.raises(TypeError, match="unknown config"):
            partition_file(r, "adwise", K, bogus=1, spill_dir=str(tmp_path), device=CPU)
        with pytest.raises(TypeError, match="unknown config"):
            partition_file(r, "hdrf", K, bogus=1, spill_dir=str(tmp_path), device=CPU)
        with pytest.raises(ValueError, match="z must be"):
            partition_file(r, "hash", K, z=0, spill_dir=str(tmp_path), device=CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA device"):
                partition_file(r, "hash", K, spill_dir=str(tmp_path))  # default: cuda
