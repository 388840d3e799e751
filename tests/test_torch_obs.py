"""The port's tracer (``repro_torch.obs``) on its in-memory and file paths
(mirrors ``tests/test_obs.py``): the null tracer costs nothing, tracing on
is bit-identical to tracing off for every strategy, the span tree is well
formed and reconciles with the driver's counters (on a file run: the
``refill`` total is ``h2d_wait_s``, the ``stage`` total is
``prestage_wall_s``, one scan span per scan call), restream passes get
their own lanes, the engine records superstep spans, the Chrome export
validates, and SC003 flags a tracer inside a port step closure. The port's
copy of the tracer is also held to ``repro.obs``."""
import json
import sys
import textwrap
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import Tracer as JaxTracer
from repro.obs import chrome_trace as jax_chrome_trace
from repro_torch.core import (
    AdwiseConfig,
    available_strategies,
    partition_stream,
    restream_partition,
    spotlight_partition,
    two_phase_linear_partition,
    two_phase_partition,
)
from repro_torch.core.adwise import partition_stream_batched
from repro_torch.core import partition_file
from repro_torch.graph import EdgeStream, make_graph, rmat
from repro_torch.graph.io import EdgeFileReader, write_edge_file
from repro_torch.obs import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    chrome_trace,
    resolve_tracer,
    validate_chrome_trace,
)

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:  # for tools.* imports under `python -m pytest`
    sys.path.insert(0, str(REPO_ROOT))

K = 8
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def graph():
    return rmat(8, 1200, seed=5)


# ----------------------------------------------------------------------------
# null tracer: the disabled path is free
# ----------------------------------------------------------------------------


def test_null_tracer_singleton_and_noop():
    assert resolve_tracer(None) is NULL_TRACER
    tr = Tracer()
    assert resolve_tracer(tr) is tr
    assert NULL_TRACER.enabled is False and tr.enabled is True
    s1 = NULL_TRACER.span("a", cat="scan", x=1)
    assert s1 is NULL_TRACER.span("b")
    with s1 as s:
        s.set(rows=3)
    NULL_TRACER.add_span("x", "scan", 0.0, 1.0)
    NULL_TRACER.instant("i")
    NULL_TRACER.gauge("g", 2.0)
    summ = NULL_TRACER.summary()
    assert summ.events == 0 and summ.categories == {}
    with pytest.raises(RuntimeError):
        NULL_TRACER.export("never.json")
    assert NullTracer.__slots__ == ()


def test_null_tracer_hot_path_allocates_nothing():
    tr = resolve_tracer(None)
    for _ in range(100):
        tr.add_span("s", "scan", 0.0, 1.0)
        with tr.span("s"):
            pass
    tracemalloc.start()
    before, _ = tracemalloc.get_traced_memory()
    for _ in range(5000):
        tr.add_span("s", "scan", 0.0, 1.0)
        with tr.span("s"):
            pass
    after, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert after - before < 16_384, (before, after)
    assert peak - before < 65_536, (before, peak)


# ----------------------------------------------------------------------------
# registry-wide parity: tracing off AND on is bit-identical
# ----------------------------------------------------------------------------


def _traced_pair(run):
    off = run(None)
    tr = Tracer()
    on = run(tr)
    return off, on, tr


@pytest.mark.parametrize("strategy", [s for s in available_strategies() if s != "grid"])
def test_registry_parity_traced_vs_untraced(graph, strategy):
    """Every strategy that spotlight batches, traced and untraced, at z = 2:
    the same assignment, and the scan strategies record their scan calls."""
    edges, n = graph
    cfg = dict(window_max=8, window_init=2)
    kw = dict(strategy=strategy, seed=0, **CPU)
    if strategy == "adwise":
        kw["cfg"] = AdwiseConfig(k=K, **cfg)
    elif strategy in ("adwise-restream", "2ps"):
        kw["strategy_cfg"] = dict(cfg, passes=2) if strategy == "adwise-restream" else cfg

    off, on, tr = _traced_pair(lambda t: spotlight_partition(edges, n, K, 2, 4, trace=t, **kw))
    np.testing.assert_array_equal(off.assign, on.assign)
    if strategy in ("hash", "dbh"):
        return  # stateless: no scan to trace
    assert on.stats["trace_summary"]["categories"]["scan"]["count"] > 0
    assert "trace_summary" not in off.stats


def test_z1_entry_points_traced_equal_untraced(graph):
    edges, n = graph
    runs = {
        "partition_stream": lambda t: partition_stream(
            edges, n, AdwiseConfig(k=K, window_max=8), n_chunks=4, trace=t, **CPU),
        "restream": lambda t: restream_partition(
            edges, n, K, passes=2, window_max=8, trace=t, **CPU),
        "2ps": lambda t: two_phase_partition(edges, n, K, window_max=8, trace=t, **CPU),
        "2ps-l": lambda t: two_phase_linear_partition(edges, n, K, trace=t, **CPU),
    }
    for name, run in runs.items():
        off, on, tr = _traced_pair(run)
        np.testing.assert_array_equal(off.assign, on.assign, err_msg=name)
        assert on.stats["trace_summary"]["events"] == tr.summary().events, name


# ----------------------------------------------------------------------------
# span-tree well-formedness + counter reconciliation
# ----------------------------------------------------------------------------


def _check_well_formed(tr, scan_calls):
    spans = list(tr.spans)
    assert spans, "traced run recorded no spans"
    eps = 1e-9
    by_track = {}
    for s in spans:
        assert s.t1 >= s.t0 - eps, (s.name, s.t0, s.t1)
        by_track.setdefault(s.track, []).append(s)
    # Overlapping spans on one track must nest (Perfetto's layout).
    for track, ss in by_track.items():
        ss = sorted(ss, key=lambda s: (s.t0, -s.t1))
        for i, a in enumerate(ss):
            for b in ss[i + 1:]:
                if b.t0 >= a.t1 - eps:
                    break
                assert b.t1 <= a.t1 + eps, (track, a.name, b.name)
    cats = tr.summary().categories
    assert cats["scan"]["count"] == scan_calls
    assert cats["host"]["count"] >= 1  # the materialize span of each run
    # Each driver run numbers its scan calls 1, 2, ...: provisioned calls
    # ("dispatch") first, then drain calls; nothing is captured on the CPU.
    scans = sorted((s for s in spans if s.name == "scan-call"), key=lambda s: s.t0)
    runs = []
    for s in scans:
        if s.attrs["call"] == 1:
            runs.append([])
        runs[-1].append(s)
    for run in runs:
        assert [s.attrs["call"] for s in run] == list(range(1, len(run) + 1))
        modes = [s.attrs["mode"] for s in run]
        assert modes == sorted(modes, key=["dispatch", "drain"].index)
        assert not any(s.attrs.get("compiled") for s in run)


@pytest.mark.parametrize("n_chunks,wmax,z", [(1, 4, 1), (4, 8, 1), (3, 16, 3), (8, 8, 4)])
def test_span_tree_well_formed(graph, n_chunks, wmax, z):
    edges, n = graph
    streams, valid = EdgeStream(edges, n).split_padded(z)
    tr = Tracer()
    got = partition_stream_batched(streams, valid, n, AdwiseConfig(k=K, window_max=wmax),
                                   n_chunks=n_chunks, trace=tr, **CPU)
    # One driver per length bucket; every bucket's scan calls are recorded.
    buckets = {r.stats["bucket_rows"]: r.stats["scan_calls"] for r in got}
    _check_well_formed(tr, sum(buckets.values()))
    assert got[0].stats["trace_summary"]["categories"]["scan"]["count"] == sum(buckets.values())
    want = partition_stream_batched(streams, valid, n, AdwiseConfig(k=K, window_max=wmax),
                                    n_chunks=n_chunks, **CPU)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.assign, b.assign)


@pytest.fixture(scope="module")
def graph_file(graph, tmp_path_factory):
    edges, n = graph
    path = str(tmp_path_factory.mktemp("tobs") / "g.adw")
    write_edge_file(path, edges, n)
    return path


def _file_run(path, strategy, trace, tmp_path, **kw):
    with EdgeFileReader(path) as r:
        return partition_file(r, strategy, K, seed=0, spill_dir=str(tmp_path), trace=trace,
                              **CPU, **kw)


@pytest.mark.parametrize("strategy,kw", [
    ("adwise", dict(window_max=8, chunk_edges=200)),
    ("hdrf", dict(chunk_edges=256, prefetch=0)),
    ("adwise-restream", dict(window_max=8, chunk_edges=2048, passes=2)),
    ("2ps-l", dict(chunk_edges=300, z=2, spread=4)),
])
def test_file_run_traced_equals_untraced_and_reconciles(graph_file, tmp_path, strategy, kw):
    """A traced file run assigns as the untraced one; its category totals
    are the stats counters: refill == h2d_wait_s, stage == prestage_wall_s,
    one scan span per scan call; stage spans come from the read-ahead
    thread, scan and refill spans never do."""
    off = _file_run(graph_file, strategy, None, tmp_path / "off", **kw)
    tr = Tracer()
    on = _file_run(graph_file, strategy, tr, tmp_path / "on", **kw)
    np.testing.assert_array_equal(np.asarray(off.assign), np.asarray(on.assign))
    st = on.stats
    cats = tr.summary().categories
    assert st["trace_summary"]["events"] == tr.summary().events
    assert cats["scan"]["count"] == st["scan_calls"]
    assert abs(cats.get("refill", {}).get("wall_s", 0.0) - st["h2d_wait_s"]) < 1e-6
    assert abs(cats.get("stage", {}).get("wall_s", 0.0) - st["prestage_wall_s"]) < 1e-6
    for s in tr.spans:
        if s.cat == "stage":
            assert s.thread.startswith("adwise-readahead"), s
        if s.cat in ("scan", "refill"):
            assert not s.thread.startswith("adwise-readahead"), s
    if kw.get("prefetch") == 0:
        assert "stage" not in cats and st["spans_missed"] == st["refill_spans"]
    if strategy == "adwise-restream":
        # Pass 2 adopts pass 1's ring: one ring-adopt instant, two lanes.
        assert sum(1 for e in tr.instants if e.name == "ring-adopt") == 1
        assert {t for t in tr.summary().tracks if t.startswith("restream-pass-")} == {
            "restream-pass-1", "restream-pass-2"}
    phases = {s.name for s in tr.spans if s.cat == "phase"}
    assert {"partition_file", "spill-verify"} <= phases
    assert validate_chrome_trace(chrome_trace(tr)) == []


# ----------------------------------------------------------------------------
# restream lanes + entry-point summaries
# ----------------------------------------------------------------------------


def test_restream_pass_lanes(graph):
    edges, n = graph
    tr = Tracer()
    res = restream_partition(edges, n, K, passes=3, window_max=8, trace=tr, **CPU)
    passes_run = int(res.stats["passes_run"])
    summ = tr.summary()
    assert summ.categories["pass"]["count"] == passes_run
    lanes = {t for t in summ.tracks if t.startswith("restream-pass-")}
    assert lanes == {f"restream-pass-{j}" for j in range(1, passes_run + 1)}
    pass_spans = sorted((s for s in tr.spans if s.cat == "pass"), key=lambda s: s.t0)
    assert "rd" in pass_spans[0].attrs
    for s in pass_spans[1:]:
        assert "rd_delta" in s.attrs
    assert res.stats["trace_summary"]["events"] == summ.events
    assert summ.categories["scan"]["count"] == sum(res.stats["pass_scan_calls"])


def test_batched_restream_pass_lanes(graph):
    edges, n = graph
    streams, valid = EdgeStream(edges, n).split_padded(2)
    from repro_torch.core import restream_partition_batched

    tr = Tracer()
    res = restream_partition_batched(streams, valid, n, K, passes=2, window_max=8,
                                     trace=tr, **CPU)
    summ = tr.summary()
    assert {t for t in summ.tracks if t.startswith("restream-pass-")} == {
        "restream-pass-1", "restream-pass-2"}
    spans = sorted((s for s in tr.spans if s.cat == "pass"), key=lambda s: s.t0)
    assert spans[0].attrs["z"] == 2 and "rd_mean" in spans[0].attrs
    assert "rd_delta_max" in spans[1].attrs
    assert summ.categories["scan"]["count"] == sum(res[0].stats["pass_scan_calls"])


def test_engine_superstep_spans():
    from repro_torch.core import run_partitioner
    from repro_torch.engine import build_partitioned_graph, pagerank

    edges, n = rmat(7, 300, seed=3)
    assign = run_partitioner("hash", edges, n, 4, seed=0, **CPU).assign
    g = build_partitioned_graph(edges, assign, n, 4, **CPU)
    tr = Tracer()
    pr, info = pagerank(g, iters=3, trace=tr)
    assert tr.summary().categories["engine"]["count"] == 3
    steps = [s for s in tr.spans if s.name == "superstep"]
    assert len(steps) == 3
    for s in steps:
        assert s.attrs["slab_occupancy"] == [4] and s.attrs["n_shards"] == 1
    pr2, info2 = pagerank(g, iters=3)
    assert info2["supersteps"] == info["supersteps"]
    np.testing.assert_array_equal(pr, pr2)


def test_launcher_trace_file(tmp_path, capsys):
    from repro_torch.launch.partition import main

    path = tmp_path / "trace.json"
    out = main(["--graph", "tiny_clustered", "--scale", "0.1", "--k", "4", "--z", "2",
                "--spread", "2", "--window-max", "8", "--iters", "3", "--device", "cpu",
                "--trace", str(path)])
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names.count("partition") == 1 and names.count("superstep") == 3
    assert out["trace"]["categories"]["phase"]["count"] == 1
    assert capsys.readouterr().out.splitlines()[-1].startswith(f"trace: {len(doc['traceEvents'])} events")


# ----------------------------------------------------------------------------
# exporter: Chrome trace-event schema
# ----------------------------------------------------------------------------


def _record(tr, t0):
    with tr.span("outer", cat="phase", k=8):
        with tr.span("inner", cat="scan", rows=np.int64(7)):
            pass
    tr.add_span("staged", "stage", t0, t0 + 0.001, track="lane-2",
                attrs={"rows": np.float32(2.5)})
    tr.instant("mark", "refill", z=2)
    tr.gauge("depth", 3, track="lane-2")


def test_export_schema_and_validation(tmp_path):
    tr = Tracer()
    _record(tr, tr.t0)
    path = tmp_path / "trace.json"
    n = tr.export(str(path))
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == []
    events = doc["traceEvents"]
    assert n == len(events)
    x = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in x} == {"outer", "inner", "staged"}
    assert next(e for e in x if e["name"] == "inner")["args"]["rows"] == 7
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"main", "lane-2"} <= tracks
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_export_matches_the_jax_packages_exporter():
    """The copy keeps the JAX package's document layout: the same events,
    phases, names and tracks for the same recording."""
    a, b = Tracer(), JaxTracer()
    _record(a, a.t0)
    _record(b, b.t0)
    da, db = chrome_trace(a), jax_chrome_trace(b)
    key = lambda e: (e["ph"], e["name"], json.dumps(e.get("args", {}), sort_keys=True))  # noqa: E731
    assert sorted(map(key, da["traceEvents"])) == sorted(map(key, db["traceEvents"]))


def test_validator_catches_malformed():
    tr = Tracer()
    with tr.span("s", cat="scan"):
        pass
    ok = chrome_trace(tr)
    assert validate_chrome_trace(ok) == []
    assert validate_chrome_trace({"traceEvents": "nope"})
    assert validate_chrome_trace({"traceEvents": [dict(ok["traceEvents"][0], ph="Z")]})
    assert validate_chrome_trace({"traceEvents": [e for e in ok["traceEvents"] if e["ph"] != "X"]})


# ----------------------------------------------------------------------------
# SC003: tracer calls inside a port step closure
# ----------------------------------------------------------------------------


def test_sc003_flags_tracer_in_port_step_closure():
    from tools.staticcheck import check_source

    found = check_source(textwrap.dedent("""
        def make_step(self, stream, m_real, allowed, cap, prev_assign):
            trace = self.trace

            def step(carry, out):
                with trace.span("step", cat="scan"):
                    carry.cursor.add_(1)

            return step
    """), "src/repro_torch/core/virtual.py")
    assert {f.rule for f in found if not f.suppressed} == {"SC003"}
    assert any("tracer" in f.message for f in found)


def test_port_sources_pass_the_checker():
    """The port's driver traces in its stepping loop, never inside a step:
    no unsuppressed finding anywhere in the package."""
    from tools.staticcheck import check_paths

    found = [f for f in check_paths([str(REPO_ROOT / "src" / "repro_torch")]) if not f.suppressed]
    assert found == [], [(f.rule, f.path, f.line) for f in found]


def test_tracing_does_not_change_a_run_of_the_latency_budget():
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.1)
    cfg = AdwiseConfig(k=4, window_max=16, latency_budget=1e-3)
    off = partition_stream(edges, n, cfg, cost_per_score=3e-7, **CPU)
    on = partition_stream(edges, n, cfg, cost_per_score=3e-7, trace=Tracer(), **CPU)
    np.testing.assert_array_equal(off.assign, on.assign)
    np.testing.assert_array_equal(off.stats["w_trace"], on.stats["w_trace"])
