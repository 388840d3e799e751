"""The port on the card: each CUDA kernel against its plain torch version,
the CUDA-graph scan driver against the plain CPU loop (ADWISE, the HDRF,
Greedy, 2PS-L and clustering step-cores, warm passes, z spotlight
instances in one batched step, traced runs), the file ring (out-of-core
``partition_file``) against the CPU ring and the resident path, and the
LM families on the card against their CPU path.

Every test here needs a CUDA device; without one it skips. This file
imports neither ``jax`` nor ``repro``, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    AdwiseConfig, driver, partition_stream, registry, restream, spotlight_partition,
)
from repro_torch.core.adwise import partition_stream_batched
from repro_torch.core import partition_file
from repro_torch.graph import EdgeStream
from repro_torch.graph.io import EdgeFileReader, write_edge_file
from repro_torch.obs import Tracer, chrome_trace, validate_chrome_trace
from repro_torch.engine import build_partitioned_graph, pagerank
from repro_torch.graph import make_graph
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import device_kernels, ops, ref
from repro_torch.kernels.segment_sum import segment_layout
from repro_torch.models import lm

pytestmark = pytest.mark.cuda

WS_SHAPES = [
    (1, 2, True), (7, 3, True), (128, 32, True), (200, 20, True),
    (130, 64, False), (64, 5, False), (256, 32, True),
]
# b, hq, hkv, tq, tk, dh, causal — prefill, ragged edges, decode append,
# chunked continuation, GQA groups 1-4, non-causal at Tk = 256.
FA_SHAPES = [
    (1, 1, 1, 8, 8, 32, True), (2, 4, 2, 130, 130, 64, True),
    (1, 8, 1, 256, 256, 128, True), (2, 4, 4, 64, 64, 64, True),
    (1, 4, 2, 1, 513, 64, True), (1, 2, 2, 100, 356, 32, True),
    (1, 6, 2, 200, 200, 96, True), (2, 6, 2, 77, 300, 128, True),
    (1, 3, 1, 2000, 2000, 128, True), (2, 4, 2, 50, 256, 64, False),
]
FA_TOL = {torch.float32: 2e-3, torch.float16: 5e-3, torch.bfloat16: 2e-2}
SS_SHAPES = [
    (10, 8, 5, np.float32), (1000, 64, 300, np.float32),
    (3000, 32, 700, np.float32), (513, 128, 129, np.float32),
    (2048, 16, 256, np.float16), (20000, 1, 3000, np.float32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ws_inputs(w, k):
    rng = np.random.default_rng(w * 31 + k)
    return (
        rng.integers(0, 200, (w, 2)).astype(np.int32),
        rng.random(w) < 0.85,
        rng.random((w, k)) < 0.2,
        rng.random((w, k)) < 0.2,
        rng.integers(1, 40, w).astype(np.int32),
        rng.integers(1, 40, w).astype(np.int32),
        rng.random(k).astype(np.float32),
        rng.random(k) < 0.9,
    )


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_kernel_bit_equal_to_plain(cuda, w, k, use_cs):
    arrays = _ws_inputs(w, k)
    cpu = ops.window_score(*(torch.as_tensor(a) for a in arrays), 1.3, 40, use_cs=use_cs)
    gpu = ops.window_score(*(torch.as_tensor(a, device=cuda) for a in arrays), 1.3, 40,
                           use_cs=use_cs)
    np.testing.assert_array_equal(_bits(gpu), _bits(cpu))
    rows = torch.arange(w, dtype=torch.int32).flip(0)
    tables = _ws_table_inputs(w, k)
    a = ops.window_score_rows(*(torch.as_tensor(x) for x in tables), 40, rows,
                              use_cs=use_cs)
    b = ops.window_score_rows(*(torch.as_tensor(x, device=cuda) for x in tables), 40,
                              rows.to(cuda), use_cs=use_cs)
    np.testing.assert_array_equal(_bits(b), _bits(a))


def _ws_table_inputs(w, k, v=200, hub=False):
    """A window over a (v + 1)-row vertex table: ids in [0, v] (v is the
    table's dump row). With ``hub``, every slot's u is vertex 5, so slot 0
    matches every valid column, and a quarter of the ids are the dump row."""
    rng = np.random.default_rng(w * 29 + k)
    uv = rng.integers(0, v + 1, (w, 2)).astype(np.int32)
    if hub:
        uv[:, 0] = 5
        uv[rng.random(w) < 0.25, 1] = v
    valid = rng.random(w) < 0.85
    replicas = rng.random((v + 1, k)) < 0.2
    deg = rng.integers(1, 40, v + 1).astype(np.int32)
    return uv, valid, replicas, deg


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("k", [3, 32, 64, 130])
@pytest.mark.parametrize("w", [7, 200, 256])
def test_window_score_rows_kernel_bit_equal_on_tables(cuda, w, k, hub):
    """The row op reads the replica and degree tables itself: bit-equal to
    the plain version, for int32 and int64 slots, with the hub row, the
    dump slot (W - 1, where the step sends unused selections) and the
    table's dump row."""
    tables = _ws_table_inputs(w, k, hub=hub)
    rows = np.concatenate([[0, w - 1, w - 1], np.random.default_rng(w + k).integers(0, w, 29)])
    for dtype in (np.int32, np.int64):
        r = torch.as_tensor(rows.astype(dtype))
        for use_cs in (True, False):
            want = ops.window_score_rows(*(torch.as_tensor(x) for x in tables), 40, r,
                                         use_cs=use_cs)
            got = ops.window_score_rows(*(torch.as_tensor(x, device=cuda) for x in tables), 40,
                                        r.to(cuda), use_cs=use_cs)
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _ws_batch_inputs(z, w, k, v=200):
    """z windows over z (v + 1)-row vertex tables, each its own draw;
    instance 1 (when z > 1) is a hub window whose ids include the dump row."""
    rng = np.random.default_rng(z * 13 + w + k)
    uv = rng.integers(0, v + 1, (z, w, 2)).astype(np.int32)
    if z > 1:
        uv[1, :, 0] = 5
        uv[1, rng.random(w) < 0.25, 1] = v
    valid = rng.random((z, w)) < 0.85
    replicas = rng.random((z, v + 1, k)) < 0.2
    deg = rng.integers(1, 40, (z, v + 1)).astype(np.int32)
    max_deg = rng.integers(1, 60, z).astype(np.int32)
    return (uv, valid, replicas, deg), max_deg


@pytest.mark.parametrize("z", [1, 3, 8])
@pytest.mark.parametrize("k", [3, 32])
@pytest.mark.parametrize("w", [7, 256])
def test_window_score_batched_kernel_equals_single_launches(cuda, z, w, k):
    """One launch for z instances: bit-equal per instance to z = 1 launches
    and to the batched plain version, for int32 and int64 rows, with the
    dump slot, a hub window and the tables' dump rows."""
    (uv, valid, rep, deg), md = _ws_batch_inputs(z, w, k)
    rng = np.random.default_rng(w + k + z)
    rows = np.concatenate([np.tile([0, w - 1, w - 1], (z, 1)), rng.integers(0, w, (z, 29))], 1)
    for dtype in (np.int32, np.int64):
        r = rows.astype(dtype)
        for use_cs in (True, False):
            cpu = [torch.as_tensor(x) for x in (uv, valid, rep, deg, md, r)]
            gpu = [x.to(cuda) for x in cpu]
            before = ops.launch_counts()["window_score"]
            got = ops.window_score_rows_batched(*gpu, use_cs=use_cs)
            assert ops.launch_counts()["window_score"] - before == 1
            want = ops.window_score_rows_batched(*cpu, use_cs=use_cs)
            np.testing.assert_array_equal(_bits(got), _bits(want))
            for i in range(z):
                one = ops.window_score_rows(*(x[i] for x in gpu), use_cs=use_cs)
                np.testing.assert_array_equal(_bits(got[i]), _bits(one))


def test_window_score_kernel_rejects_bad_input(cuda):
    t = [torch.as_tensor(a, device=cuda) for a in _ws_inputs(7, 3)]
    lam = torch.tensor(1.3, device=cuda)
    md = torch.tensor(40, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="rep_u must be torch.bool"):
        ops.window_score(t[0], t[1], t[2].float(), *t[3:], lam, md)
    with pytest.raises(ValueError, match="share one device"):
        ops.window_score(t[0].cpu(), *t[1:], lam, md)


@pytest.mark.parametrize("e,d,s,dtype", SS_SHAPES)
def test_segment_sum_kernel_matches_plain(cuda, e, d, s, dtype):
    rng = np.random.default_rng(e + d)
    seg = np.sort(rng.integers(0, s, e)).astype(np.int32)
    data = torch.as_tensor(rng.normal(size=(e, d)).astype(dtype))
    cpu = ops.segment_sum_sorted(data, segment_layout(seg, s, "cpu"))
    lay = segment_layout(seg, s, cuda)
    gpu = ops.segment_sum_sorted(data.to(cuda), lay)
    again = ops.segment_sum_sorted(data.to(cuda), lay)
    tol = 2e-3 if dtype == np.float16 else 1e-5
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), rtol=tol, atol=tol)
    assert torch.equal(gpu, again)  # deterministic: no atomics


@pytest.mark.parametrize("d", [1, 5, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_segment_sum_kernel_exact_on_a_hub(cuda, d, dtype):
    # One 20,000-row hub among short runs and empty segments; small-integer
    # data keeps every partial sum exact, so any order gives the same bits.
    rng = np.random.default_rng(d)
    seg = np.sort(np.concatenate([rng.integers(0, 500, 3000), np.full(20000, 250)])).astype(np.int32)
    data = torch.as_tensor(rng.integers(-4, 5, (len(seg), d))).to(dtype)
    want = ops.segment_sum_sorted(data, segment_layout(seg, 600, "cpu"))
    got = ops.segment_sum_sorted(data.to(cuda), segment_layout(seg, 600, cuda))
    assert torch.equal(got.cpu(), want)


# Segment run lengths with the plan's edge cases at the kernel's tiles of
# 2,048 items: runs ending exactly at a tile edge, tiles wholly inside a hub,
# a run of empty segments longer than a tile, no rows at all, and one
# segment over several tiles.
SS_RUNS = {
    "tile edges": [2047, 1, 2046, 0, 0, 2048, 3, 4093],
    "hub": [5, 20000, 3, 0, 7],
    "empty run": [4] + [0] * 2100 + [6, 1],
    "no rows": [0] * 5000,
    "one segment": [16000],
    "random": list(np.random.default_rng(3).integers(0, 9, 5000)),
}


def _runs_layout(runs, device):
    runs = np.asarray(runs)
    seg = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    return seg, segment_layout(seg, len(runs), device)


@pytest.mark.parametrize("case", sorted(SS_RUNS))
@pytest.mark.parametrize("d", [1, 3, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_sum_kernel_exact_at_tile_edges(cuda, case, d, dtype, aligned):
    # Small integers: the kernel's order of adds must give the plain
    # version's bits. aligned=False hands the kernel data one element off a
    # 16-byte boundary (its scalar loads).
    seg, lay = _runs_layout(SS_RUNS[case], cuda)
    rng = np.random.default_rng(d)
    data = torch.as_tensor(rng.integers(-4, 5, (len(seg), d))).to(dtype)
    want = ops.segment_sum_sorted(data, segment_layout(seg, lay.num_segments, "cpu"))
    buf = torch.empty((len(seg) * d + 1,), dtype=dtype, device=cuda)
    x = buf[int(not aligned):][: len(seg) * d].view(len(seg), d)
    x.copy_(data.to(cuda))
    got = ops.segment_sum_sorted(x, lay)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ops.segment_sum_sorted(x, lay), got)
    assert int(lay.counters.abs().sum()) == 0


def test_segment_sum_kernel_graph_replays_equal_eager(cuda):
    # Several calls captured in one CUDA graph and replayed twice give the
    # eager bits each time: the counters are back at 0 after every launch.
    seg, lay = _runs_layout(SS_RUNS["hub"] * 5, cuda)
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.normal(size=(len(seg), d)).astype(np.float32)).to(cuda) for d in (1, 1, 256)]
    eager = [ops.segment_sum_sorted(x, lay) for x in xs]
    assert lay.cross.shape[0] > 0
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.segment_sum_sorted(x, lay) for x in xs]
    for _ in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)
        assert int(lay.counters.abs().sum()) == 0


def test_segment_sum_kernel_widths_alternate_on_one_layout(cuda):
    # Eager calls at D = 1 and D = 256 take turns on one layout: they share
    # its counters (and each width has its own slots), so each call must
    # leave the counters at 0 for the next, whatever its width.
    seg, lay = _runs_layout(SS_RUNS["hub"] * 3, cuda)
    rng = np.random.default_rng(7)
    xs = {d: torch.as_tensor(rng.integers(-4, 5, (len(seg), d))).float() for d in (1, 256)}
    want = {d: ops.segment_sum_sorted(x, segment_layout(seg, lay.num_segments, "cpu"))
            for d, x in xs.items()}
    xs = {d: x.to(cuda) for d, x in xs.items()}
    assert lay.cross.shape[0] > 0
    for d in (1, 256, 1, 256, 256, 1):
        assert torch.equal(ops.segment_sum_sorted(xs[d], lay).cpu(), want[d])
        assert int(lay.counters.abs().sum()) == 0


def test_segment_sum_layout_refuses_a_second_stream(cuda):
    # The layout is the kernel's scratch: an eager call on another stream
    # than its first raises, and the first stream's calls go on unharmed.
    seg, lay = _runs_layout(SS_RUNS["hub"] * 3, cuda)
    x = torch.ones((len(seg), 1), device=cuda)
    want = ops.segment_sum_sorted(x, lay)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="first used on"):
            ops.segment_sum_sorted(x, lay)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(ops.segment_sum_sorted(x, lay), want)
    assert int(lay.counters.abs().sum()) == 0
    # A fresh layout may live on the side stream.
    with torch.cuda.stream(side):
        other = segment_layout(seg, lay.num_segments, cuda)
        got = ops.segment_sum_sorted(x, other)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [1, 5, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_segment_sum_is_one_kernel_per_call(cuda, d, dtype):
    from torch.profiler import ProfilerActivity, profile

    seg, lay = _runs_layout(SS_RUNS["hub"] * 3, cuda)
    x = torch.ones((len(seg), d), dtype=dtype, device=cuda)
    ops.segment_sum_sorted(x, lay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.segment_sum_sorted(x, lay)
        torch.cuda.synchronize()
    kern = [(e.key, e.count) for e in device_kernels(prof)]
    assert sum(c for _, c in kern) == 5 and all("segsum_" in k for k, _ in kern), kern


@pytest.mark.parametrize("d", [1, 256])
def test_segment_sum_kernel_brain_like_within_fp32_bound(cuda, d):
    # The engine's message layout of brain_like at full scale (runs up to
    # 37,078 rows): within n·2^-24·Σ|x| of the fp64 sum, per segment.
    edges, n = make_graph("brain_like", seed=0, scale=1.0)
    seg = np.sort(np.concatenate([edges[:, 1], edges[:, 0]]), kind="stable").astype(np.int32)
    lay = segment_layout(seg, n, cuda)
    x = torch.as_tensor(np.random.default_rng(d).normal(size=(len(seg), d)).astype(np.float32)).to(cuda)
    got = ops.segment_sum_sorted(x, lay).double()
    idx = lay.seg_ids.long()
    exact = torch.zeros((n, d), dtype=torch.float64, device=cuda).index_add_(0, idx, x.double())
    mag = torch.zeros((n, d), dtype=torch.float64, device=cuda).index_add_(0, idx, x.double().abs())
    runs = torch.as_tensor(np.bincount(seg, minlength=n), dtype=torch.float64, device=cuda)[:, None]
    assert bool(((got - exact).abs() <= runs * 2.0**-24 * mag).all())


@pytest.mark.parametrize("steps_per_graph", [1, 7, 32])
def test_graph_replayed_scan_equals_cpu_loop(cuda, steps_per_graph, monkeypatch):
    monkeypatch.setattr(driver, "STEPS_PER_GRAPH", steps_per_graph)
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    cfg = AdwiseConfig(k=4, window_max=32, lazy=False)
    before = ops.launch_counts()["window_score"]
    gpu = partition_stream(edges, n, cfg, device=cuda)
    launches = ops.launch_counts()["window_score"] - before
    cpu = partition_stream(edges, n, cfg, device="cpu")
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    np.testing.assert_array_equal(gpu.stats["w_trace"], cpu.stats["w_trace"])
    assert gpu.stats["score_rows"] == cpu.stats["score_rows"]
    assert launches == gpu.stats["steps_run"] + gpu.stats["warmup_steps"]


@pytest.mark.parametrize("steps_per_graph", [1, 7, 32])
@pytest.mark.parametrize("name,cfg", [
    ("hdrf", dict(seed=3)),
    ("hdrf", dict(seed=2**32 - 1, lam=1.5, allowed=np.array([1, 0, 1, 1, 0, 1], bool))),
    ("greedy", {}),
    ("greedy", dict(allowed=np.array([0, 1, 1, 0, 1, 1], bool))),
    ("2ps-l", {}),
    ("2ps-l", dict(cap_slack=1.3, allowed=np.array([1, 1, 0, 1, 0, 1], bool))),
])
def test_single_edge_cores_captured_equal_cpu(cuda, name, cfg, steps_per_graph, monkeypatch):
    # The captured step-cores on the card against the same code's CPU loop,
    # and against their numpy oracles (2PS-L's clustering phase included).
    monkeypatch.setattr(driver, "STEPS_PER_GRAPH", steps_per_graph)
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    edges = np.concatenate([edges, edges[:7], np.stack([edges[:9, 0]] * 2, 1)])  # dups, loops
    gpu = registry.run_partitioner(name, edges, n, 6, device=cuda, **cfg)
    cpu = registry.run_partitioner(name, edges, n, 6, device="cpu", **cfg)
    oracle = registry.run_partitioner(name, edges, n, 6, device="cpu", scan=False, **cfg)
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    np.testing.assert_array_equal(gpu.assign, oracle.assign)
    for key in ("score_rows", "h2d_rows", "h2d_bytes", "warm", "scan_calls"):
        assert gpu.stats[key] == cpu.stats[key], key


@pytest.mark.parametrize("steps_per_graph", [1, 32])
def test_clustering_captured_equals_numpy_oracle(cuda, steps_per_graph, monkeypatch):
    monkeypatch.setattr(driver, "STEPS_PER_GRAPH", steps_per_graph)
    edges, n = make_graph("tiny_social", seed=2, scale=0.5)
    for slack in (1.25, 0.2):
        got = restream.streaming_vertex_clustering(edges, n, 8, cluster_slack=slack, device=cuda)
        want = restream.streaming_vertex_clustering_np(edges, n, 8, cluster_slack=slack)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    deg = restream._degrees(edges, n)
    state = restream.VertexClusteringState(n, 8, len(edges), deg, chunk_edges=333, device=cuda)
    for i in range(0, len(edges), 333):
        state.update(edges[i:i + 333])
    for a, b in zip(state.finalize(), restream.streaming_vertex_clustering_np(edges, n, 8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,cfg", [
    ("adwise-restream", dict(passes=3, window_max=32, lazy=False)),
    ("adwise-restream", dict(passes=2, base="greedy", window_max=16, lazy=False)),
    ("2ps", dict(lazy=False)),
])
def test_warm_passes_captured_equal_cpu(cuda, name, cfg):
    # Warm-started ADWISE passes (revocation through the prev table, a shared
    # StreamResidency) on the card against the CPU loop; non-lazy, so the
    # order-dependent Θ sum does not enter.
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    before = ops.launch_counts()["window_score"]
    gpu = registry.run_partitioner(name, edges, n, 4, device=cuda, **cfg)
    launches = ops.launch_counts()["window_score"] - before
    cpu = registry.run_partitioner(name, edges, n, 4, device="cpu", **cfg)
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    for key in ("score_rows", "h2d_rows", "h2d_bytes", "warm"):
        assert gpu.stats[key] == cpu.stats[key], key
    if name == "adwise-restream":
        assert gpu.stats["pass_rd"] == cpu.stats["pass_rd"]
        adwise_passes = gpu.stats["pass_steps"][0 if cfg.get("base", "adwise") == "adwise" else 1:]
        assert launches == sum(adwise_passes) and gpu.stats["pass_steps"][-1] > 0


SPOT = [
    ("adwise", None), ("hdrf", None), ("greedy", None), ("2ps-l", None),
    ("2ps", dict(window_max=16, window_init=4, lazy=False)),
    ("adwise-restream", dict(passes=2, window_max=16, window_init=4, lazy=False)),
]


@pytest.mark.parametrize("strategy,cfg", SPOT, ids=[s for s, _ in SPOT])
def test_spotlight_batched_captured_equals_cpu_and_loop(cuda, strategy, cfg):
    """z = 4 instances in one captured batched step: equal to the CPU path
    (non-lazy ADWISE, so Θ does not enter) and to the card's loop backend
    (lazy ADWISE included), with one window_score launch per step."""
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    acfg = AdwiseConfig(k=8, window_max=16, window_init=4, lazy=False) if strategy == "adwise" else None
    kw = dict(strategy=strategy, cfg=acfg, strategy_cfg=cfg, seed=3)
    before = ops.launch_counts()["window_score"]
    gpu = spotlight_partition(edges, n, 8, 4, 2, device=cuda, **kw)
    launches = ops.launch_counts()["window_score"] - before
    cpu = spotlight_partition(edges, n, 8, 4, 2, device="cpu", **kw)
    loop = spotlight_partition(edges, n, 8, 4, 2, device=cuda, backend="loop", **kw)
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    np.testing.assert_array_equal(gpu.assign, loop.assign)
    if strategy in ("adwise", "2ps"):
        assert launches == gpu.stats["steps_run"] + gpu.stats["warmup_steps"]
    if strategy == "adwise":
        lazy = dict(kw, cfg=AdwiseConfig(k=8, window_max=16, window_init=4))
        a = spotlight_partition(edges, n, 8, 4, 2, device=cuda, **lazy)
        b = spotlight_partition(edges, n, 8, 4, 2, device=cuda, backend="loop", **lazy)
        np.testing.assert_array_equal(a.assign, b.assign)


def test_lazy_adwise_card_equals_cpu(cuda):
    """Θ's sum is exact in fp64, so lazy traversal — the one place the
    order of a float sum entered the step — picks the same rows on both
    devices, at z = 1 and z = 3."""
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    cfg = AdwiseConfig(k=4, window_max=32)
    gpu = partition_stream(edges, n, cfg, device=cuda)
    cpu = partition_stream(edges, n, cfg, device="cpu")
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    assert gpu.stats["score_rows"] == cpu.stats["score_rows"]
    streams, valid = EdgeStream(edges, n).split_padded(3)
    a = partition_stream_batched(streams, valid, n, cfg, device=cuda)
    b = partition_stream_batched(streams, valid, n, cfg, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.assign, y.assign)


def test_batched_step_launches_window_score_once_per_step(cuda):
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.5)
    streams, valid = EdgeStream(edges, n).split_padded(8)
    before = ops.launch_counts()["window_score"]
    res = partition_stream_batched(streams, valid, n, AdwiseConfig(k=16, window_max=32),
                                   device=cuda)
    launches = ops.launch_counts()["window_score"] - before
    st = res[0].stats
    assert st["n_buckets"] == 1 and st["z"] == 8
    assert launches == st["steps_run"] + st["warmup_steps"]


def test_traced_captured_run_equals_untraced(cuda):
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    kw = dict(passes=2, window_max=16, window_init=4)
    tr = Tracer()
    traced = restream.restream_partition(edges, n, 4, trace=tr, device=cuda, **kw)
    plain = restream.restream_partition(edges, n, 4, device=cuda, **kw)
    np.testing.assert_array_equal(traced.assign, plain.assign)
    cats = tr.summary().categories
    assert cats["scan"]["count"] == sum(traced.stats["pass_scan_calls"])
    assert cats["pass"]["count"] == 2
    scans = [s for s in tr.spans if s.name == "scan-call"]
    assert sum(bool(s.attrs.get("compiled")) for s in scans) == 2  # one capture per pass
    assert validate_chrome_trace(chrome_trace(tr)) == []


def test_pagerank_on_the_card_matches_cpu(cuda):
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.5)
    assign = (np.arange(len(edges)) % 4).astype(np.int32)
    a, _ = pagerank(build_partitioned_graph(edges, assign, n, 4, device="cpu"), iters=20)
    before = ops.launch_counts()["segment_sum"]
    b, _ = pagerank(build_partitioned_graph(edges, assign, n, 4, device=cuda), iters=20)
    assert ops.launch_counts()["segment_sum"] - before == 20
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8)


RING = [
    ("adwise", dict(window_max=16), 1), ("hdrf", {}, 1), ("greedy", {}, 1),
    ("2ps", dict(window_max=16), 1), ("2ps-l", {}, 1),
    ("adwise-restream", dict(window_max=16, passes=2), 1),
    ("adwise", dict(window_max=16), 4), ("hdrf", {}, 4),
]
_RING_KEYS = ("h2d_rows", "h2d_bytes", "scan_calls", "buffer_rows", "refill_spans")


def _ring_file(tmp_path, scale=0.2):
    edges, n = make_graph("tiny_clustered", seed=1, scale=scale)
    path = str(tmp_path / "g.adw")
    write_edge_file(path, edges, n)
    return path, edges, n


def _from_file(path, strategy, device, spill, z=1, **kw):
    with EdgeFileReader(path) as r:
        return partition_file(r, strategy, 8, z=z, spread=2 if z > 1 else None, seed=3,
                              chunk_edges=96, spill_dir=spill, device=device, **kw)


@pytest.mark.parametrize("strategy,cfg,z", RING, ids=[f"{s}-z{z}" for s, _, z in RING])
def test_file_ring_card_equals_cpu_ring_and_resident(cuda, tmp_path, strategy, cfg, z):
    """The ring on the card (wrapping: 96-row chunks) == the same ring on the
    CPU == the resident path on the card, with the CPU ring's counters."""
    path, edges, n = _ring_file(tmp_path)
    gpu = _from_file(path, strategy, cuda, str(tmp_path / "g"), z, **cfg)
    cpu = _from_file(path, strategy, "cpu", str(tmp_path / "c"), z, **cfg)
    if z == 1:
        resident = registry.run_partitioner(strategy, edges, n, 8, seed=3, device=cuda, **cfg)
    else:
        acfg = AdwiseConfig(k=8, seed=3, **cfg) if strategy == "adwise" else None
        resident = spotlight_partition(edges, n, 8, z, 2, strategy=strategy, cfg=acfg, seed=3,
                                       device=cuda)
    np.testing.assert_array_equal(np.asarray(gpu.assign), np.asarray(cpu.assign))
    np.testing.assert_array_equal(np.asarray(gpu.assign), resident.assign)
    for key in _RING_KEYS:
        assert gpu.stats[key] == cpu.stats[key], key
    assert gpu.stats["buffer_rows"] < len(edges) // z  # the ring wraps


def test_file_ring_prefetch_0_equals_2(cuda, tmp_path):
    path, _, _ = _ring_file(tmp_path)
    a = _from_file(path, "adwise", cuda, str(tmp_path / "a"), prefetch=0, window_max=16)
    b = _from_file(path, "adwise", cuda, str(tmp_path / "b"), prefetch=2, window_max=16)
    np.testing.assert_array_equal(np.asarray(a.assign), np.asarray(b.assign))
    assert a.stats["spans_prestaged"] == 0 and b.stats["prefetch_depth"] == 2
    assert b.stats["spans_prestaged"] + b.stats["spans_missed"] == b.stats["refill_spans"]


def test_ring_address_stable_over_a_pass_and_across_adoption(cuda, tmp_path):
    """Every refill of a pass writes into the one ring the captured graphs
    read, and a re-streaming pass that adopts the RingHandle writes into
    the same tensors, shipping only the 4 B/row prev table."""
    path, edges, n = _ring_file(tmp_path)
    m = len(edges)
    cfg = AdwiseConfig(k=8, window_max=16)
    out = np.full((m,), -1, np.int32)

    def sink(i, idx, p):
        out[idx] = p

    def two_passes(r, chunk_edges):
        src = driver.FileSource([r], chunk_edges=chunk_edges, cfg=cfg)
        drv = driver.ScanDriver(src, cfg, n, device=cuda)
        res = drv.run(on_assign=sink)
        prev = out.copy()
        warm = restream.warm_from_assignment(edges, prev, n, 8)._replace(prev_assign=None)
        src2 = driver.FileSource([r], chunk_edges=chunk_edges, cfg=cfg, resume=drv.ring_handle,
                                 prev_read=[lambda s, c: prev[s:s + c]])
        drv2 = driver.ScanDriver(src2, cfg, n, warm=[warm], device=cuda)
        res2 = drv2.run(on_assign=sink)
        return drv, res, drv2, res2

    with EdgeFileReader(path) as r:
        # 128-row chunks: the ring wraps, so pass 2 takes a fresh ring and
        # ships uv again (12 B/row).
        drv, res, drv2, res2 = two_passes(r, 128)
        assert res.scan_calls > 1 and drv.stats_base(res, 0)["ring_addrs"] == 1
        assert res2.h2d_bytes == 12 * m and res2.ring_addrs == 1
        # A ring that holds the whole stream is adopted: same tensors.
        drv, res, drv2, res2 = two_passes(r, 4 * m)
        assert drv2.ring_handle.buf.uv.data_ptr() == drv.ring_handle.buf.uv.data_ptr()
        assert res2.ring_addrs == 1 and res2.h2d_rows == 0 and res2.h2d_bytes == 4 * m


def test_file_ring_launches_window_score_once_per_replayed_step(cuda, tmp_path):
    path, edges, _ = _ring_file(tmp_path)
    before = ops.launch_counts()["window_score"]
    res = _from_file(path, "adwise", cuda, str(tmp_path / "w"), window_max=16)
    launches = ops.launch_counts()["window_score"] - before
    st = res.stats
    assert launches == st["steps_run"] + st["warmup_steps"]
    assert st["steps_run"] == st["scan_calls"] * st["scan_steps_per_call"]
    assert st["h2d_rows"] == len(edges) and st["h2d_bytes"] == 8 * len(edges)


def _fa_inputs(shape, dtype, device):
    b, hq, hkv, tq, tk, dh, _ = shape
    rng = np.random.default_rng(b * 7 + tq + dh)
    return [torch.as_tensor(rng.normal(size=sh).astype(np.float32)).to(device=device, dtype=dtype)
            for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh))]


@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _fa_inputs(shape, dtype, cuda)
    causal = shape[-1]
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] - before == 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dh", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_strided_views(cuda, dh, dtype):
    """q, k, v as (B, H, T, Dh) views of (B, T, H, Dh) tensors, as the
    model passes them, and an explicit scale: the same as contiguous."""
    rng = np.random.default_rng(dh)
    qt, kt, vt = (torch.as_tensor(rng.normal(size=(2, 150, h, dh)).astype(np.float32))
                  .to(device=cuda, dtype=dtype) for h in (6, 2, 2))
    q, k, v = (t.transpose(1, 2) for t in (qt, kt, vt))
    body = fa.body_for(dtype, dh)
    before = fa.LAUNCHES_BY_BODY[body]
    got = ops.flash_attention(q, k, v, scale=0.2)
    assert fa.LAUNCHES_BY_BODY[body] - before == 1
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=0.2)
    assert torch.equal(got, want)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), scale=0.2).float().numpy(),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_flash_attention_kernel_takes_unaligned_rows(cuda, dtype):
    """16-bit rows that do not start on 16 bytes (an odd offset into a
    buffer) give the same result as the aligned input."""
    shape = (1, 4, 70, 64)
    n = int(np.prod(shape))
    buf = torch.randn(3 * n + 1, generator=torch.Generator().manual_seed(0)).to(device=cuda,
                                                                                 dtype=dtype)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(shape) for i in range(3))
    assert q.data_ptr() % 16 != 0
    before = fa.LAUNCHES_BY_BODY["wgmma"]
    got = ops.flash_attention(q, k, v)
    assert fa.LAUNCHES_BY_BODY["wgmma"] - before == 1  # after a contiguous copy
    assert torch.equal(got, ops.flash_attention(q.clone(), k.clone(), v.clone()))
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


# b, hq, hkv, tq, tk, causal: one tile, a ragged tile, many tiles, decode
# append, GQA groups 8, 1 and 3, non-causal at Tk = 256.
WG_SHAPES = [
    (1, 2, 2, 128, 128, True), (1, 3, 1, 129, 129, True), (1, 3, 1, 2000, 2000, True),
    (1, 8, 1, 1, 513, True), (2, 8, 8, 129, 129, True), (1, 6, 2, 300, 300, True),
    (2, 4, 2, 50, 256, False), (1, 4, 2, 256, 256, False),
]


@pytest.mark.parametrize("shape", WG_SHAPES)
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_flash_attention_wgmma_body_matches_plain(cuda, shape, dh, dtype):
    b, hq, hkv, tq, tk, causal = shape
    q, k, v = _fa_inputs((b, hq, hkv, tq, tk, dh, causal), dtype, cuda)
    before = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES_BY_BODY["wgmma"] - before["wgmma"] == 1
    assert sum(fa.LAUNCHES_BY_BODY.values()) - sum(before.values()) == 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), rtol=tol, atol=tol)


def test_flash_attention_kernel_rejects_bad_input(cuda):
    q = torch.zeros(1, 4, 8, 32, device=cuda)
    k = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="Dh must be one of"):
        ops.flash_attention(torch.zeros(1, 4, 8, 80, device=cuda),
                            torch.zeros(1, 2, 8, 80, device=cuda),
                            torch.zeros(1, 2, 8, 80, device=cuda))
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="k is torch.float16"):
        ops.flash_attention(q, k.half(), k)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ops.flash_attention(torch.zeros(1, 4, 32, 8, device=cuda).transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="share one device"):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        ops.flash_attention(torch.zeros(1, 4, 9, 32, device=cuda), k, k)


# b, hq, hkv, tq, tk, dh: non-causal at a Tk no tile divides — what the op
# refused before (Tk = 8, 200), whisper's encoder (224 frames), its
# cross-attention in prefill (Tq 448) and decode (Tq = 1), one key — at
# every head dim, so each body is reached.
RAGGED_NON_CAUSAL = [
    (1, 4, 2, 8, 8, 32), (1, 4, 2, 8, 200, 32), (2, 6, 6, 224, 224, 64),
    (2, 6, 6, 448, 224, 64), (2, 6, 6, 1, 224, 64), (1, 3, 1, 1, 1, 128),
    (1, 4, 4, 77, 300, 96), (1, 4, 4, 130, 300, 112), (2, 4, 2, 1, 129, 128),
]


@pytest.mark.parametrize("shape", RAGGED_NON_CAUSAL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_non_causal_any_tk_matches_plain(cuda, shape, dtype):
    """The kernel masks the columns at or past Tk on every body, so a
    non-causal call takes any Tk and Tq: one launch of the body
    ``body_for`` names, within FA_TOL of the plain version."""
    b, hq, hkv, tq, tk, dh = shape
    q, k, v = _fa_inputs((b, hq, hkv, tq, tk, dh, False), dtype, cuda)
    body = fa.body_for(dtype, dh)
    before = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention(q, k, v, causal=False)
    assert fa.LAUNCHES_BY_BODY[body] - before[body] == 1
    assert sum(fa.LAUNCHES_BY_BODY.values()) - sum(before.values()) == 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=False)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(1, 4, 4, 130, 130, True), (2, 8, 8, 77, 300, True),
                                   (4, 32, 32, 256, 256, True), (1, 4, 2, 64, 200, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_flash_attention_dh112_matches_plain(cuda, shape, dtype):
    """Dh 112 (zamba2's): ``mma_sync`` for 16-bit inputs (7 k-steps of
    m16n8k16), ``fma`` for fp32."""
    b, hq, hkv, tq, tk, causal = shape
    q, k, v = _fa_inputs((b, hq, hkv, tq, tk, 112, causal), dtype, cuda)
    body = "fma" if dtype == torch.float32 else "mma_sync"
    assert fa.body_for(dtype, 112) == body
    before = fa.LAUNCHES_BY_BODY[body]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES_BY_BODY[body] - before == 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), rtol=tol, atol=tol)


def test_dense_lm_on_the_card_matches_cpu(cuda):
    """Reduced llama3.2-3b (fp32): prefill + 3 decode steps on the card
    against the same weights on the CPU; one kernel launch per layer in the
    prefill, none in decode."""
    cfg = get_config("llama3.2-3b").reduced()
    cpu_model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    gpu_model = lm.LM(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)),
                              dtype=torch.int32)
    caches = [lm.init_cache(cfg, 2, 44, device=d) for d in ("cpu", cuda)]
    before = ops.launch_counts()["flash_attention"]
    a, _ = lm.forward_cached(cpu_model, cfg, caches[0], prompts, 0)
    b, _ = lm.forward_cached(gpu_model, cfg, caches[1], prompts.to(cuda), 0)
    assert ops.launch_counts()["flash_attention"] - before == cfg.n_layers
    np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=2e-3, atol=2e-3)
    tok = a[:, -1:].argmax(-1).to(torch.int32)
    before = ops.launch_counts()["flash_attention"]
    for i in range(3):
        a, _ = lm.forward_cached(cpu_model, cfg, caches[0], tok, 40 + i)
        b, _ = lm.forward_cached(gpu_model, cfg, caches[1], tok.to(cuda), 40 + i)
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=2e-3, atol=2e-3)
        tok = a[:, -1:].argmax(-1).to(torch.int32)
    assert ops.launch_counts()["flash_attention"] == before
    for x, y in zip(caches[0]["kv"], caches[1]["kv"]):
        np.testing.assert_allclose(y.cpu().numpy(), x.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b", "rwkv6-7b",
                                  "zamba2-7b", "whisper-tiny"])
def test_lm_family_on_the_card_matches_cpu(cuda, arch):
    """Each family's reduced model (fp32): prefill (whisper's frames, the
    vlm's patches) + 3 decode steps on the card against the same weights
    on the CPU, logits and cache within 1e-4 of their scale (fp32 products
    in another order; the SSM scans scale by exp(±Σ log w)); the flash
    launches of each phase as ``forward_cached`` states them."""
    cfg = get_config(arch).reduced()
    cpu_model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    gpu_model = lm.LM(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(0)
    b, t, n_dec = 2, 45, 3
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)), dtype=torch.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(rng.normal(size=(b, t // 2, cfg.d_model)),
                                       dtype=torch.float32)
    if cfg.family == "vlm":
        kw["patches"] = torch.as_tensor(rng.normal(size=(b, cfg.vlm_patches, cfg.d_model)),
                                        dtype=torch.float32)
    offset = cfg.vlm_patches if cfg.family == "vlm" else 0
    caches = [lm.init_cache(cfg, b, t + n_dec, device=d) for d in ("cpu", cuda)]
    n_apps = cfg.n_layers // cfg.shared_every
    prefill_launches = {"moe": cfg.n_layers, "vlm": cfg.n_layers, "ssm": 0, "hybrid": n_apps,
                        "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}[cfg.family]
    decode_launches = cfg.n_layers if cfg.family == "encdec" else 0

    def close(got, want):
        want = want.float()
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)

    before = ops.launch_counts()["flash_attention"]
    a, _ = lm.forward_cached(cpu_model, cfg, caches[0], prompts, 0, **kw)
    g, _ = lm.forward_cached(gpu_model, cfg, caches[1], prompts.to(cuda), 0,
                             **{k: v.to(cuda) for k, v in kw.items()})
    assert ops.launch_counts()["flash_attention"] - before == prefill_launches
    close(g, a)
    tok = a[:, -1:].argmax(-1).to(torch.int32)
    before = ops.launch_counts()["flash_attention"]
    for i in range(n_dec):
        a, _ = lm.forward_cached(cpu_model, cfg, caches[0], tok, offset + t + i)
        g, _ = lm.forward_cached(gpu_model, cfg, caches[1], tok.to(cuda), offset + t + i)
        close(g, a)
        tok = a[:, -1:].argmax(-1).to(torch.int32)
    assert ops.launch_counts()["flash_attention"] - before == n_dec * decode_launches

    def leaves(c):
        if isinstance(c, dict):
            return [x for k in sorted(c) for x in leaves(c[k])]
        if isinstance(c, (list, tuple)):
            return [x for v in c for x in leaves(v)]
        return [c]

    for x, y in zip(leaves(caches[0]), leaves(caches[1])):
        close(y, x)


# b, hq, hkv, tq, tk, dh, causal: wgmma (bf16, Dh 64/128), mma_sync (Dh 32),
# fma (fp32), Tq < Tk, non-causal.
FN_SHAPES = [
    (1, 6, 2, 300, 300, 128, True), (2, 4, 2, 130, 200, 64, True),
    (1, 4, 1, 77, 77, 32, True), (1, 4, 2, 40, 256, 64, False),
]


@pytest.mark.parametrize("shape", FN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_grads_on_the_card(cuda, shape, dtype):
    """The op under autograd on the card: its forward is the bare kernel's
    output bit for bit (one launch, with a grad_fn); dq/dk/dv against
    autograd through the plain version on the card — within 1e-5 in fp32
    (summation order), one bf16 ulp (2^-7 relative) in bf16."""
    b, hq, hkv, tq, tk, dh, causal = shape
    rng = np.random.default_rng(dh)
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32)).to(cuda, dtype)
               .requires_grad_(True)
               for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
    dout = torch.as_tensor(rng.normal(size=(b, hq, tq, dh)).astype(np.float32)).to(cuda, dtype)
    before, bwd0 = ops.launch_counts()["flash_attention"], fa.BACKWARD_CALLS
    out = ops.flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None and ops.launch_counts()["flash_attention"] - before == 1
    with torch.no_grad():
        assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal))
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.BACKWARD_CALLS - bwd0 == 1
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal=causal), (q, k, v), dout)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), rtol=tol,
                                   atol=tol * max(w.float().abs().max().item(), 1e-30))


def test_train_step_on_the_card_matches_cpu(cuda):
    """Reduced llama3.2-3b (fp32): one launcher step (make_step) on the card
    against the same weights and batch on the CPU — loss within 1e-5, every
    gradient within 1e-4 relative norm, each leaf's update within 1e-2
    (the update divides by √v̂: see tests/test_torch_train.py); two kernel
    launches per layer (forward and remat) and one attention backward."""
    from repro_torch.launch import train

    cfg = get_config("llama3.2-3b").reduced()
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 33)),
                           dtype=torch.int32)
    runs = {}
    for dev in ("cpu", cuda):
        model, state = train.build_state(cfg, torch.device(dev), seed=0)
        if dev != "cpu":
            with torch.no_grad():
                for p, q in zip(model.parameters(), runs["cpu"]["start"]):
                    p.copy_(q)
        start = [p.detach().cpu().clone() for p in model.parameters()]
        _, metrics = train.make_step(model, cfg, lambda s: 1e-2)(state, {"tokens": toks.to(dev)})
        runs["cpu" if dev == "cpu" else "cuda"] = dict(
            start=start, metrics=metrics,
            grads=[p.grad.cpu() for p in model.parameters()],
            params=[p.detach().cpu() for p in model.parameters()])
    a, g = runs["cpu"], runs["cuda"]
    assert g["metrics"]["flash_launches"] == 2 * cfg.n_layers
    assert g["metrics"]["attn_backward_calls"] == cfg.n_layers
    np.testing.assert_allclose(g["metrics"]["loss"], a["metrics"]["loss"], rtol=1e-5, atol=1e-5)

    def rel(x, y):
        return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()

    for x, y in zip(g["grads"], a["grads"]):
        assert rel(x, y) <= 1e-4
    for x, y, s in zip(g["params"], a["params"], a["start"]):
        assert rel(x - s, y - s) <= 1e-2


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b", "whisper-tiny",
                                  "rwkv6-7b", "zamba2-7b"])
def test_family_train_step_on_the_card_matches_cpu(cuda, arch):
    """Each family's reduced model (fp32): one ``make_step`` on the card
    against the same weights and batch (whisper's frames, the vlm's
    patches) on the CPU — loss and moe_aux within 1e-5, every gradient
    within 1e-4 relative norm (the SSM families: 1e-4 of the leaf's largest
    element, as tests/test_torch_train_families.py holds them to JAX); the
    flash launches (each rematerialised attention twice, the hybrid's
    shared block once) and attention backward calls of the step."""
    from repro_torch.launch import train

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 71)), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(size=(2, 35, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.normal(size=(2, cfg.vlm_patches, cfg.d_model)),
                                           dtype=torch.float32)
    runs = {}
    for dev in ("cpu", cuda):
        model, state = train.build_state(cfg, torch.device(dev), seed=0)
        if dev != "cpu":
            with torch.no_grad():
                for p, q in zip(model.parameters(), runs["cpu"]["start"]):
                    p.copy_(q)
        start = [p.detach().cpu().clone() for p in model.parameters()]
        _, metrics = train.make_step(model, cfg, lambda s: 1e-2)(
            state, {k: v.to(dev) for k, v in batch.items()})
        runs["cpu" if dev == "cpu" else "cuda"] = dict(
            start=start, metrics=metrics,
            grads={n: p.grad.cpu() for n, p in model.named_parameters()})
    a, g = runs["cpu"], runs["cuda"]
    launches, attentions = lm.attention_calls(cfg)
    assert g["metrics"]["flash_launches"] == launches
    assert g["metrics"]["flash_bodies"]["fma"] == launches
    assert g["metrics"]["attn_backward_calls"] == attentions
    for k in ("loss", "ce", "moe_aux"):
        np.testing.assert_allclose(g["metrics"][k], a["metrics"][k], rtol=1e-5, atol=1e-5)
    for n, y in a["grads"].items():
        x = g["grads"][n]
        if cfg.family in ("ssm", "hybrid"):
            err = ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
        else:
            err = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
        assert err <= 1e-4, (n, err)
        assert y.abs().max() > 0, n


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_two_ranks_on_one_card_serve_the_tokens_of_tp1(cuda, tmp_path, arch):
    """``launch.serve --tp 2`` as two gloo ranks on cuda:0 (reduced llama;
    reduced granite, its experts split; fp32): the tokens of the one-device
    run, every step's logits within 1e-4 of their scale, and each rank's
    prefill launched ``flash_attention`` once per layer."""
    import _tp_ranks
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "16",
            "--gen", "8", "--device", "cuda"]
    info1 = {}
    want = serve.main(argv, info=info1, keep_logits=True)
    results = meshes.spawn(
        _tp_ranks.serve_rank, 2,
        (argv + ["--tp", "2", "--dist-backend", "gloo", "--dist-init", f"file://{tmp_path / 'store'}"],),
        timeout=300)
    cfg = get_config(arch).reduced()
    for gen, info, logits in results:
        np.testing.assert_array_equal(gen, want)
        for got, w in zip(logits, info1["logits"]):
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * scale)
        assert info["prefill_launches"]["flash_attention"] == cfg.n_layers
        assert (info["tp"], info["world"], info["backend"]) == (2, 2, "gloo")


@pytest.mark.parametrize("batched", [False, True])
def test_fp32_product_under_autograd_matches_fp32_gradients(cuda, batched):
    """The card's bf16 product into an fp32 result (``torch.mm(out_dtype=)``,
    which has no derivative) under autograd (``layers._Fp32Product``): the
    forward bit-equal to the bare op, and the bf16 gradients of both
    operands within 1e-2 relative norm of the fp32 product's (the
    backward's two bf16 products round the fp32 gradient once, at 2^-8)."""
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape_a, shape_w = ((4, 96, 160), (4, 160, 72)) if batched else ((2, 48, 160), (160, 72))
    a = torch.randn(shape_a, generator=gen, device="cuda").bfloat16().requires_grad_(True)
    w = torch.randn(shape_w, generator=gen, device="cuda").bfloat16().requires_grad_(True)
    g = torch.randn(shape_a[:-1] + shape_w[-1:], generator=gen, device="cuda")
    y = layers._fp32_product(a, w)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    assert torch.equal(y.detach(), layers._mm_fp32(a.detach(), w.detach()))
    da, dw = torch.autograd.grad(y, (a, w), g)
    a32, w32 = a.detach().float().requires_grad_(True), w.detach().float().requires_grad_(True)
    ra, rw = torch.autograd.grad(torch.matmul(a32, w32), (a32, w32), g)
    for got, want in ((da, ra), (dw, rw)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert ((got.float() - want).norm() / want.norm()).item() <= 1e-2


def test_one_layer_tp_step_at_world1_over_nccl_is_bit_equal(cuda, tmp_path):
    """``launch.train`` at world 1 over NCCL (a group of one rank, ``--tp
    1``) on a one-layer reduced llama: the losses and the parameters after
    three steps bit-equal to the run with no group."""
    import dataclasses

    import _train_ranks
    from repro_torch.launch import mesh as meshes

    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), n_layers=1)
    argv = ["--arch", "llama3.2-3b", "--steps", "3", "--batch", "2", "--seq", "32", "--lr", "1e-2",
            "--device", "cuda"]
    want, params = _train_ranks.train_and_params(argv, cfg)
    ((losses, got),) = meshes.spawn(_train_ranks.card_train_rank, 1,
                                    (str(tmp_path / "store"), argv, cfg), timeout=300)
    assert losses == want
    for n, p in params.items():
        np.testing.assert_array_equal(got[n], p, err_msg=n)
