"""The port's batched spotlight path against ``repro`` (mirrors
``tests/test_spotlight_batched.py``).

z instance scans as one batched step (``partition_stream_batched``), the
spotlight entry point on top of it, and the restream × spotlight and 2PS ×
spotlight compositions, on the CPU: the port's assignments, ``score_rows``,
``w_trace`` and h2d counters equal ``repro``'s on the same inputs, and the
batched backend equals the loop backend bit for bit. The JAX test file's
multi-device case (instances sharded over four fake CPU devices) has its
counterpart in ``tests/test_torch_spotlight_ranks.py`` (instances over
gloo ranks) and ``tests/test_torch_engine_ranks.py`` (the engine's slabs).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import AdwiseConfig as JaxConfig
from repro.core import partition_stream_batched as jax_batched
from repro.core import restream_partition_batched as jax_restream_batched
from repro.core import spotlight_partition as jax_spotlight
from repro.core.baselines import HdrfCore as JaxHdrfCore
from repro.core.restream import two_phase_partition_batched as jax_two_phase_batched
from repro.core.restream import warm_from_assignment as jax_warm
from repro_torch.core import (
    AdwiseConfig,
    partition_stream,
    partition_stream_batched,
    restream_partition_batched,
    spotlight_partition,
    spread_mask,
    two_phase_partition_batched,
    warm_from_assignment,
)
from repro_torch.core.adwise import _ceil_pow2
from repro_torch.core.baselines import HdrfCore
from repro_torch.graph import EdgeStream, replica_sets_from_assignment, replication_degree

torch.set_num_threads(1)

N, M = 24, 60  # the adversarial-stream shapes of test_spotlight_batched.py
CPU = dict(device="cpu")
_SAME = ("score_rows", "final_w", "assigned", "scan_calls", "h2d_rows", "h2d_bytes",
         "buffer_rows", "unassigned")


def _adversarial_stream(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        uv = rng.integers(0, N, (M, 2))
    elif kind == "self_loops":
        u = rng.integers(0, N, M)
        v = np.where(rng.random(M) < 0.5, u, rng.integers(0, N, M))
        uv = np.stack([u, v], axis=1)
    elif kind == "duplicates":
        base = rng.integers(0, N, (4, 2))
        uv = base[rng.integers(0, 4, M)]
    else:  # star
        center = int(rng.integers(0, N))
        uv = np.stack([np.full(M, center), rng.integers(0, N, M)], axis=1)
    return uv.astype(np.int32)


def _random_edges(seed, n=50, m=300):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], axis=1).astype(np.int32)


def _same_as_jax(got, want, keys=_SAME):
    """Per-instance results: assignments, w_trace and the counters equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.assign, w.assign)
        if "w_trace" in w.stats:
            np.testing.assert_array_equal(g.stats["w_trace"], w.stats["w_trace"])
        for key in keys:
            if key in w.stats:
                assert g.stats[key] == w.stats[key], key


# ----------------------------------------------------------------------------
# z = 1 parity: the batched step at z = 1 is partition_stream's step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "warm", "allowed"])
def test_batched_z1_bit_identical_to_partition_stream_and_jax(case):
    edges = _random_edges({"plain": 0, "warm": 3, "allowed": 7}[case])
    n, k = 50, 8
    kw = dict(k=k, window_max=16, window_init=4)
    cfg, jcfg = AdwiseConfig(**kw), JaxConfig(**kw)
    extra, jextra = {}, {}
    if case == "warm":
        base = partition_stream(edges, n, cfg, **CPU)
        warm = warm_from_assignment(edges, base.assign, n, k)
        extra, jextra = dict(warm=warm), dict(warm=jax_warm(edges, base.assign, n, k))
    elif case == "allowed":
        allowed = spread_mask(k, 2, 0, 4)
        extra = jextra = dict(allowed=allowed)
    ref = partition_stream(edges, n, cfg, **extra, **CPU)
    streams, valid = EdgeStream(edges, n).split_padded(1)
    bkw = {key: ([v] if key == "warm" else v[None]) for key, v in extra.items()}
    jbkw = {key: ([v] if key == "warm" else v[None]) for key, v in jextra.items()}
    got = partition_stream_batched(streams, valid, n, cfg, **bkw, **CPU)
    want = jax_batched(streams, valid, n, jcfg, **jbkw)
    np.testing.assert_array_equal(ref.assign, got[0].assign)
    np.testing.assert_array_equal(ref.stats["w_trace"], got[0].stats["w_trace"])
    for key in ("score_rows", "final_w", "h2d_rows", "h2d_bytes"):
        assert ref.stats[key] == got[0].stats[key], key
    _same_as_jax(got, want)
    assert got[0].stats["backend"] == want[0].stats["backend"] == "vmap"
    assert got[0].stats["n_shards"] == want[0].stats["n_shards"] == 0


@pytest.mark.parametrize("m", [400, 250])  # z | m and z ∤ m
def test_spotlight_batched_matches_loop_and_jax(m):
    edges = _random_edges(1, m=m)
    n, k, z = 50, 8, 4
    kw = dict(k=k, window_max=16, window_init=4)
    loop = spotlight_partition(edges, n, k, z=z, spread=2, cfg=AdwiseConfig(**kw),
                               backend="loop", **CPU)
    batched = spotlight_partition(edges, n, k, z=z, spread=2, cfg=AdwiseConfig(**kw),
                                  backend="batched", **CPU)
    want = jax_spotlight(edges, n, k, z=z, spread=2, cfg=JaxConfig(**kw), backend="batched")
    np.testing.assert_array_equal(loop.assign, batched.assign)
    np.testing.assert_array_equal(batched.assign, want.assign)
    assert batched.stats["backend"] == "vmap" and loop.stats["backend"] == "loop"
    for key in ("h2d_rows", "h2d_bytes", "score_count", "n_shards", "z", "spread"):
        assert batched.stats[key] == want.stats[key], key


def test_batched_equals_jax_per_instance_stats():
    edges = _random_edges(11, m=333)
    n, k, z = 50, 8, 3
    streams, valid = EdgeStream(edges, n).split_padded(z)
    allowed = np.stack([spread_mask(k, z, i, 4) for i in range(z)])
    kw = dict(k=k, window_max=16, window_init=4, assign_batch=2)
    got = partition_stream_batched(streams, valid, n, AdwiseConfig(**kw), allowed=allowed, **CPU)
    want = jax_batched(streams, valid, n, JaxConfig(**kw), allowed=allowed)
    _same_as_jax(got, want)
    for g, w in zip(got, want):
        for key in ("z", "instance", "n_buckets", "bucket_rows", "batched", "lam_final"):
            assert g.stats[key] == w.stats[key], key


def test_length_bucketed_batch_bit_identical_to_per_instance():
    """Skewed lengths split the batch into four pow2 length buckets; every
    instance reproduces its stand-alone scan, for ADWISE and for HDRF, whose
    tie seeds key on the global instance id."""
    rng = np.random.default_rng(9)
    ms = [30, 70, 150, 290]
    z, per, n, k = len(ms), max(ms), 50, 8
    streams = np.zeros((z, per, 2), np.int32)
    valid = np.zeros((z, per), bool)
    for i, m in enumerate(ms):
        streams[i, :m] = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], axis=1)
        valid[i, :m] = True
    assert len({_ceil_pow2(m) for m in ms}) == 4

    kw = dict(k=k, window_max=8, window_init=2)
    got = partition_stream_batched(streams, valid, n, AdwiseConfig(**kw), **CPU)
    assert got[0].stats["n_buckets"] == 4
    for i, m in enumerate(ms):
        ref = partition_stream(streams[i, :m], n, AdwiseConfig(**kw), **CPU)
        np.testing.assert_array_equal(ref.assign, got[i].assign)
    _same_as_jax(got, jax_batched(streams, valid, n, JaxConfig(**kw)))

    seed = 5
    got_h = partition_stream_batched(
        streams, valid, n, None, core=HdrfCore(num_vertices=n, k=k, seed=seed), **CPU)
    for i, m in enumerate(ms):
        ref_h = partition_stream_batched(
            streams[i:i + 1, :m], valid[i:i + 1, :m], n, None,
            core=HdrfCore(num_vertices=n, k=k, seed=seed + i), **CPU)
        np.testing.assert_array_equal(ref_h[0].assign, got_h[i].assign)
    want_h = jax_batched(streams, valid, n, None,
                         core=JaxHdrfCore(num_vertices=n, k=k, seed=seed))
    _same_as_jax(got_h, want_h)


# ----------------------------------------------------------------------------
# Spread-mask property on adversarial streams
# ----------------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    kind=st.sampled_from(["random", "self_loops", "duplicates", "star"]),
    z=st.sampled_from([2, 4]),
    spread=st.sampled_from([2, 4]),
)
def test_batched_spotlight_respects_spread_property(seed, kind, z, spread):
    edges = _adversarial_stream(kind, seed)
    k = 8
    res = spotlight_partition(edges, N, k, z=z, spread=spread,
                              cfg=AdwiseConfig(k=k, window_max=8, window_init=2),
                              backend="batched", **CPU)
    assert (res.assign >= 0).all() and (res.assign < k).all()
    per = -(-len(edges) // z)
    for i in range(z):
        allowed = set(np.flatnonzero(spread_mask(k, z, i, spread)))
        seg = res.assign[i * per : min((i + 1) * per, len(edges))]
        assert set(np.unique(seg)) <= allowed, (kind, i)


def test_batched_more_instances_than_edges():
    edges = np.array([[0, 1], [1, 2]], np.int32)
    res = spotlight_partition(edges, 4, 8, z=4, spread=2,
                              cfg=AdwiseConfig(k=8, window_max=4), backend="batched", **CPU)
    want = jax_spotlight(edges, 4, 8, z=4, spread=2, cfg=JaxConfig(k=8, window_max=4),
                         backend="batched")
    assert res.assign.shape == (2,) and (res.assign >= 0).all()
    np.testing.assert_array_equal(res.assign, want.assign)


# ----------------------------------------------------------------------------
# restream × spotlight and 2PS × spotlight
# ----------------------------------------------------------------------------

def test_restream_batched_composes_with_spread(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:400]
    k, z, spread = 8, 2, 4
    scfg = dict(passes=2, window_max=8, window_init=2)
    res = spotlight_partition(edges, n, k, z=z, spread=spread, strategy="adwise-restream",
                              strategy_cfg=scfg, backend="batched", **CPU)
    want = jax_spotlight(edges, n, k, z=z, spread=spread, strategy="adwise-restream",
                         strategy_cfg=scfg, backend="batched")
    np.testing.assert_array_equal(res.assign, want.assign)
    assert res.stats["passes_run"] == 2 and res.stats["stream_reads"] == 2
    for key in ("h2d_rows", "h2d_bytes", "score_count"):
        assert res.stats[key] == want.stats[key], key
    per = -(-len(edges) // z)
    for i in range(z):
        allowed = set(np.flatnonzero(spread_mask(k, z, i, spread)))
        assert set(np.unique(res.assign[i * per : min((i + 1) * per, len(edges))])) <= allowed


def test_restream_batched_quality_monotone_per_instance(tiny_graph):
    edges, n = tiny_graph
    k, z = 8, 2
    streams, valid = EdgeStream(edges[:1200], n).split_padded(z)
    allowed = np.stack([spread_mask(k, z, i, 4) for i in range(z)])
    cfg = dict(window_max=8, window_init=2)
    one = restream_partition_batched(streams, valid, n, k, allowed=allowed, passes=1,
                                     **cfg, **CPU)
    two = restream_partition_batched(streams, valid, n, k, allowed=allowed, passes=2,
                                     **cfg, **CPU)
    want = jax_restream_batched(streams, valid, n, k, allowed=allowed, passes=2, **cfg)
    for i in range(z):
        sub = streams[i, : int(valid[i].sum())]
        rd1 = replication_degree(replica_sets_from_assignment(sub, one[i].assign, n, k))
        rd2 = replication_degree(replica_sets_from_assignment(sub, two[i].assign, n, k))
        assert rd2 <= rd1 + 1e-9
        assert two[i].stats["passes_run"] == 2
        for key in ("pass_rd", "pass_score_rows", "best_pass", "h2d_rows", "h2d_bytes"):
            assert two[i].stats[key] == want[i].stats[key], key
    _same_as_jax(two, want)


def test_restream_batched_eps_early_stop(tiny_graph):
    edges, n = tiny_graph
    streams, valid = EdgeStream(edges[:300], n).split_padded(2)
    res = restream_partition_batched(streams, valid, n, 8, passes=5, eps=10.0,
                                     window_max=8, window_init=2, **CPU)
    assert res[0].stats["passes_run"] == 2
    assert res[0].stats["passes"] == 5 and res[0].stats["stream_reads"] == 2


@pytest.mark.parametrize("variant", ["2ps", "2ps-l"])
def test_two_phase_batched_equals_sequential_and_jax(tiny_graph, variant):
    edges, n = tiny_graph
    edges = edges[:700]
    k, z = 8, 3
    streams, valid = EdgeStream(edges, n).split_padded(z)
    allowed = np.stack([spread_mask(k, z, i, 4) for i in range(z)])
    cfg = dict(window_max=8, window_init=2) if variant == "2ps" else {}
    got = two_phase_partition_batched(streams, valid, n, k, variant=variant, allowed=allowed,
                                      **cfg, **CPU)
    want = jax_two_phase_batched(streams, valid, n, k, variant=variant, allowed=allowed, **cfg)
    _same_as_jax(got, want)
    for g, w in zip(got, want):
        assert g.stats["n_clusters"] == w.stats["n_clusters"]
    loop = spotlight_partition(edges, n, k, z=z, spread=4, strategy=variant,
                               strategy_cfg=cfg or None, backend="loop", **CPU)
    np.testing.assert_array_equal(
        np.concatenate([r.assign for r in got]), loop.assign)


# ----------------------------------------------------------------------------
# Backend validation
# ----------------------------------------------------------------------------

def test_batched_backend_rejects_custom_partitioner(tiny_graph):
    edges, n = tiny_graph

    def custom(sub_edges, nv, k, allowed, seed):
        from repro_torch.core.registry import run_partitioner
        return run_partitioner("hash", sub_edges, nv, k, seed=seed, allowed=allowed, **CPU)

    with pytest.raises(ValueError, match="loop"):
        spotlight_partition(edges, n, 8, z=2, spread=4, partitioner=custom,
                            backend="batched", **CPU)
    res = spotlight_partition(edges, n, 8, z=2, spread=4, partitioner=custom, **CPU)
    assert res.stats["backend"] == "loop" and (res.assign >= 0).all()


def test_unknown_backend_rejected(tiny_graph):
    edges, n = tiny_graph
    with pytest.raises(ValueError, match="backend"):
        spotlight_partition(edges, n, 8, z=2, spread=4, backend="tpu", **CPU)
    streams, valid = EdgeStream(edges[:40], n).split_padded(2)
    with pytest.raises(ValueError, match="backend"):
        partition_stream_batched(streams, valid, n, AdwiseConfig(k=8), backend="tpu", **CPU)
    for backend in ("vmap", "shard_map"):
        res = spotlight_partition(edges[:200], n, 8, z=2, spread=4, backend=backend,
                                  cfg=AdwiseConfig(k=8, window_max=8), **CPU)
        assert res.stats["backend"] == "vmap" and res.stats["n_shards"] == 0


def test_spotlight_rejects_grid_and_bad_spread(tiny_graph):
    edges, n = tiny_graph
    with pytest.raises(ValueError, match="spread"):
        spotlight_partition(edges, n, 8, z=2, spread=4, strategy="grid", **CPU)
    with pytest.raises(ValueError, match="spread"):
        spread_mask(8, 2, 0, 9)


@pytest.mark.parametrize("strategy", ["dbh", "hash", "hdrf", "greedy"])
def test_baselines_auto_select_batched(tiny_graph, strategy):
    """auto resolves to the batched backend for every registry strategy —
    the baselines included — and matches the loop backend and ``repro``."""
    edges, n = tiny_graph
    edges = edges[:900]
    res = spotlight_partition(edges, n, 16, z=4, spread=4, strategy=strategy, seed=2, **CPU)
    assert res.stats["backend"] != "loop"
    loop = spotlight_partition(edges, n, 16, z=4, spread=4, strategy=strategy, seed=2,
                               backend="loop", **CPU)
    want = jax_spotlight(edges, n, 16, z=4, spread=4, strategy=strategy, seed=2)
    np.testing.assert_array_equal(res.assign, loop.assign)
    np.testing.assert_array_equal(res.assign, want.assign)
