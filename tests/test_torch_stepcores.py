"""The port's single-edge step-cores against their oracles and the JAX package.

HDRF, Greedy and 2PS-L (its clustering phase included) run as in-place
step-cores on the port's scan driver. Over the adversarial streams of
``tests/test_stepcores.py`` (self-loops, duplicates, a hub star, the empty
stream, m = 3) and random ones, with and without an ``allowed`` mask:
the torch scan == the port's numpy oracle (``scan=False``) == ``repro``'s,
bit for bit; against ``repro``'s own scan also ``score_rows`` and the
driver's transfer counters. Integer arithmetic throughout, so no tolerance.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import registry as jreg
from repro.core import restream as jax_restream
from repro.core.spotlight import spotlight_partition as jax_spotlight
from repro.core.types import AdwiseConfig as JaxConfig
from repro_torch.core import AdwiseConfig, baselines, registry, restream, spotlight_partition

torch.set_num_threads(1)

N, K = 16, 8
ALLOWED = np.array([True, False, True, True, False, False, True, True])


def _streams():
    rng = np.random.default_rng(0)
    base = rng.integers(0, N, size=(48, 2)).astype(np.int32)
    mixed = base.copy()
    mixed[::3, 1] = mixed[::3, 0]  # self-loops
    mixed[24:36] = mixed[:12]  # duplicate edges
    star = np.stack([np.zeros(40, np.int32), rng.integers(0, N, size=40).astype(np.int32)], 1)
    # Two clusters of equal volume joined by an edge: the local move's tie
    # (the endpoint in the lighter-or-equal cluster moves).
    ties = np.array([[0, 1], [2, 3], [0, 2], [4, 5], [6, 7], [5, 7], [8, 9], [9, 8]], np.int32)
    out = dict(mixed=mixed, star=star, empty=np.zeros((0, 2), np.int32), tiny=base[:3],
               ties=ties)
    for seed in range(2):
        r = np.random.default_rng(100 + seed)
        out[f"rand{seed}"] = r.integers(0, N, size=(int(r.integers(5, 120)), 2)).astype(np.int32)
    return out


STREAMS = _streams()

CASES = [
    ("hdrf", dict(seed=2)),
    ("hdrf", dict(seed=5, lam=1.5)),
    ("greedy", dict(seed=2)),
    ("2ps-l", dict(seed=2)),
    ("2ps-l", dict(seed=2, lam=1.5, cap_slack=1.3)),
]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "allowed"])
@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_scan_equals_oracles_and_jax(name, cfg, masked):
    kw = dict(cfg, allowed=ALLOWED) if masked else cfg
    for sname, edges in STREAMS.items():
        scan = registry.run_partitioner(name, edges, N, K, device="cpu", **kw)
        oracle = registry.run_partitioner(name, edges, N, K, device="cpu", scan=False, **kw)
        want = jreg.run_partitioner(name, edges, N, K, scan=False, **kw)
        assert scan.assign.dtype == np.int32, (name, sname)
        np.testing.assert_array_equal(oracle.assign, want.assign, err_msg=f"{name} {sname}")
        np.testing.assert_array_equal(scan.assign, want.assign, err_msg=f"{name} {sname}")
        if masked and len(edges):
            assert set(np.unique(scan.assign)) <= set(np.flatnonzero(ALLOWED))


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_scan_stats_equal_jax_scan(name, cfg):
    edges = STREAMS["mixed"]
    got = registry.run_partitioner(name, edges, N, K, device="cpu", **cfg)
    want = jreg.run_partitioner(name, edges, N, K, **cfg)
    np.testing.assert_array_equal(got.assign, want.assign)
    for key in ("score_rows", "score_count", "assigned", "scan_calls", "scan_steps_per_call",
                "h2d_rows", "h2d_bytes", "buffer_rows", "warm", "final_w", "lam_final",
                "name", "k", "unassigned"):
        assert got.stats[key] == want.stats[key], key
    if name == "2ps-l":
        for key in ("n_clusters", "stream_reads", "cluster_slack"):
            assert got.stats[key] == want.stats[key], key


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF])
def test_tie_hash_equals_jax_at_the_extremes(seed):
    rows = np.array([0, 1, 2, 1023, 65535, 2**24 + 7, 2**30, 2**31 - 2, 2**31 - 1], np.int64)
    rows = np.concatenate([rows, np.random.default_rng(seed % 97).integers(0, 2**31, 64)])
    for k in (1, 8, 32, 33):
        want = jax_baselines.tie_break_hash(rows, k, seed)
        got = baselines.tie_hash_torch(torch.as_tensor(rows, dtype=torch.int32),
                                       baselines._tie_terms(k, seed, "cpu"))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slack", [1.25, 0.3, 4.0])
@pytest.mark.parametrize("sname", ["mixed", "star", "tiny", "ties", "rand0", "rand1"])
def test_clustering_equals_numpy_oracle_and_jax(sname, slack):
    edges = STREAMS[sname]
    got = restream.streaming_vertex_clustering(edges, N, K, cluster_slack=slack, device="cpu")
    oracle = restream.streaming_vertex_clustering_np(edges, N, K, cluster_slack=slack)
    want = jax_restream.streaming_vertex_clustering(edges, N, K, cluster_slack=slack)
    for a, b, c in zip(got, oracle, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_clustering_resumes_across_chunks():
    edges = STREAMS["rand1"]
    deg = restream._degrees(edges, N)
    whole = restream.streaming_vertex_clustering(edges, N, K, device="cpu")
    state = restream.VertexClusteringState(N, K, len(edges), deg, chunk_edges=29, device="cpu")
    for i in range(0, len(edges), 29):
        state.update(edges[i:i + 29])
    for a, b in zip(state.finalize(), whole):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="chunk_edges=29"):
        state.update(edges[:30])


@pytest.mark.parametrize("name", ["hdrf", "greedy"])
def test_warm_started_cores_equal_jax(name):
    # warm_carry: the replica table, degrees and loads of a previous pass.
    from repro.core.restream import warm_from_assignment as jax_warm

    edges = STREAMS["mixed"]
    first = jreg.run_partitioner(name, edges, N, K, scan=False)
    warm = jax_warm(edges, first.assign, N, K)._replace(prev_assign=None)
    if name == "hdrf":
        core = baselines.HdrfCore(num_vertices=N, k=K, lam=1.5, seed=9)
        jcore = jax_baselines.HdrfCore(num_vertices=N, k=K, lam=1.5, seed=9)
    else:
        core = baselines.GreedyCore(num_vertices=N, k=K)
        jcore = jax_baselines.GreedyCore(num_vertices=N, k=K)
    got = baselines._scan_partition(core, edges, warm=warm, device="cpu")
    want = jax_baselines._scan_partition(jcore, edges, warm=warm)
    np.testing.assert_array_equal(got.assign, want.assign)
    for key in ("warm", "h2d_rows", "h2d_bytes", "score_rows"):
        assert got.stats[key] == want.stats[key], key


def test_tpsl_core_refuses_a_cold_start():
    core = restream.TpslCore(num_vertices=N, k=K)
    with pytest.raises(ValueError, match="WarmState"):
        core.init_carry(0.0, torch.device("cpu"))


def test_scan_rejects_an_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        registry.run_partitioner("hdrf", STREAMS["mixed"], N, K, device="cpu", backend="gpu")


# Spotlight z = 4 over the same adversarial streams (the empty stream and
# m = 3 < z leave instances without edges): every registry strategy but
# grid, batched == loop == repro's batched path (tests/test_stepcores.py).
Z, SPREAD = 4, 2
_SMALL = dict(window_max=8, window_init=2)
SPOT_STRATEGIES = [
    ("hash", {}), ("dbh", {}), ("hdrf", {}), ("hdrf", dict(lam=1.5)), ("greedy", {}),
    ("adwise", dict(_SMALL)), ("adwise-restream", dict(_SMALL, passes=2)), ("2ps", dict(_SMALL)),
    ("2ps-l", {}), ("2ps-l", dict(lam=1.5, cap_slack=1.3)),
]


def _spot(fn, config, edges, strategy, cfg, backend, **kw):
    if strategy == "adwise":
        return fn(edges, N, K, z=Z, spread=SPREAD, seed=1, strategy="adwise",
                  cfg=config(k=K, **cfg), backend=backend, **kw)
    return fn(edges, N, K, z=Z, spread=SPREAD, seed=1, strategy=strategy,
              strategy_cfg=cfg or None, backend=backend, **kw)


@pytest.mark.parametrize("strategy,cfg", SPOT_STRATEGIES,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(SPOT_STRATEGIES)])
def test_spotlight_batched_equals_loop_adversarial(strategy, cfg):
    for sname in ("mixed", "star", "empty", "tiny"):
        edges = STREAMS[sname]
        batched = _spot(spotlight_partition, AdwiseConfig, edges, strategy, cfg, "batched",
                        device="cpu")
        loop = _spot(spotlight_partition, AdwiseConfig, edges, strategy, cfg, "loop",
                     device="cpu")
        want = _spot(jax_spotlight, JaxConfig, edges, strategy, cfg, "batched")
        np.testing.assert_array_equal(batched.assign, loop.assign, err_msg=f"{strategy} {sname}")
        np.testing.assert_array_equal(batched.assign, want.assign, err_msg=f"{strategy} {sname}")
        assert batched.stats["backend"] != "loop"
