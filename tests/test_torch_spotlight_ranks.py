"""The port's spotlight instances over an ``instances`` mesh of ranks
against the JAX package's batched path (mirrors the instance half of
``tests/test_spotlight_batched.py::test_multi_device_padding_and_instance_sharding``
and the file-driven hdrf smoke of ``tools/ci.sh``).

Ranks are separate processes (``repro_torch.launch.mesh.spawn``) joined in
a gloo group through a file store (no ports), each spawn with a timeout.
A batch that resolves to ``shard_map`` runs as blocks of instances on the
ranks; every rank returns the whole batch, held bit for bit to ``repro``'s
``backend="vmap"`` run on the same inputs: assignments, ``w_trace`` and
every per-instance stat but the walls, ``scan_calls``, ``h2d_rows`` and
``h2d_bytes`` included; ``backend`` / ``n_shards`` are JAX's resolution
on a host with that many devices (held to JAX in
``tests/test_torch_engine_ranks.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import _graph_ranks
from repro.core import AdwiseConfig as JaxConfig
from repro.core import partition_stream_batched as jax_batched
from repro.core import restream_partition_batched as jax_restream_batched
from repro.core import spotlight_partition as jax_spotlight
from repro.core.baselines import GreedyCore as JaxGreedyCore
from repro.core.baselines import HdrfCore as JaxHdrfCore
from repro.core.restream import two_phase_partition_batched as jax_two_phase_batched
from repro.graph import rmat
from repro_torch.core import AdwiseConfig, partition_file, spotlight_partition
from repro_torch.core.adwise import _ceil_pow2
from repro_torch.core.baselines import GreedyCore, HdrfCore
from repro_torch.core.driver import resolve_backend
from repro_torch.core.spotlight import spread_mask
from repro_torch.graph import EdgeStream
from repro_torch.graph.io import EdgeFileReader, write_edge_file
from repro_torch.launch import mesh as meshes
from repro_torch.launch import partition as launcher

torch.set_num_threads(1)

EDGES, N = rmat(8, 1500, seed=5)
K = 8
KW = dict(k=K, window_max=8, window_init=2)
# z = 4: one length bucket (4 shards at world 4); z = 6: three buckets of
# 3, 2 and 1 instances (a rank past the mesh at world 4, a vmap bucket).
LENGTHS = {4: [200, 230, 250, 180], 6: [40, 300, 35, 290, 120, 60]}
STRATEGIES = ["adwise", "hdrf", "greedy", "2ps-l"]
WALLS = {"wall_time_s", "h2d_wait_s", "prestage_wall_s", "phase1_wall_s", "setup_s",
         "wall_time_serial_s", "trace_summary", "backend", "n_shards"}
CPU = dict(device="cpu")
_RUNS: dict = {}
_JAX: dict = {}


def _batch(z):
    ms = LENGTHS[z]
    streams = np.zeros((z, max(ms), 2), np.int32)
    valid = np.zeros((z, max(ms)), bool)
    start = 0
    for i, m in enumerate(ms):
        streams[i, :m] = EDGES[start:start + m]
        valid[i, :m] = True
        start += m
    allowed = np.stack([spread_mask(K, z, i, 4) for i in range(z)])
    return streams, valid, allowed


def _port_call(strategy, z):
    streams, valid, allowed = _batch(z)
    kw = dict(allowed=allowed, backend="shard_map", **CPU)
    if strategy == "2ps-l":
        return ("repro_torch.core.restream", "two_phase_partition_batched",
                (streams, valid, N, K), dict(kw, variant="2ps-l"))
    core = {"adwise": None, "hdrf": HdrfCore(num_vertices=N, k=K, seed=5),
            "greedy": GreedyCore(num_vertices=N, k=K)}[strategy]
    cfg = AdwiseConfig(**KW) if strategy == "adwise" else None
    return ("repro_torch.core.adwise", "partition_stream_batched",
            (streams, valid, N, cfg), dict(kw, core=core))


def _jax_run(strategy, z):
    if (strategy, z) not in _JAX:
        streams, valid, allowed = _batch(z)
        if strategy == "2ps-l":
            res = jax_two_phase_batched(streams, valid, N, K, variant="2ps-l",
                                        allowed=allowed, backend="vmap")
        else:
            core = {"adwise": None, "hdrf": JaxHdrfCore(num_vertices=N, k=K, seed=5),
                    "greedy": JaxGreedyCore(num_vertices=N, k=K)}[strategy]
            cfg = JaxConfig(**KW) if strategy == "adwise" else None
            res = jax_batched(streams, valid, N, cfg, core=core, allowed=allowed, backend="vmap")
        _JAX[(strategy, z)] = res
    return _JAX[(strategy, z)]


def _ranks_run(world, z, tmp_path_factory):
    """Every strategy at (world, z), in one spawn: per rank, per strategy,
    the z (assign, stats) pairs."""
    if (world, z) not in _RUNS:
        store = tmp_path_factory.mktemp(f"w{world}z{z}") / "store"
        calls = [_port_call(s, z) for s in STRATEGIES]
        _RUNS[(world, z)] = meshes.spawn(_graph_ranks.call_rank, world, (str(store), calls),
                                         timeout=300)
    return _RUNS[(world, z)]


def _same_stats(got: dict, want: dict, what: str):
    keys = (set(want) & set(got)) - WALLS
    assert {"score_rows", "scan_calls", "h2d_rows", "h2d_bytes", "assigned"} <= keys, what
    for key in sorted(keys):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("z", [4, 6])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_batched_over_ranks_equals_jax_vmap(world, z, strategy, tmp_path_factory):
    ranks = _ranks_run(world, z, tmp_path_factory)
    want = _jax_run(strategy, z)
    buckets = {}
    for i, m in enumerate(LENGTHS[z]):
        buckets.setdefault(_ceil_pow2(m), []).append(i)
    bucket_z = {i: len(b) for b in buckets.values() for i in b}
    for r, runs in enumerate(ranks):
        got = runs[STRATEGIES.index(strategy)]
        assert len(got) == z
        for i, ((assign, stats), w) in enumerate(zip(got, want)):
            what = f"rank {r} instance {i}"
            np.testing.assert_array_equal(assign, w.assign, err_msg=what)
            _same_stats(stats, w.stats, what)
            assert (stats["backend"], stats["n_shards"]) == resolve_backend(
                "shard_map", bucket_z[i], world), what
            if r:
                np.testing.assert_array_equal(assign, ranks[0][STRATEGIES.index(strategy)][i][0])
    if world >= 2 and max(bucket_z.values()) >= 2:
        assert any(s["backend"] == "shard_map" for _, s in ranks[0][STRATEGIES.index(strategy)])


def test_spotlight_auto_and_restream_batched_over_ranks(tiny_graph, tmp_path):
    """``spotlight_partition``'s ``auto`` resolves to ``shard_map`` on two
    ranks (as JAX's on several devices) and equals JAX's batched run; one
    restream-batched case (two passes, warm starts and prev tables over the
    ranks' blocks) equals JAX's bit for bit."""
    edges, n = tiny_graph
    streams, valid = EdgeStream(edges[:900], n).split_padded(2)
    allowed = np.stack([spread_mask(K, 2, i, 4) for i in range(2)])
    rcfg = dict(allowed=allowed, passes=2, window_max=8, window_init=2)
    calls = [
        ("repro_torch.core.spotlight", "spotlight_partition", (edges, n, 6),
         dict(z=4, spread=2, cfg=AdwiseConfig(k=6, window_max=8, window_init=2), **CPU)),
        ("repro_torch.core.restream", "restream_partition_batched", (streams, valid, n, K),
         dict(rcfg, backend="shard_map", **CPU)),
    ]
    ranks = meshes.spawn(_graph_ranks.call_rank, 2, (str(tmp_path / "store"), calls), timeout=300)
    spot = jax_spotlight(edges, n, 6, z=4, spread=2, cfg=JaxConfig(k=6, window_max=8, window_init=2))
    rest = jax_restream_batched(streams, valid, n, K, **rcfg)
    for r, (s, rs) in enumerate(ranks):
        assert s[1]["backend"] == "shard_map" and s[1]["n_shards"] == 2, r
        np.testing.assert_array_equal(s[0], spot.assign)
        for key in ("h2d_rows", "h2d_bytes", "score_count", "z", "spread"):
            assert s[1][key] == spot.stats[key], key
        for (assign, stats), w in zip(rs, rest):
            np.testing.assert_array_equal(assign, w.assign)
            _same_stats(stats, w.stats, f"rank {r} restream")
            assert stats["pass_rd"] == w.stats["pass_rd"]



def test_restream_batched_with_a_rank_past_the_mesh(tiny_graph, tmp_path):
    """Restream-batched z = 6 over four ranks: one bucket of six instances
    resolves to three shards, so rank 3 holds no block. Pass 2 reuses the
    stream pass 1 left on the device, and every rank, rank 3 included,
    bills that pass as JAX's resident run does (``h2d_rows`` 0, only the
    prev table in ``h2d_bytes``)."""
    edges, n = tiny_graph
    streams, valid = EdgeStream(edges[:900], n).split_padded(6)
    allowed = np.stack([spread_mask(K, 6, i, 4) for i in range(6)])
    rcfg = dict(allowed=allowed, passes=2, window_max=8, window_init=2)
    calls = [("repro_torch.core.restream", "restream_partition_batched", (streams, valid, n, K),
              dict(rcfg, backend="shard_map", **CPU))]
    ranks = meshes.spawn(_graph_ranks.call_rank, 4, (str(tmp_path / "store"), calls), timeout=300)
    want = jax_restream_batched(streams, valid, n, K, **rcfg)
    for r, (rs,) in enumerate(ranks):
        assert len(rs) == 6, r
        for i, ((assign, stats), w) in enumerate(zip(rs, want)):
            what = f"rank {r} instance {i}"
            np.testing.assert_array_equal(assign, w.assign, err_msg=what)
            _same_stats(stats, w.stats, what)
            assert stats["pass_rd"] == w.stats["pass_rd"], what
            assert (stats["backend"], stats["n_shards"]) == ("shard_map", 3), what


def test_latency_budget_shares_one_cost_over_ranks(tmp_path):
    """On a latency budget the ranks recalibrate from one shared cost (the
    slowest rank's wall over the batch's rows): every rank returns the same
    windows, and every instance of the batch carries the same modeled cost.
    With ``cost_per_score`` pinned the run equals JAX's."""
    streams, valid, allowed = _batch(4)
    cfg = AdwiseConfig(**KW, latency_budget=0.05)
    calls = [
        ("repro_torch.core.adwise", "partition_stream_batched", (streams, valid, N, cfg),
         dict(allowed=allowed, backend="shard_map", n_chunks=4, **CPU)),
        ("repro_torch.core.adwise", "partition_stream_batched", (streams, valid, N, cfg),
         dict(allowed=allowed, backend="shard_map", cost_per_score=2e-7, **CPU)),
    ]
    ranks = meshes.spawn(_graph_ranks.call_rank, 2, (str(tmp_path / "store"), calls), timeout=300)
    want = jax_batched(streams, valid, N, JaxConfig(**KW, latency_budget=0.05), allowed=allowed,
                       backend="vmap", cost_per_score=2e-7)
    for r, (free, pinned) in enumerate(ranks):
        costs = {s["modeled_cost_per_score"] for _, s in free}
        assert len(costs) == 1 and costs.pop() > 0
        assert all(s["n_shards"] == 2 for _, s in free)
        for (a, s), (a0, s0) in zip(free, ranks[0][0]):
            np.testing.assert_array_equal(a, a0)
            np.testing.assert_array_equal(s["w_trace"], s0["w_trace"])
        for (assign, stats), w in zip(pinned, want):
            np.testing.assert_array_equal(assign, w.assign)
            _same_stats(stats, w.stats, f"rank {r} pinned")


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    edges, n = rmat(10, 4000, seed=0)
    path = str(tmp_path_factory.mktemp("graph") / "g.adw")
    write_edge_file(path, edges, n)
    return path, edges, n


def _file_call(path, strategy, spill_dir, **cfg):
    return ("_graph_ranks", "partition_file_rank",
            (path, strategy, 8), dict(z=4, spread=2, seed=0, chunk_edges=1024,
                                      spill_dir=spill_dir, **CPU, **cfg))


@pytest.mark.parametrize("strategy,cfg", [("hdrf", {}),
                                          ("adwise-restream", dict(passes=2, window_max=16))])
def test_partition_file_over_ranks(graph_file, strategy, cfg, tmp_path):
    """``partition_file`` z = 4 over two ranks: each rank runs its two
    instances over its own ring and writes their rows into the one spill;
    both return the whole assignment, equal to the in-memory spotlight
    (the port's and JAX's), with the counters of the one-rank file run.
    The restream case adopts each rank's ring across its passes."""
    path, edges, n = graph_file
    ranks = meshes.spawn(_graph_ranks.call_rank, 2,
                         (str(tmp_path / "store"),
                          [_file_call(path, strategy, str(tmp_path / "spill"), **cfg)]),
                         timeout=300)
    with EdgeFileReader(path) as r:
        one = partition_file(r, strategy, 8, z=4, spread=2, seed=0, chunk_edges=1024,
                             spill_dir=str(tmp_path / "one"), **CPU, **cfg)
        one_assign, one_stats = np.array(one.assign), one.stats
    mem = jax_spotlight(edges, n, 8, z=4, spread=2, seed=0, strategy=strategy,
                        strategy_cfg=cfg or None)
    np.testing.assert_array_equal(one_assign, mem.assign)
    for rank, ((assign, stats),) in enumerate(ranks):
        np.testing.assert_array_equal(assign, mem.assign, err_msg=f"rank {rank}")
        assert stats["spill_path"] == ranks[0][0][1]["spill_path"]
        for key in ("scan_calls", "h2d_rows", "h2d_bytes", "refill_spans", "buffer_rows",
                    "score_count", "pass_rd", "passes_run"):
            if key in one_stats:
                assert stats[key] == one_stats[key], key
        if strategy == "hdrf":
            assert (stats["backend"], stats["n_shards"]) == ("shard_map", 2)


def test_launcher_over_ranks_reports_the_single_process_run(tmp_path):
    """``launch.partition.main`` under two ranks (spotlight z = 4 over the
    ``instances`` mesh, pagerank over the ``parts`` mesh): rank 0 writes the
    JSON of the single-process run, walls and the backend aside; rank 1
    prints nothing."""
    base = ["--graph", "tiny_clustered", "--k", "8", "--z", "4", "--spread", "2",
            "--device", "cpu", "--window-max", "16", "--iters", "10"]
    one = launcher.main(base + ["--json", str(tmp_path / "one.json")])
    argv = base + ["--dist-backend", "gloo", "--dist-init", f"file://{tmp_path / 'store'}",
                   "--json", str(tmp_path / "two.json")]
    ranks = meshes.spawn(_graph_ranks.launcher_rank, 2, (argv,), timeout=300)
    two = json.loads((tmp_path / "two.json").read_text())
    assert ranks[1][1] == "" and "partitioner=adwise" in ranks[0][1]
    walls = {"partition_latency_s", "total_latency_s"}
    for key in set(one) | set(two):
        if key == "stats":
            continue
        if key not in walls:
            assert two[key] == json.loads(json.dumps(one[key])), key
    assert two["stats"]["backend"] == "shard_map" and two["stats"]["n_shards"] == 2
    for key in set(one["stats"]) - WALLS:
        assert two["stats"][key] == one["stats"][key], key
    for out, _ in ranks:
        assert out["replication_degree"] == one["replication_degree"]


def test_launcher_refuses_nccl_on_the_host(monkeypatch):
    """No fallback: NCCL asked for on ``--device cpu`` under a launcher's
    environment raises naming the cause."""
    for var, val in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                     ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(var, val)
    with pytest.raises(ValueError, match="NCCL needs CUDA tensors"):
        launcher.main(["--graph", "tiny_clustered", "--device", "cpu", "--dist-backend", "nccl"])
    assert not torch.distributed.is_initialized()
    assert os.environ["WORLD_SIZE"] == "1"
