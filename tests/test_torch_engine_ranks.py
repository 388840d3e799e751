"""The port's engine over a ``parts`` mesh of ranks against the JAX
package's engine (mirrors the engine half of
``tests/test_spotlight_batched.py::test_multi_device_padding_and_instance_sharding``
and the slab-placement smoke of ``tools/ci.sh``).

Ranks are separate processes (``repro_torch.launch.mesh.spawn``) joined in
a gloo group through a file store under ``tmp_path`` (no ports), each spawn
with a timeout. Each rank gathers its slab of partitions and the slabs are
combined by one all-reduce per superstep; the results are held to
``repro.engine``'s single-device results on the same ``repro.graph`` graph
and ``repro`` assignment (pagerank at rtol 1e-5, the ``min`` workloads and
the triangle count exactly), and every rank's result to rank 0's bit for
bit. The placement (mesh sizes, ``slab_occupancy``) and
``resolve_backend`` are held to what the JAX package reports on a host
forced to N CPU devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _graph_ranks
from repro import engine as jeng
from repro.core import run_partitioner as jax_run_partitioner
from repro.graph import rmat
from repro_torch import engine
from repro_torch.core.driver import resolve_backend
from repro_torch.engine.gas import engine_mesh_size, gather, slab_placement, slab_range
from repro_torch.dist import RankMesh
from repro_torch.launch import mesh as meshes

torch.set_num_threads(1)

EDGES, N = rmat(8, 1200, seed=3)
ITERS = 20
_JAX: dict = {}


def _assign(k):
    return np.asarray(jax_run_partitioner("hash", EDGES, N, k).assign, np.int32)


def _jax_results(k):
    """repro.engine's four workloads on one device, once per k."""
    if k not in _JAX:
        g = jeng.build_partitioned_graph(EDGES, _assign(k), N, k)
        _JAX[k] = dict(
            pagerank=jeng.pagerank(g, iters=ITERS),
            label_propagation=jeng.label_propagation(g),
            coloring=jeng.coloring(g),
            triangles=jeng.triangle_count(g, sketch_bits=max(256, N)),
        )
    return _JAX[k]


@pytest.mark.parametrize("world,k", [(2, 2), (2, 7), (2, 32), (3, 2), (3, 6), (4, 7), (4, 32), (4, 2)])
def test_engine_over_ranks_matches_jax(world, k, tmp_path):
    ranks = meshes.spawn(_graph_ranks.engine_rank, world,
                         (EDGES, _assign(k), N, k, str(tmp_path / "store")), timeout=240)
    want = _jax_results(k)
    size = min(world, k)
    _, occupancy = slab_placement(k, size)
    # Each rank's device holds its slab's edges and messages only; the
    # slabs hold every message once.
    assert sum(got["held_msgs"] for got in ranks) == 2 * len(EDGES)
    for r, got in enumerate(ranks):
        assert got["size"] == size and got["coord"] == (r if r < size else None)
        assert got["occupancy"] == occupancy
        lo = sum(occupancy[:r]) if r < size else k
        hi = lo + occupancy[r] if r < size else k
        assert got["held"] == (lo, hi) and got["held_shape"][0] == hi - lo
        # One all-reduce of the (V, 1) accumulator per superstep.
        assert got["pagerank_collectives"] == {"all_reduce_sum": [ITERS, ITERS * N * 4]}
        np.testing.assert_allclose(got["pagerank"], want["pagerank"][0], rtol=1e-5, atol=1e-8)
        assert got["pagerank_info"] == want["pagerank"][1]
        np.testing.assert_array_equal(got["label_propagation"], want["label_propagation"][0])
        assert got["label_propagation_info"] == want["label_propagation"][1]
        np.testing.assert_array_equal(got["coloring"], want["coloring"][0])
        assert got["coloring_info"] == want["coloring"][1]
        assert got["triangles"] == want["triangles"][0]
        assert got["triangles_info"] == want["triangles"][1]
        # Every rank holds the same state: the convergence tests agree.
        for key in ("pagerank", "label_propagation", "coloring"):
            np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=f"rank {r} {key}")


def test_engine_mesh_capped_by_n_devices(tmp_path):
    """``engine_mesh(n_devices=1)`` on two ranks: rank 0 gathers every
    partition, rank 1 none, and both end with the single-rank result."""
    k = 6
    ranks = meshes.spawn(_graph_ranks.engine_rank, 2,
                         (EDGES, _assign(k), N, k, str(tmp_path / "store"), "cpu", ITERS, 1),
                         timeout=240)
    g = engine.build_partitioned_graph(EDGES, _assign(k), N, k, device="cpu")
    pr, _ = engine.pagerank(g, iters=ITERS)
    assert [r["coord"] for r in ranks] == [0, None]
    for got in ranks:
        assert got["size"] == 1 and got["occupancy"] == (k,)
        np.testing.assert_array_equal(got["pagerank"], pr)


@pytest.mark.parametrize("k", [1, 2, 6, 7, 32])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_slabs_tile_the_gather(k, n_shards):
    """The ranks' slabs of ``slab_placement`` hold every message once, and
    their accumulators combine to the one-rank gather: sums to fp32
    rounding, minima exactly."""
    assign = np.arange(len(EDGES), dtype=np.int32) % k
    g = engine.build_partitioned_graph(EDGES, assign, N, k, device="cpu")
    perm, occ = slab_placement(k, n_shards)
    kp = len(perm) // n_shards
    bounds = np.concatenate([[0], np.cumsum(occ)])
    state = torch.rand((N, 3), generator=torch.Generator().manual_seed(k))
    fwd = lambda a, b, c, d: (a, b)  # noqa: E731
    add, low, msgs = 0, None, 0
    for d in range(n_shards):
        block = perm[d * kp:(d + 1) * kp]
        real = np.sort(block[block < k])
        np.testing.assert_array_equal(real, np.arange(bounds[d], bounds[d + 1]))
        slab = g.slab(int(bounds[d]), int(bounds[d + 1]))
        msgs += len(slab.msg_src)
        add = add + gather(g, state, fwd, "add", slab)
        m = gather(g, state, fwd, "min", slab)
        low = m if low is None else torch.minimum(low, m)
    assert msgs == 2 * len(EDGES)
    np.testing.assert_allclose(add.numpy(), gather(g, state, fwd, "add").numpy(), rtol=1e-6)
    np.testing.assert_array_equal(low.numpy(), gather(g, state, fwd, "min").numpy())



@pytest.mark.parametrize("k,n_shards", [(6, 2), (7, 3), (2, 4)])
def test_a_rank_holds_only_its_slab(k, n_shards):
    """A graph built for a rank of an n-rank ``parts`` mesh keeps that
    rank's slab on its device: its partitions' edges and their messages,
    equal to the whole graph's slab, beside the whole replica table and
    degrees; a slab it does not hold is refused. (Meshes made by hand: a
    graph's build issues no collective.)"""
    assign = np.arange(len(EDGES), dtype=np.int32) % k
    whole = engine.build_partitioned_graph(EDGES, assign, N, k, device="cpu")
    size = min(n_shards, k)
    for coord in [*range(size), None][: n_shards]:
        mesh = RankMesh("parts", size, coord, n_shards)
        g = engine.build_partitioned_graph(EDGES, assign, N, k, device="cpu", mesh=mesh)
        lo, hi = slab_range(k, mesh)
        assert g.parts == (lo, hi) and g.edges.shape[0] == hi - lo
        want = whole.slab(lo, hi)
        assert torch.equal(g.msg_src, want.msg_src)
        assert torch.equal(g.msg_layout.seg_ids, want.msg_layout.seg_ids)
        assert torch.equal(g.replicas, whole.replicas) and torch.equal(g.degrees, whole.degrees)
        np.testing.assert_array_equal(g.edges_per_partition, whole.edges_per_partition)
        if (lo, hi) != (0, k):
            with pytest.raises(ValueError, match="not within the held"):
                g.slab(0, k)


_PLACEMENT_PROG = textwrap.dedent("""
    import json
    import numpy as np, jax
    from repro.core.driver import resolve_backend
    from repro.engine import build_partitioned_graph
    from repro.engine.gas import engine_mesh, make_superstep
    nd = jax.device_count()
    edges = np.stack([np.arange(64) % 16, (np.arange(64) * 7 + 1) % 16], 1).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    out = dict(devices=nd, mesh={}, capped={}, occupancy={}, resolve={})
    for k in KS:
        out["mesh"][k] = int(engine_mesh(k=k).devices.size)
        out["capped"][k] = int(engine_mesh(n_devices=2, k=k).devices.size)
        g = build_partitioned_graph(edges, np.arange(len(edges)) % k, 16, k)
        step = make_superstep(g, lambda a, b, c, d: (a, b), lambda s, a, d: s, engine_mesh(k=k))
        out["occupancy"][k] = list(step.slab_occupancy)
    for b in ("auto", "vmap", "shard_map"):
        for z in ZS:
            out["resolve"][f"{b},{z}"] = list(resolve_backend(b, z))
    print("PLACEMENT " + json.dumps(out))
""")
_KS = [1, 2, 3, 4, 6, 7, 32]
_ZS = [1, 2, 3, 4, 5, 6, 7, 8, 12]


def test_placement_and_backend_resolution_equal_jax_on_forced_devices():
    """One JAX subprocess per N in (2, 3, 4) under
    ``--xla_force_host_platform_device_count=N`` (run together) records
    ``engine_mesh`` sizes (also capped at two devices), ``slab_occupancy``
    and ``resolve_backend``; the port's pure functions, at a world of N,
    give the same."""
    prog = _PLACEMENT_PROG.replace("KS", repr(_KS)).replace("ZS", repr(_ZS))
    procs = {}
    for n in (2, 3, 4):
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
                   JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [os.path.abspath("src"), env.get("PYTHONPATH")] if p)
        procs[n] = subprocess.Popen([sys.executable, "-c", prog], env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    for n, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        line = next(ln for ln in out.splitlines() if ln.startswith("PLACEMENT "))
        got = json.loads(line[len("PLACEMENT "):])
        assert got["devices"] == n
        for k in _KS:
            assert engine_mesh_size(n, None, k) == got["mesh"][str(k)], (n, k)
            assert engine_mesh_size(n, 2, k) == got["capped"][str(k)], (n, k)
            assert list(slab_placement(k, engine_mesh_size(n, None, k))[1]) == got["occupancy"][str(k)]
        for key, want in got["resolve"].items():
            b, z = key.split(",")
            assert list(resolve_backend(b, int(z), world=n)) == want, (n, key)


def test_no_process_group_is_one_rank():
    """Without a process group the meshes have one rank, the world is 1,
    and a collective returns its input untouched (the parent's path)."""
    assert meshes.world_size() == 1 and meshes.rank() == 0
    mesh = engine.engine_mesh(k=7)
    assert (mesh.size, mesh.coord, mesh.world, mesh.axis_names) == (1, 0, 1, ("parts",))
    x = torch.arange(4.0)
    assert mesh.all_reduce(x, "sum") is x and mesh.stats == {}
    assert mesh.any(True) and not mesh.any(False)
    assert resolve_backend("auto", 8) == ("vmap", 0)
    assert resolve_backend("shard_map", 8) == ("vmap", 0)
    with pytest.raises(ValueError, match="backend must be"):
        resolve_backend("pmap", 8)
