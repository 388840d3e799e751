"""Re-streaming in the port (``repro_torch.core.restream``) against the JAX
package's ``repro.core.restream``.

Mirrors ``tests/test_restream.py`` case by case, each held against ``repro``
on the same inputs: assignments bit-identical, ``score_rows`` and the per-pass
trajectories equal. Also the driver's transfer counters (``h2d_rows`` /
``h2d_bytes`` / ``warm``) for a cold pass, a warm pass and a 3-pass restream
sharing one :class:`StreamResidency`, and ``adwise-restream`` / ``2ps`` over
the adversarial streams of ``tests/test_stepcores.py`` with and without an
``allowed`` mask. No latency budget is set, so no per-score cost needs
pinning.
"""
import numpy as np
import pytest
import torch

from repro.core import AdwiseConfig as JaxConfig
from repro.core import partition_stream as jax_partition_stream
from repro.core import registry as jreg
from repro.core import restream as jrs
from repro.core.adwise import Carry as JaxCarry
from repro.core.driver import StreamResidency as JaxResidency
from repro_torch.convert import carry_to_numpy
from repro_torch.core import AdwiseConfig, partition_stream, registry, restream
from repro_torch.core.adwise import Carry
from repro_torch.core.driver import StreamResidency
from repro_torch.graph import partition_balance

torch.set_num_threads(1)

CPU = torch.device("cpu")
_SMALL = dict(window_max=8, window_init=2)
_H2D = ("h2d_rows", "h2d_bytes", "warm")


def _same(got, want, keys=("score_rows",)):
    np.testing.assert_array_equal(got.assign, want.assign)
    for key in keys:
        assert got.stats[key] == want.stats[key], key


def test_warm_start_carry_fields():
    v = 6
    replicas = np.zeros((v, 3), bool)
    replicas[1, 2] = True
    deg = np.arange(v)
    sizes = np.array([5, 1, 2])
    kw = dict(replicas=replicas, deg=deg, sizes=sizes)
    got = Carry.warm_start(AdwiseConfig(k=3, window_max=4), v, 0.0, device=CPU, **kw)
    want = JaxCarry.warm_start(JaxConfig(k=3, window_max=4), v, 0.0, **kw)
    assert got.replicas.shape == (v + 1, 3)  # scatter-dump row appended
    assert bool(got.replicas[1, 2]) and not bool(got.replicas[v].any())
    assert int(got.max_deg) == v - 1 and float(got.lam) == 1.0 and int(got.assigned) == 0
    port = carry_to_numpy(got)
    for name in want._fields:
        np.testing.assert_array_equal(port[name], np.asarray(getattr(want, name)), err_msg=name)
    # max_deg = max(max(deg), 1) with an all-zero table.
    cold = Carry.warm_start(AdwiseConfig(k=3, window_max=4), v, 0.0, device=CPU,
                            replicas=replicas, deg=np.zeros(v), sizes=sizes)
    assert int(cold.max_deg) == 1


def test_warm_from_assignment_round_trip(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:400]
    k = 4
    base = registry.run_partitioner("hdrf", edges, n, k, device="cpu")
    got = restream.warm_from_assignment(edges, base.assign, n, k)
    want = jrs.warm_from_assignment(edges, jreg.run_partitioner("hdrf", edges, n, k).assign, n, k)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.sizes.sum() == len(edges) and got.deg.sum() == 2 * len(edges)
    # A warm pass over the same stream stays valid, balanced and equal to JAX.
    res2 = partition_stream(edges, n, AdwiseConfig(k=k, window_max=16), warm=got, device="cpu")
    want2 = jax_partition_stream(edges, n, JaxConfig(k=k, window_max=16), warm=want)
    _same(res2, want2, ("score_rows", "final_w", "lam_final", "scan_calls") + _H2D)
    np.testing.assert_array_equal(res2.stats["w_trace"], want2.stats["w_trace"])
    assert (res2.assign >= 0).all() and (res2.assign < k).all()
    assert partition_balance(res2.assign, k) < 0.5


def test_h2d_counters_equal_jax_cold_warm_and_resident(tiny_graph):
    """The port ships the JAX driver's bytes: the stream plus a prev table
    on every pass (all -1 when cold), the prev table alone once a
    StreamResidency holds the stream."""
    edges, n = tiny_graph
    edges = edges[:300]
    k, m = 4, 300
    cfg, jcfg = AdwiseConfig(k=k, window_max=16), JaxConfig(k=k, window_max=16)
    cold = partition_stream(edges, n, cfg, device="cpu")
    jcold = jax_partition_stream(edges, n, jcfg)
    _same(cold, jcold, ("score_rows",) + _H2D)
    assert (cold.stats["h2d_rows"], cold.stats["h2d_bytes"], cold.stats["warm"]) == (m, 12 * m, False)
    warm = restream.warm_from_assignment(edges, cold.assign, n, k)
    wpass = partition_stream(edges, n, cfg, warm=warm, device="cpu")
    jwpass = jax_partition_stream(edges, n, jcfg, warm=warm)
    _same(wpass, jwpass, ("score_rows",) + _H2D)
    assert wpass.stats["warm"] is True
    # Three passes sharing one residency: 12m, then 4m, then 4m bytes.
    res, jres = StreamResidency(), JaxResidency()
    prev, jprev = None, None
    for i in range(3):
        w = None if prev is None else restream.warm_from_assignment(edges, prev.assign, n, k)
        jw = None if jprev is None else jrs.warm_from_assignment(edges, jprev.assign, n, k)
        prev = partition_stream(edges, n, cfg, warm=w, residency=res, device="cpu")
        jprev = jax_partition_stream(edges, n, jcfg, warm=jw, residency=jres)
        _same(prev, jprev, ("score_rows",) + _H2D)
        assert prev.stats["h2d_bytes"] == (12 * m if i == 0 else 4 * m)
    got = registry.run_partitioner("adwise-restream", edges, n, k, passes=3, window_max=16,
                                   device="cpu")
    want = jreg.run_partitioner("adwise-restream", edges, n, k, passes=3, window_max=16)
    _same(got, want, ("score_rows", "h2d_rows", "h2d_bytes", "warm", "pass_score_rows"))
    assert got.stats["h2d_bytes"] == 12 * m + 2 * 4 * m


def test_restream_pass2_not_worse_fixed_seeds(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:1000]
    k = 8
    for seed in (0, 1, 2):
        kw = dict(passes=2, seed=seed, window_max=32, window_init=8)
        res = restream.restream_partition(edges, n, k, device="cpu", **kw)
        want = jrs.restream_partition(edges, n, k, **kw)
        _same(res, want, ("score_rows", "pass_rd", "pass_score_rows", "best_pass"))
        pass_rd = res.stats["pass_rd"]
        assert len(pass_rd) == 2
        rd_final = restream._rd(edges, res.assign, n, k)
        assert rd_final <= pass_rd[0] + 1e-9
        assert rd_final == pytest.approx(min(pass_rd), abs=1e-9)


def test_restream_matches_single_pass_at_passes_one(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:600]
    cfg = dict(window_max=16, window_init=4)
    res1 = registry.run_partitioner("adwise", edges, n, 4, device="cpu", **cfg)
    resr = registry.run_partitioner("adwise-restream", edges, n, 4, passes=1, device="cpu", **cfg)
    want = jreg.run_partitioner("adwise-restream", edges, n, 4, passes=1, **cfg)
    np.testing.assert_array_equal(res1.assign, resr.assign)
    _same(resr, want, ("score_rows",) + _H2D)


def test_restream_base_strategy(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:600]
    k = 4
    kw = dict(passes=2, base="hdrf", window_max=16, window_init=4)
    res = restream.restream_partition(edges, n, k, device="cpu", **kw)
    want = jrs.restream_partition(edges, n, k, **kw)
    _same(res, want, ("score_rows", "pass_rd", "pass_score_rows", "h2d_rows", "h2d_bytes"))
    assert res.stats["base"] == "hdrf"
    assert (res.assign >= 0).all() and (res.assign < k).all()
    assert restream._rd(edges, res.assign, n, k) <= res.stats["pass_rd"][0] + 1e-9


def test_restream_stats_shape(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:600]
    kw = dict(passes=3, window_max=16, window_init=4)
    res = restream.restream_partition(edges, n, 4, device="cpu", **kw)
    want = jrs.restream_partition(edges, n, 4, **kw)
    st_ = res.stats
    assert set(st_) == set(want.stats) | {"steps_run", "warmup_steps", "setup_s",
                                          "steps_per_graph", "device", "pass_steps",
                                          "pass_scan_calls"}
    for key in ("passes", "passes_run", "stream_reads", "best_pass", "pass_rd",
                "pass_imbalance", "pass_score_rows", "score_rows", "score_count", "unassigned"):
        assert st_[key] == want.stats[key], key
    assert len(st_["pass_rd"]) == len(st_["pass_wall_s"]) == 3
    assert st_["score_rows"] == sum(st_["pass_score_rows"])
    assert 1 <= st_["best_pass"] <= 3 and st_["unassigned"] == 0


def test_restream_early_stop_and_last_pass_like_jax(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:500]
    for kw in (dict(passes=4, eps=1.0), dict(passes=3, keep_best=False)):
        kw.update(window_max=16, window_init=4)
        got = registry.run_partitioner("adwise-restream", edges, n, 4, device="cpu", **kw)
        want = jreg.run_partitioner("adwise-restream", edges, n, 4, **kw)
        _same(got, want, ("score_rows", "passes_run", "best_pass", "pass_rd"))


def test_restream_rejects_bad_cfg():
    edges = np.array([[0, 1]], np.int32)
    with pytest.raises(TypeError, match="unknown config"):
        registry.run_partitioner("adwise-restream", edges, 2, 2, windw_max=8, device="cpu")
    with pytest.raises(ValueError, match="passes"):
        restream.restream_partition(edges, 2, 2, passes=0, device="cpu")


def test_2ps_round_trip(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:800]
    k = 8
    res = registry.run_partitioner("2ps", edges, n, k, device="cpu")
    want = jreg.run_partitioner("2ps", edges, n, k)
    _same(res, want, ("score_rows", "n_clusters", "name", "stream_reads") + _H2D)
    assert (res.assign >= 0).all() and (res.assign < k).all()
    assert res.stats["n_clusters"] >= 1
    assert partition_balance(res.assign, k) < 0.5


def test_2ps_clustering_invariants(tiny_graph):
    edges, n = tiny_graph
    edges = edges[:800]
    k = 8
    cl, vols = restream.streaming_vertex_clustering(edges, n, k, device="cpu")
    jcl, jvols = jrs.streaming_vertex_clustering(edges, n, k)
    np.testing.assert_array_equal(cl, jcl)
    np.testing.assert_array_equal(vols, jvols)
    streamed = np.zeros(n, bool)
    streamed[edges.ravel()] = True
    assert (cl[streamed] >= 0).all()  # every streamed vertex is clustered
    assert (cl[~streamed] == -1).all()
    deg = np.zeros(n, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    recomputed = np.zeros(len(vols))
    for v_id in np.flatnonzero(streamed):
        recomputed[cl[v_id]] += deg[v_id]
    np.testing.assert_allclose(recomputed, vols)


def test_2ps_rejects_bad_cfg():
    edges = np.array([[0, 1]], np.int32)
    with pytest.raises(TypeError, match="unknown config"):
        registry.run_partitioner("2ps", edges, 2, 2, cluster_slck=1.0, device="cpu")


def _adversarial():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 16, size=(48, 2)).astype(np.int32)
    mixed = base.copy()
    mixed[::3, 1] = mixed[::3, 0]
    mixed[24:36] = mixed[:12]
    star = np.stack([np.zeros(40, np.int32), rng.integers(0, 16, size=40).astype(np.int32)], 1)
    return dict(mixed=mixed, star=star, empty=np.zeros((0, 2), np.int32), tiny=base[:3])


@pytest.mark.parametrize("masked", [False, True], ids=["all", "allowed"])
@pytest.mark.parametrize("name,cfg", [
    ("adwise-restream", dict(_SMALL, passes=2)),
    ("2ps", dict(_SMALL)),
])
def test_multipass_equals_jax_on_adversarial_streams(name, cfg, masked):
    allowed = np.array([True, False, True, True, False, False, True, True])
    kw = dict(cfg, seed=1, allowed=allowed) if masked else dict(cfg, seed=1)
    for sname, edges in _adversarial().items():
        got = registry.run_partitioner(name, edges, 16, 8, device="cpu", **kw)
        want = jreg.run_partitioner(name, edges, 16, 8, **kw)
        keys = ("score_rows", "h2d_rows", "h2d_bytes") if len(edges) else ()
        _same(got, want, keys)
        if masked and len(edges):
            assert set(np.unique(got.assign)) <= set(np.flatnonzero(allowed)), sname
