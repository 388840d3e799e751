"""The port's engine, latency model and launcher against the JAX package's.

Both engines run on the same partition of the same graph. pagerank sums in
another fp32 order (the port accumulates per vertex through
``segment_sum``, the JAX engine per partition, then across partitions), so
it is held at rtol 1e-5 / atol 1e-8; the ``min``-combined workloads and
the triangle count are exact.
"""
import re

import numpy as np
import pytest
import torch

from repro import engine as jeng
from repro.obs import Tracer
from repro_torch import engine
from repro_torch.convert import partitioned_graph_from_numpy
from repro_torch.core import run_partitioner
from repro_torch.graph import make_graph

torch.set_num_threads(1)

CPU = "cpu"
EDGES, N = make_graph("tiny_clustered", seed=1, scale=0.3)
K = 4


@pytest.fixture(scope="module")
def graphs():
    res = run_partitioner("adwise", EDGES, N, K, window_max=16, device=CPU)
    jg = jeng.build_partitioned_graph(EDGES, res.assign, N, K)
    tg = engine.build_partitioned_graph(EDGES, res.assign, N, K, device=CPU)
    return res, jg, tg


def _numpy_pagerank(edges, n, iters):
    """The dense oracle of tests/test_system.py."""
    deg = np.zeros(n)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    x = np.full(n, 1.0 / n)
    for _ in range(iters):
        acc = np.zeros(n)
        np.add.at(acc, edges[:, 1], x[edges[:, 0]] / np.maximum(deg[edges[:, 0]], 1))
        np.add.at(acc, edges[:, 0], x[edges[:, 1]] / np.maximum(deg[edges[:, 1]], 1))
        x = 0.15 / n + 0.85 * acc
    return x


def test_partitioned_graph_fields_equal_jax(graphs):
    _, jg, tg = graphs
    for name in ("edges", "evalid", "replicas", "masters", "degrees"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name)
    assert tg.replication_degree == jg.replication_degree
    assert tg.sync_volume_bytes == jg.sync_volume_bytes
    np.testing.assert_array_equal(tg.edges_per_partition, jg.edges_per_partition)
    # The message layout: 2E directed messages, destination-sorted, chunked
    # over all 2E rows and N destinations.
    lay = tg.msg_layout
    dst = lay.seg_ids.numpy()
    assert len(dst) == 2 * len(EDGES) and (np.diff(dst) >= 0).all()
    assert lay.num_segments == N and int(lay.chunk_row[-1]) == len(dst)


def test_graph_from_numpy_fields_equals_direct_build(graphs):
    _, jg, tg = graphs
    cg = partitioned_graph_from_numpy(
        np.asarray(jg.edges), np.asarray(jg.evalid), np.asarray(jg.replicas),
        np.asarray(jg.masters), np.asarray(jg.degrees), jg.num_vertices, jg.k, CPU,
    )
    for name in ("edges", "evalid", "replicas", "msg_src"):
        assert torch.equal(getattr(cg, name), getattr(tg, name)), name
    for name, a, b in zip(tg.msg_layout._fields, cg.msg_layout, tg.msg_layout):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name


def test_pagerank_matches_jax_and_numpy(graphs):
    _, jg, tg = graphs
    got, info = engine.pagerank(tg, iters=30)
    want, jinfo = jeng.pagerank(jg, iters=30)
    assert info == jinfo
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got, _numpy_pagerank(EDGES, N, 30), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("workload", ["label_propagation", "coloring", "triangle_count"])
def test_exact_workloads_equal_jax(graphs, workload):
    _, jg, tg = graphs
    got, info = getattr(engine, workload)(tg)
    want, jinfo = getattr(jeng, workload)(jg)
    assert info == jinfo
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_latency_model_equals_jax(graphs):
    res, jg, tg = graphs
    m = len(EDGES)
    assert engine.partition_latency(res.stats, m, K) == jeng.partition_latency(res.stats, m, K)
    for prof in ("PAPER_CLUSTER", "TPU_POD"):
        for steps, width in [(300, 1), (40, 128)]:
            got = engine.process_latency(tg, steps, width, getattr(engine, prof))
            want = jeng.process_latency(jg, steps, width, getattr(jeng, prof))
            assert got == want


def test_superstep_slab_occupancy_and_trace_span(graphs):
    _, _, tg = graphs
    tr = Tracer()
    step = engine.make_superstep(tg, lambda a, b, c, d: (a, b),
                                 lambda s, acc, deg: acc, trace=tr)
    assert step.slab_occupancy == (K,)
    state = torch.ones((N, 1))
    out = step(state)
    np.testing.assert_array_equal(out[:, 0].numpy(), np.bincount(tg.msg_layout.seg_ids.numpy(), minlength=N))
    assert tr.summary().categories["engine"]["count"] == 1
    plain = engine.make_superstep(tg, lambda a, b, c, d: (a, b), lambda s, acc, deg: acc)
    assert plain.slab_occupancy == (K,)


def test_build_rejects_unassigned_edges():
    assign = np.zeros(len(EDGES), np.int32)
    assign[3] = -1
    with pytest.raises(ValueError, match="outside"):
        engine.build_partitioned_graph(EDGES, assign, N, K, device=CPU)


def _fields(line):
    return dict(re.findall(r"(\w+)=(\S+)", line))


def test_launch_prints_the_jax_lines(capsys):
    from repro.launch.partition import main as jax_main
    from repro_torch.launch.partition import main as port_main

    argv = ["--graph", "tiny_clustered", "--scale", "0.2", "--k", "4",
            "--window-max", "16", "--iters", "10"]
    jax_out = jax_main(argv)
    jax_lines = capsys.readouterr().out.splitlines()
    port_out = port_main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_lines[0] == port_lines[0]  # graph=... |V|=... |E|=... k=...
    jp, pp = _fields(jax_lines[1]), _fields(port_lines[1])
    assert set(jp) == set(pp)
    for key in ("partitioner", "RD", "imbalance", "unassigned"):
        assert pp[key] == jp[key], key
    jw, pw = _fields(jax_lines[2]), _fields(port_lines[2])
    assert set(jw) == set(pw)
    assert pw["modeled_processing"] == jw["modeled_processing"]
    assert port_lines[3].startswith("TOTAL latency (partition + modeled processing) = ")
    assert jax_lines[3].startswith("TOTAL latency (partition + modeled processing) = ")
    assert port_out["replication_degree"] == jax_out["replication_degree"]
    assert port_out["processing_model"] == jax_out["processing_model"]


@pytest.mark.parametrize("argv,item", [
    (["--strategy", "hdrf"], "item 7"),
    (["--strategy", "2ps"], "item 9"),
    (["--z", "4"], "item 8"),
    (["--graph", __file__], "item 10"),
])
def test_launch_names_the_roadmap_item_for_unported_paths(argv, item):
    from repro_torch.launch.partition import main as port_main

    with pytest.raises(SystemExit, match=f"ROADMAP.md, port queue 1, {item}"):
        port_main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("workload", ["coloring", "wcc", "triangles", "none"])
def test_launch_runs_every_workload(workload, capsys):
    from repro_torch.launch.partition import main as port_main

    out = port_main(["--graph", "tiny_clustered", "--scale", "0.2", "--k", "4",
                     "--strategy", "hash", "--workload", workload, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert _fields(lines[1])["partitioner"] == "hash" and out["unassigned"] == 0
    if workload == "none":
        assert "total_latency_s" not in out and len(lines) == 2
    else:
        assert out["processing_model"]["supersteps"] >= 1
        assert lines[-1].startswith("TOTAL latency (partition + modeled processing) = ")
