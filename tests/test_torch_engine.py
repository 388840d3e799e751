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
    # The message layout: 2E directed messages, destination-sorted, tiled
    # over all 2E rows and N destinations.
    lay = tg.msg_layout
    dst = lay.seg_ids.numpy()
    assert len(dst) == 2 * len(EDGES) and (np.diff(dst) >= 0).all()
    assert lay.num_segments == N and int(lay.offsets[-1]) == len(dst)
    assert tuple(lay.tiles[-1].tolist()) == (len(dst), N, -1, -1)


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
    (["--arch", "rwkv6-7b", "--reduced", "--tp", "2"], "item 15"),
    (["--arch", "granite-moe-1b", "--reduced", "--steps", "2"], None),
])
def test_launch_names_the_roadmap_item_for_unported_paths(argv, item, capsys, tmp_path):
    """No launcher path is left unported, so none names a ROADMAP.md item
    (the partition launcher runs graph files, see
    test_launch_runs_graph_files_like_jax; serving and training run every
    family, over ranks too, see tests/test_torch_tp*.py). ``--tp 2``
    training of an ssm family, the path of ``item`` 15f, runs over two
    spawned ranks with world 1's losses; training a non-dense family
    (``item`` None) runs: two finite losses."""
    import _train_ranks
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.train import main as train_main

    run = argv + ["--batch", "2", "--seq", "8", "--steps", "2"]
    one = run[:run.index("--tp")] + run[run.index("--tp") + 2:] if "--tp" in run else run
    losses = train_main(one + ["--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    if item is not None:
        ranks = meshes.spawn(_train_ranks.launcher_rank, 2, (str(tmp_path / "store"), [run]),
                             timeout=240)
        for (got, info), in ranks:
            np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
            assert (info["tp"], info["world"]) == (2, 2)
    assert "ROADMAP" not in capsys.readouterr().out


@pytest.mark.parametrize("form", ["binary", "text"])
def test_launch_runs_graph_files_like_jax(form, tmp_path, capsys):
    """``--graph <file.adw>`` and ``--graph <file.txt> --ingest`` partition
    out-of-core and run pagerank on the engine, with repro's report lines:
    the graph line, the quality fields, the io counters and the modeled
    processing."""
    from repro.launch.partition import main as jax_main
    from repro_torch.graph import make_graph
    from repro_torch.graph.io import write_edge_file
    from repro_torch.launch.partition import main as port_main

    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    argv = ["--k", "4", "--window-max", "16", "--chunk-edges", "128", "--iters", "10",
            "--z", "2", "--spread", "2"]
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        if form == "binary":
            path = str(d / "g.adw")
            write_edge_file(path, edges, n)
            extra = []
        else:
            path = str(d / "g.txt")
            with open(path, "w") as f:
                f.write("# u v\n" + "".join(f"{u} {v}\n" for u, v in edges))
            extra = ["--ingest"]
        more = ["--device", "cpu"] if name == "port" else []
        out = main(["--graph", path, "--spill-dir", str(d / "spill")] + argv + extra + more)
        lines = [ln.replace(str(d), "DIR") for ln in capsys.readouterr().out.splitlines()]
        outs[name] = (out, lines, np.fromfile(str(d / "spill" / "assign.i32"), np.int32))
    (jax_out, jl, ja), (port_out, pl, pa) = outs["jax"], outs["port"]
    np.testing.assert_array_equal(pa, ja)
    start = 1 if form == "text" else 0  # the ingest line carries a wall time
    assert pl[start] == jl[start]  # graph=... |V|=... |E|=... (out-of-core, chunk=...)
    jp, pp = _fields(jl[start + 1]), _fields(pl[start + 1])
    for key in ("partitioner", "RD", "imbalance", "unassigned"):
        assert pp[key] == jp[key], key
    io_j, io_p = jl[start + 2], pl[start + 2]
    assert io_p.split("io_wall")[0] == io_j.split("io_wall")[0]
    assert io_p.split("resident edges")[1] == io_j.split("resident edges")[1]
    assert _fields(pl[-2])["modeled_processing"] == _fields(jl[-2])["modeled_processing"]
    assert port_out["replication_degree"] == jax_out["replication_degree"]
    for key in ("h2d_rows", "h2d_bytes", "scan_calls", "buffer_rows", "stream_reads", "z"):
        assert port_out["stats"][key] == jax_out["stats"][key], key


@pytest.mark.parametrize("strategy,backend", [
    ("adwise", "auto"), ("adwise", "loop"), ("hdrf", "auto"), ("adwise-restream", "auto"),
])
def test_launch_runs_spotlight_like_jax(strategy, backend, capsys):
    """``--z 4 --spread 2``: the port's lines equal ``repro.launch.partition``'s
    (the graph line, the quality fields, the modeled processing)."""
    from repro.launch.partition import main as jax_main
    from repro_torch.launch.partition import main as port_main

    argv = ["--graph", "tiny_clustered", "--scale", "0.1", "--k", "8", "--window-max", "16",
            "--z", "4", "--spread", "2", "--strategy", strategy, "--backend", backend,
            "--iters", "10"]
    jax_out = jax_main(argv)
    jax_lines = capsys.readouterr().out.splitlines()
    port_out = port_main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_lines[0] == port_lines[0]
    jp, pp = _fields(jax_lines[1]), _fields(port_lines[1])
    assert set(jp) == set(pp)
    for key in ("partitioner", "RD", "imbalance", "unassigned"):
        assert pp[key] == jp[key], key
    assert _fields(port_lines[2])["modeled_processing"] == _fields(jax_lines[2])["modeled_processing"]
    assert port_out["replication_degree"] == jax_out["replication_degree"]
    want_backend = "loop" if backend == "loop" else "vmap"
    assert port_out["stats"]["backend"] == jax_out["stats"]["backend"] == want_backend
    assert port_out["stats"]["z"] == 4 and port_out["stats"]["spread"] == 2


@pytest.mark.parametrize("strategy", ["hdrf", "greedy", "adwise-restream", "2ps", "2ps-l"])
def test_launch_runs_the_comparison_set_like_jax(strategy, capsys):
    from repro.launch.partition import main as jax_main
    from repro_torch.launch.partition import main as port_main

    argv = ["--graph", "tiny_clustered", "--scale", "0.1", "--k", "4", "--window-max", "16",
            "--strategy", strategy, "--workload", "none"]
    jax_main(argv)
    jax_lines = capsys.readouterr().out.splitlines()
    port_out = port_main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_lines[0] == port_lines[0]
    jp, pp = _fields(jax_lines[1]), _fields(port_lines[1])
    for key in ("partitioner", "RD", "imbalance", "unassigned"):
        assert pp[key] == jp[key], key
    assert port_out["strategy"] == strategy and port_out["unassigned"] == 0


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
