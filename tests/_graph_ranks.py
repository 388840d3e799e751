"""Rank functions of the partition → process tests over ranks, run in
processes that ``repro_torch.launch.mesh.spawn`` starts. This module imports
only the port (no ``jax``, no ``repro``), so a rank starts quickly and the
card machine, which has no JAX, imports it too.

Each rank joins a gloo group through a file store (no ports), so several
tests can run at once.
"""
import numpy as np
import torch


def _join(store, device="cpu"):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshes

    return meshes.init_ranks("gloo", torch.device(device), f"file://{store}")


def engine_rank(rank, edges, assign, n, k, store, device="cpu", iters=20, n_devices=None):
    """The four engine workloads on the rank's slab of ``engine_mesh(k=k)``,
    the graph built for that mesh: each result, the mesh's size and
    coordinate, the superstep's ``slab_occupancy``, the partitions and
    messages the rank's graph holds, and the mesh's collectives (op ->
    [count, bytes])."""
    _join(store, device)
    from repro_torch import engine
    from repro_torch.engine.gas import make_superstep
    from repro_torch.kernels import ops

    mesh = engine.engine_mesh(n_devices=n_devices, k=k)
    g = engine.build_partitioned_graph(edges, assign, n, k, device=device, mesh=mesh)
    step = make_superstep(g, lambda a, b, c, d: (a, b), lambda s, acc, deg: acc, mesh)
    ops.reset_launch_counts()
    pr, pr_info = engine.pagerank(g, iters=iters, mesh=mesh)
    launches = ops.launch_counts()["segment_sum"]
    collectives = {op: list(v) for op, v in mesh.stats.items()}
    lp, lp_info = engine.label_propagation(g, mesh=mesh)
    col, col_info = engine.coloring(g, mesh=mesh)
    tri, tri_info = engine.triangle_count(g, sketch_bits=max(256, n), mesh=mesh)
    return dict(
        size=mesh.size, coord=mesh.coord, occupancy=step.slab_occupancy, held=g.parts,
        held_shape=tuple(g.edges.shape), held_msgs=len(g.msg_src),
        pagerank=pr, pagerank_info=pr_info, pagerank_collectives=collectives,
        pagerank_launches=launches,
        label_propagation=lp, label_propagation_info=lp_info,
        coloring=col, coloring_info=col_info, triangles=tri, triangles_info=tri_info,
    )


def call_rank(rank, store, calls, device="cpu"):
    """``calls``: a list of (module path, function name, args, kwargs) run in
    order on this rank; returns their results (``PartitionResult``s as
    (assign, stats) pairs, memmaps as arrays)."""
    import importlib

    _join(store, device)
    out = []
    for module, name, args, kwargs in calls:
        res = getattr(importlib.import_module(module), name)(*args, **kwargs)
        out.append(_plain(res))
    return out


def partition_file_rank(path, strategy, k, **kwargs):
    """``core.partition_file`` on the edge file at ``path`` (run through
    :func:`call_rank`)."""
    from repro_torch.core import partition_file
    from repro_torch.graph.io import EdgeFileReader

    with EdgeFileReader(path) as reader:
        res = partition_file(reader, strategy, k, **kwargs)
        return _plain(res)


def _plain(res):
    if isinstance(res, (list, tuple)):
        return type(res)(_plain(r) for r in res)
    if hasattr(res, "assign") and hasattr(res, "stats"):
        stats = {k: v for k, v in res.stats.items() if k not in ("ring_handle", "trace_summary")}
        return np.array(res.assign), stats
    return res


def launcher_rank(rank, argv):
    """``launch.partition.main(argv)`` on this rank: its report and what it
    printed."""
    import contextlib
    import io

    torch.set_num_threads(1)
    from repro_torch.launch import partition

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = partition.main(argv)
    return out, buf.getvalue()
