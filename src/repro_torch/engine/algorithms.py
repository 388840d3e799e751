"""Graph algorithms on the vertex-cut engine (the paper's §IV workloads).

Port of the JAX package's ``engine/algorithms.py``:

  pagerank          — light compute/comm (paper Fig. 7a-c)
  coloring          — greedy conflict-resolution coloring (paper Fig. 7e)
  label_propagation — connected components (min-label flooding)
  triangle_count    — heavy neighbourhood-intersection workload

Each runs on the partitioned graph's device and returns (result, info);
info carries the superstep count and message width the latency model
bills. pagerank and triangle round 1 accumulate with ``add`` (the
``segment_sum`` kernel on the card), the others with ``min``.

When no mesh is passed, each workload builds one with
``engine_mesh(k=g.k)``, as in the JAX package: its partitions are sharded
over every rank of the default process group (one rank without one). Each
rank returns the same result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.gas import BIG, engine_mesh, make_superstep
from repro_torch.engine.partitioned import PartitionedGraph
from repro_torch.dist import RankMesh

__all__ = ["pagerank", "label_propagation", "coloring", "triangle_count"]


def _forward(x_u, x_v, deg_u, deg_v):
    return x_u, x_v  # forward the neighbour's current value


def pagerank(
    g: PartitionedGraph, iters: int = 20, damping: float = 0.85,
    mesh: Optional[RankMesh] = None, trace=None,
) -> Tuple[np.ndarray, dict]:
    mesh = mesh or engine_mesh(k=g.k)
    v = g.num_vertices

    def msg(x_u, x_v, deg_u, deg_v):
        # Push current rank mass along both directions (undirected).
        return (x_u / deg_u.clamp_min(1)[:, None],
                x_v / deg_v.clamp_min(1)[:, None])

    def apply(state, synced, degrees):
        return (1.0 - damping) / v + damping * synced

    step = make_superstep(g, msg, apply, mesh, trace=trace)
    state = torch.full((v, 1), 1.0 / v, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        state = step(state)
    return state[:, 0].cpu().numpy(), dict(supersteps=iters, msg_width=1)


def label_propagation(
    g: PartitionedGraph, max_iters: int = 64, mesh: Optional[RankMesh] = None,
    trace=None,
) -> Tuple[np.ndarray, dict]:
    """Connected components by min-label flooding; converged when stable."""
    mesh = mesh or engine_mesh(k=g.k)
    v = g.num_vertices

    def apply(state, synced, degrees):
        has_nbr = synced < BIG
        return torch.where(has_nbr, torch.minimum(state, synced), state)

    step = make_superstep(g, _forward, apply, mesh, combine="min", trace=trace)
    state = torch.arange(v, dtype=torch.float32, device=g.device)[:, None]
    it = 0
    for it in range(1, max_iters + 1):
        new = step(state)
        done = torch.equal(new, state)  # the convergence test reads the device
        state = new
        if done:
            break
    return state[:, 0].cpu().numpy().astype(np.int64), dict(supersteps=it, msg_width=1)


def coloring(
    g: PartitionedGraph, max_colors: int = 64, max_iters: int = 256,
    mesh: Optional[RankMesh] = None, trace=None,
) -> Tuple[np.ndarray, dict]:
    """Largest-priority-first greedy coloring (Jones–Plassmann schedule).

    State (min-combined) per vertex: [a | b_0..b_{C-1}] with
      a   = −(prio+1) while unfinalized, +BIG once finalized
      b_j = 0 if finalized with color j else 1
    so synced_a = −(max unfinalized neighbour prio+1) and synced_b_j = 0 iff
    some finalized neighbour holds color j. Priorities are the JAX package's
    (a numpy permutation seeded with 0).
    """
    mesh = mesh or engine_mesh(k=g.k)
    v, c = g.num_vertices, max_colors
    dev = g.device
    rng = np.random.default_rng(0)
    prio = torch.as_tensor((rng.permutation(v) + 1).astype(np.float32), device=dev)

    def apply(state, synced, degrees):
        a = state[:, 0]
        finalized = a > 0
        # No unfinalized higher-priority neighbour (priorities are distinct).
        can = (~finalized) & (synced[:, 0] > -prio)
        free = (synced[:, 1:] > 0.5).to(torch.uint8).argmax(1)  # smallest unused color
        onehot = torch.nn.functional.one_hot(free, c).to(torch.float32)
        b = torch.where(can[:, None], 1.0 - onehot, state[:, 1:])
        a_new = torch.where(can, BIG, a)
        return torch.cat([a_new[:, None], b], dim=1)

    step = make_superstep(g, _forward, apply, mesh, combine="min", trace=trace)
    state = torch.cat(
        [(-prio)[:, None], torch.ones((v, c), dtype=torch.float32, device=dev)], dim=1
    )
    it = 0
    for it in range(1, max_iters + 1):
        new = step(state)
        done = bool((new[:, 0] > 0).all()) or torch.equal(new, state)
        state = new
        if done:
            break
    colors = state[:, 1:].argmin(1).cpu().numpy()
    return colors, dict(supersteps=it, msg_width=1 + c)


def triangle_count(
    g: PartitionedGraph, sketch_bits: int = 256, mesh: Optional[RankMesh] = None,
    trace=None,
) -> Tuple[int, dict]:
    """Heavy workload: triangle counting via neighbourhood bitmaps.

    Round 1 (a superstep, ``add``) gives each vertex a ``sketch_bits``-wide
    bitmap of its neighbours' hash bits; round 2 counts, per edge, the bits
    both endpoints' bitmaps share. Exact when sketch_bits >= V. Each rank
    counts round 2 over its slab's edges and one all-reduce sums the counts
    (the JAX package counts every edge on the host; the integer sum is the
    same).
    """
    mesh = mesh or engine_mesh(k=g.k)
    v, b = g.num_vertices, sketch_bits
    dev = g.device
    slot = torch.arange(v, device=dev) % b  # vertex -> sketch bit

    def apply(state, synced, degrees):
        return synced.clamp_max(1.0)  # OR of neighbour one-bit ids

    step = make_superstep(g, _forward, apply, mesh, trace=trace)
    ident = torch.nn.functional.one_hot(slot, b).to(torch.float32)
    bm = step(ident) > 0  # (V, b) — some neighbour hashes to bit j
    edges, evalid = g.part_edges(*step.parts)
    u, w = edges[..., 0].long(), edges[..., 1].long()
    inter = (bm[u] & bm[w]).sum(-1)  # (slab, e_max) common-neighbour bits
    count = mesh.all_reduce((inter * evalid).sum(), "sum")
    total = int(count) // 3  # each triangle counted by 3 edges
    return total, dict(supersteps=2, msg_width=b // 32)
