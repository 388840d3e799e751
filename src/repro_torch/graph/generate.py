"""Synthetic graph generators.

The paper evaluates on Orkut (social, low clustering c=0.04), Brain
(biological, moderate clustering c=0.51) and Web (very high clustering
c=0.82). Those datasets are not available offline, so we provide generators
whose knobs reproduce the *properties the paper's claims depend on*: degree
skew (power-law) and local clustering coefficient. Presets ``orkut_like``,
``brain_like`` and ``web_like`` are calibrated stand-ins at CPU-feasible
scale.

All generators return an int32 edge array of shape (m, 2) plus the vertex
count. Edges are undirected conceptually; they are stored as (u, v) pairs in
*stream order* (the order a streaming partitioner would see them). Use
``repro.graph.stream.EdgeStream`` to reshuffle / chunk.

Copied from the JAX package (numpy only): the same preset, seed and scale
give byte-identical edges in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

__all__ = [
    "rmat",
    "barabasi_albert",
    "watts_strogatz",
    "erdos_renyi",
    "make_graph",
    "GRAPH_PRESETS",
    "clustering_coefficient",
]


def _dedupe(edges: np.ndarray, n: int) -> np.ndarray:
    """Remove self loops and duplicate (u,v)/(v,u) edges, keep first occurrence order."""
    u, v = edges[:, 0], edges[:, 1]
    mask = u != v
    edges = edges[mask]
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    key = lo * np.int64(n) + hi
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    return edges[first_idx]


def rmat(
    n_log2: int,
    m: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, int]:
    """R-MAT power-law generator (Chakrabarti et al.).

    Produces a skewed degree distribution similar to social graphs. ``a,b,c``
    are the recursive quadrant probabilities (d = 1-a-b-c).
    """
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    # Oversample; dedupe trims self-loops/duplicates.
    factor = 1.35
    num = int(m * factor)
    probs = np.array([a, b, c, 1.0 - a - b - c])
    quadrants = rng.choice(4, size=(num, n_log2), p=probs)
    # quadrant 0 -> (0,0), 1 -> (0,1), 2 -> (1,0), 3 -> (1,1)
    row_bits = (quadrants >= 2).astype(np.int64)
    col_bits = (quadrants % 2).astype(np.int64)
    weights = 1 << np.arange(n_log2 - 1, -1, -1, dtype=np.int64)
    u = (row_bits * weights).sum(axis=1)
    v = (col_bits * weights).sum(axis=1)
    edges = np.stack([u, v], axis=1).astype(np.int32)
    edges = _dedupe(edges, n)[:m]
    return edges, n


def barabasi_albert(n: int, m_per_node: int, seed: int = 0) -> tuple[np.ndarray, int]:
    """Barabási–Albert preferential attachment: power-law, low clustering."""
    rng = np.random.default_rng(seed)
    edges = []
    # Start with a small clique.
    core = m_per_node + 1
    for i in range(core):
        for j in range(i + 1, core):
            edges.append((i, j))
    # Repeated-endpoint list approximates preferential attachment.
    targets = [e for pair in edges for e in pair]
    for v in range(core, n):
        chosen = set()
        while len(chosen) < m_per_node:
            chosen.add(targets[rng.integers(0, len(targets))])
        for u in chosen:
            edges.append((u, v))
            targets.extend((u, v))
    arr = np.array(edges, dtype=np.int32)
    return _dedupe(arr, n), n


def watts_strogatz(n: int, k: int, beta: float, seed: int = 0) -> tuple[np.ndarray, int]:
    """Watts–Strogatz small-world: high clustering coefficient (ring + rewiring)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), k // 2)
    offsets = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), n)
    dst = (src + offsets) % n
    rewire = rng.random(src.shape[0]) < beta
    dst[rewire] = rng.integers(0, n, size=int(rewire.sum()))
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return _dedupe(edges, n), n


def erdos_renyi(n: int, m: int, seed: int = 0) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(seed)
    num = int(m * 1.15)
    u = rng.integers(0, n, size=num)
    v = rng.integers(0, n, size=num)
    edges = np.stack([u, v], axis=1).astype(np.int32)
    return _dedupe(edges, n)[:m], n


def clustered_powerlaw(
    n: int,
    m: int,
    community_size: int,
    p_intra: float,
    seed: int = 0,
) -> tuple[np.ndarray, int]:
    """Power-law hubs + strong communities (Brain/Web-like).

    Vertices are grouped into communities of ``community_size``. With
    probability ``p_intra`` an edge is drawn inside a community (producing
    high local clustering), otherwise endpoints follow a Zipf-ish hub
    distribution (producing skew). This mirrors the stereotypical structure in
    Fig. 5 of the paper: cliquish low-degree regions connected through
    high-degree hubs.
    """
    rng = np.random.default_rng(seed)
    num = int(m * 1.3)
    n_comm = max(1, n // community_size)
    intra = rng.random(num) < p_intra
    # Intra-community edges.
    comm = rng.integers(0, n_comm, size=num)
    base = comm * community_size
    iu = base + rng.integers(0, community_size, size=num)
    iv = base + rng.integers(0, community_size, size=num)
    # Hub edges: Zipf exponent ~2 over vertices.
    hub_u = (rng.zipf(1.8, size=num) - 1) % n
    hv = rng.integers(0, n, size=num)
    u = np.where(intra, iu, hub_u).astype(np.int64) % n
    v = np.where(intra, iv, hv).astype(np.int64) % n
    edges = np.stack([u, v], axis=1).astype(np.int32)
    return _dedupe(edges, n)[:m], n


def clustering_coefficient(edges: np.ndarray, n: int, sample: int = 400, seed: int = 0) -> float:
    """Approximate average local clustering coefficient over a vertex sample."""
    rng = np.random.default_rng(seed)
    adj: Dict[int, set] = {}
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    verts = [v for v in adj if len(adj[v]) >= 2]
    if not verts:
        return 0.0
    picks = rng.choice(len(verts), size=min(sample, len(verts)), replace=False)
    total = 0.0
    for i in picks:
        v = verts[i]
        nbrs = list(adj[v])
        d = len(nbrs)
        links = 0
        for a in range(d):
            sa = adj[nbrs[a]]
            for b in range(a + 1, d):
                if nbrs[b] in sa:
                    links += 1
        total += 2.0 * links / (d * (d - 1))
    return total / len(picks)


@dataclasses.dataclass(frozen=True)
class GraphPreset:
    """Named generator configuration (paper-graph stand-in)."""

    name: str
    fn: Callable[..., tuple[np.ndarray, int]]
    kwargs: dict
    description: str


GRAPH_PRESETS: Dict[str, GraphPreset] = {
    # Social graph, low clustering (paper: Orkut, c~0.04) — RMAT skew.
    "orkut_like": GraphPreset(
        "orkut_like",
        rmat,
        dict(n_log2=16, m=400_000),
        "power-law social graph, low clustering (Orkut proxy)",
    ),
    # Biological, moderate clustering (paper: Brain, c~0.51).
    "brain_like": GraphPreset(
        "brain_like",
        clustered_powerlaw,
        dict(n=40_000, m=400_000, community_size=28, p_intra=0.62),
        "moderately clustered hub graph (Brain proxy)",
    ),
    # Web graph, very high clustering (paper: Web, c~0.82).
    "web_like": GraphPreset(
        "web_like",
        clustered_powerlaw,
        dict(n=60_000, m=500_000, community_size=40, p_intra=0.9),
        "highly clustered web-like graph (Web proxy)",
    ),
    # Small variants for tests.
    "tiny_social": GraphPreset("tiny_social", rmat, dict(n_log2=10, m=4_000), "tiny RMAT"),
    "tiny_clustered": GraphPreset(
        "tiny_clustered",
        clustered_powerlaw,
        dict(n=1_000, m=5_000, community_size=20, p_intra=0.8),
        "tiny clustered",
    ),
}


def make_graph(
    preset: str, seed: int = 0, scale: float = 1.0, order: str = "file"
) -> tuple[np.ndarray, int]:
    """Instantiate a preset; ``scale`` multiplies edge/vertex counts.

    order: 'file' (default) sorts edges by source vertex — the order real
    edge-list files (Orkut/Brain/Web adjacency dumps) are stored in and what
    a streaming partitioner actually consumes. This stream *locality* is what
    window/clustering scores and the spotlight optimization exploit (paper
    §III-C/D). 'random' shuffles (adversarial stream).
    """
    p = GRAPH_PRESETS[preset]
    kw = dict(p.kwargs)
    for key in ("m", "n"):
        if key in kw:
            kw[key] = max(64, int(kw[key] * scale))
    if "n_log2" in kw and scale != 1.0:
        kw["n_log2"] = max(8, kw["n_log2"] + int(np.round(np.log2(scale))))
    edges, n = p.fn(seed=seed, **kw)
    if order == "file":
        idx = np.argsort(edges[:, 0], kind="stable")
        edges = edges[idx]
    elif order == "random":
        rng = np.random.default_rng(seed + 777)
        edges = edges[rng.permutation(len(edges))]
    else:
        raise ValueError(order)
    return edges, n
