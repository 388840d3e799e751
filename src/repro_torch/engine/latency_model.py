"""Cluster processing-latency cost model.

The container is a single CPU host, so distributed graph *processing* latency
cannot be measured directly. Following the paper's own analysis (§IV: replica
synchronisation traffic drives processing latency), the model converts the
partitioned graph's measurable structure into per-superstep seconds for a
given cluster profile:

  t_step = t_compute + t_sync
  t_compute = max_p(edges_p) · msg_width · C_EDGE           (straggler = max)
  t_sync    = ceil(sync_bytes/nodes) / BW + 2·RTT
  sync_bytes = Σ_v (|R_v|−1) · 2 · msg_width · 4 B          (Eq. 1 traffic)

Copied from the JAX package's ``engine/latency_model.py``; compute is
billed at the calibrated ``SCORE_COST_S`` (the port keeps no autotune table
in this slice). Profiles: the paper's evaluation cluster (8 nodes, 1 GbE)
and a TPU-pod ICI profile. Constants are calibrated so PageRank on the Brain-like proxy lands in
the paper's reported magnitude (hundreds of seconds per 100 iterations on
8×1 GbE); all benchmark *claims* are relative across partitioners, which the
model preserves exactly — traffic is linear in replication degree.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.engine.partitioned import PartitionedGraph

__all__ = [
    "ClusterProfile", "PAPER_CLUSTER", "TPU_POD", "partition_latency", "process_latency",
]


@dataclasses.dataclass(frozen=True)
class ClusterProfile:
    name: str
    nodes: int
    link_bw_Bps: float  # per-node usable bandwidth
    rtt_s: float
    edge_cost_s: float  # per (edge · message word)
    replica_cost_s: float  # per replica bookkeeping op


PAPER_CLUSTER = ClusterProfile(
    name="8x1GbE (paper)",
    nodes=8,
    link_bw_Bps=117e6,
    rtt_s=2e-4,
    edge_cost_s=9e-9,
    replica_cost_s=40e-9,
)

TPU_POD = ClusterProfile(
    name="v5e pod ICI",
    nodes=256,
    link_bw_Bps=5e10,
    rtt_s=1e-6,
    edge_cost_s=2e-10,
    replica_cost_s=1e-9,
)


# Streaming-partitioner cost constants calibrated to the paper's setup
# (HDRF on Brain: ~20.6M edges/instance on one 3 GHz Xeon core in O(100 s)
# ⇒ ~0.2 µs per (edge, partition) score evaluation + ~1 µs/edge stream IO).
SCORE_COST_S = 2.3e-7
EDGE_IO_COST_S = 1.0e-6
# Host→device stream-buffer bandwidth (PCIe-gen4-class x16 sustained). The
# scan drivers count every byte they ship (`h2d_bytes` in partition stats —
# O(m) for the ring-buffer file path, O(m) once for resident uploads); the
# model bills the transfer so buffer-management regressions (e.g. re-uploading
# a full ring per scan call) show up as modeled latency, not just wall noise.
H2D_BW_BPS = 16e9


def partition_latency(
    stats: dict, m: int, k: int, *, score_cost_s: float | None = None
) -> float:
    """Modeled cluster partitioning latency from the algorithm's own
    complexity counters (score computations — the paper's §III-B metric).

    Uses stats['score_rows'] (windowed partitioners) or stats['score_count']
    (single-edge: m·k) when present; hash-family partitioners cost IO only.
    Multi-pass strategies read the stream once per pass: the IO term is
    ``reads * m * EDGE_IO_COST_S`` with ``reads`` taken from
    stats['stream_reads'] (re-streaming reports passes_run there, 2PS
    reports 2), falling back to stats['passes_run'] / stats['passes'] and
    finally a single read — so Fig. 7-style plots bill re-streaming fairly
    with ``m`` being the plain stream length everywhere. Device-offloaded
    scans additionally bill their host→device stream traffic — the
    *measured* stall (stats['h2d_wait_s']: wall the driver actually spent
    blocked in refills) when the driver reports one, else the modeled
    transfer (stats['h2d_bytes'] / :data:`H2D_BW_BPS`).

    Overlap-aware billing: when the refill pipeline is active
    (stats['prefetch_depth'] > 0) the stream IO, the h2d transfer, and the
    scoring compute run concurrently by construction (the read-ahead worker
    reads while the scan computes, and the speculative refill ships while
    the scan is in flight), so the model bills ``max(compute, io, h2d)``
    instead of their sum. Without prefetch the classic additive model
    stands. The *measured* CPU wall-clock stays in stats['wall_time_s'] for
    reference — the model keeps partitioning and processing in the same
    cluster units.
    """
    if "score_rows" in stats:
        scores = stats["score_rows"] * k
    else:
        scores = stats.get("score_count", 0)
    reads = int(
        stats.get("stream_reads")
        or stats.get("passes_run")
        or stats.get("passes")
        or 1
    )
    compute = scores * (SCORE_COST_S if score_cost_s is None else score_cost_s)
    io = reads * m * EDGE_IO_COST_S
    # Measured refill stall exists only when the ring driver ran refills
    # (refill_spans > 0); resident uploads report a structurally-zero wait
    # and keep the modeled transfer bill.
    if int(stats.get("refill_spans", 0) or 0) > 0 and "h2d_wait_s" in stats:
        h2d = float(stats["h2d_wait_s"])
    else:
        h2d = float(stats.get("h2d_bytes", 0)) / H2D_BW_BPS
    if int(stats.get("prefetch_depth", 0) or 0) > 0:
        return max(compute, io, h2d)
    return compute + io + h2d


def process_latency(
    g: PartitionedGraph,
    supersteps: int,
    msg_width: int,
    profile: ClusterProfile = PAPER_CLUSTER,
) -> dict:
    """Modeled processing latency (seconds) for `supersteps` rounds."""
    counts = g.replicas.cpu().numpy().sum(axis=1)
    n_replicas = int(counts.sum())
    sync_msgs = int(np.maximum(counts - 1, 0).sum()) * 2
    sync_bytes = sync_msgs * msg_width * 4
    edges_per = g.edges_per_partition
    # Partitions are distributed over the profile's nodes; a node's compute is
    # the sum of its partitions, the straggler is the max node.
    k = g.k
    per_node = np.add.reduceat(
        np.sort(edges_per)[::-1],
        np.arange(0, k, max(k // profile.nodes, 1)),
    )
    t_compute = float(per_node.max()) * msg_width * profile.edge_cost_s
    t_compute += n_replicas * profile.replica_cost_s
    t_sync = (sync_bytes / profile.nodes) / profile.link_bw_Bps + 2 * profile.rtt_s
    t_step = t_compute + t_sync
    return dict(
        profile=profile.name,
        supersteps=supersteps,
        t_step_s=t_step,
        t_total_s=t_step * supersteps,
        t_compute_s=t_compute,
        t_sync_s=t_sync,
        sync_bytes_per_step=sync_bytes,
        replication_degree=g.replication_degree,
    )
