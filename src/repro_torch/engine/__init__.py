"""Vertex-cut graph processing engine of the port (one device)."""
from repro_torch.engine.partitioned import PartitionedGraph, build_partitioned_graph
from repro_torch.engine.gas import make_superstep
from repro_torch.engine.algorithms import (
    coloring,
    label_propagation,
    pagerank,
    triangle_count,
)
from repro_torch.engine.latency_model import (
    PAPER_CLUSTER,
    TPU_POD,
    ClusterProfile,
    partition_latency,
    process_latency,
)

__all__ = [
    "PartitionedGraph",
    "build_partitioned_graph",
    "make_superstep",
    "pagerank",
    "label_propagation",
    "coloring",
    "triangle_count",
    "ClusterProfile",
    "PAPER_CLUSTER",
    "TPU_POD",
    "partition_latency",
    "process_latency",
]
