"""Graph substrate of the port: synthetic generators, quality metrics and
the edge stream."""
from repro_torch.graph.generate import (
    GRAPH_PRESETS,
    barabasi_albert,
    erdos_renyi,
    make_graph,
    rmat,
    watts_strogatz,
)
from repro_torch.graph.metrics import (
    partition_balance,
    partition_sizes,
    quality_from_chunks,
    replica_sets_from_assignment,
    replica_sets_from_chunks,
    replication_degree,
    sync_volume,
    unassigned_count,
)
from repro_torch.graph.stream import EdgeStream

__all__ = [
    "EdgeStream",
    "barabasi_albert",
    "erdos_renyi",
    "rmat",
    "watts_strogatz",
    "make_graph",
    "GRAPH_PRESETS",
    "replication_degree",
    "partition_balance",
    "partition_sizes",
    "replica_sets_from_assignment",
    "replica_sets_from_chunks",
    "quality_from_chunks",
    "sync_volume",
    "unassigned_count",
]
