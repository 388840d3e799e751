"""Graph substrate of the port: synthetic generators and quality metrics."""
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
    replica_sets_from_assignment,
    replication_degree,
    sync_volume,
    unassigned_count,
)

__all__ = [
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
    "sync_volume",
    "unassigned_count",
]
