"""ADWISE on torch — the port of the JAX package's ``repro.core``.

Public API of this slice:
  AdwiseConfig, PartitionResult, WarmState — configuration / result types
  partition_stream                         — ADWISE over one resident stream
  ref_adwise_partition                     — sequential Algorithm-1 oracle
  hash_partition, dbh_partition,
  grid_partition                           — stateless single-edge baselines
  hdrf_partition, greedy_partition         — single-edge baselines with state
                                             (numpy oracles; the registry runs
                                             their step-cores)
  run_partitioner, available_strategies    — strategy registry
  restream_partition, two_phase_partition,
  two_phase_linear_partition,
  warm_from_assignment                     — multi-pass re-streaming
                                             ('adwise-restream', '2ps', '2ps-l')
"""
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.core.adwise import partition_stream
from repro_torch.core.reference import ref_adwise_partition
from repro_torch.core.baselines import (
    dbh_partition,
    greedy_partition,
    grid_partition,
    hash_partition,
    hdrf_partition,
)
from repro_torch.core.registry import (
    available_strategies,
    get_partitioner,
    register,
    run_partitioner,
)
from repro_torch.core.restream import (
    restream_partition,
    two_phase_linear_partition,
    two_phase_partition,
    warm_from_assignment,
)

__all__ = [
    "AdwiseConfig",
    "PartitionResult",
    "WarmState",
    "partition_stream",
    "ref_adwise_partition",
    "hash_partition",
    "dbh_partition",
    "grid_partition",
    "hdrf_partition",
    "greedy_partition",
    "restream_partition",
    "two_phase_partition",
    "two_phase_linear_partition",
    "warm_from_assignment",
    "available_strategies",
    "get_partitioner",
    "register",
    "run_partitioner",
]
