"""ADWISE on torch — the port of the JAX package's ``repro.core``.

Public API of this slice:
  AdwiseConfig, PartitionResult, WarmState — configuration / result types
  partition_stream                         — ADWISE over one resident stream
  ref_adwise_partition                     — sequential Algorithm-1 oracle
  hash_partition, dbh_partition,
  grid_partition                           — stateless single-edge baselines
  run_partitioner, available_strategies    — strategy registry
"""
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.core.adwise import partition_stream
from repro_torch.core.reference import ref_adwise_partition
from repro_torch.core.baselines import dbh_partition, grid_partition, hash_partition
from repro_torch.core.registry import (
    available_strategies,
    get_partitioner,
    register,
    run_partitioner,
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
    "available_strategies",
    "get_partitioner",
    "register",
    "run_partitioner",
]
