"""ADWISE on torch — the port of the JAX package's ``repro.core``.

Public API:
  AdwiseConfig, PartitionResult, WarmState — configuration / result types
  partition_stream                         — ADWISE over one resident stream
  partition_stream_batched                 — z instance scans as ONE batched
                                             step (device-parallel spotlight
                                             loading)
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
  restream_partition_batched,
  two_phase_partition_batched              — the same over z batched instances
  spotlight_partition, spread_mask         — §III-D parallel loading
  partition_file                           — out-of-core: any strategy over
                                             a graph file, bounded edge memory
  FileSource, RingHandle                   — the file ring and its cross-pass
                                             hand-off (core.driver)
"""
from repro_torch.core.types import AdwiseConfig, PartitionResult, WarmState
from repro_torch.core.adwise import partition_stream, partition_stream_batched
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
    restream_partition_batched,
    two_phase_linear_partition,
    two_phase_partition,
    two_phase_partition_batched,
    warm_from_assignment,
)
from repro_torch.core.spotlight import spotlight_partition, spread_mask
from repro_torch.core.driver import FileSource, RingHandle
from repro_torch.core.oocore import partition_file

__all__ = [
    "AdwiseConfig",
    "PartitionResult",
    "WarmState",
    "partition_stream",
    "partition_stream_batched",
    "ref_adwise_partition",
    "hash_partition",
    "dbh_partition",
    "grid_partition",
    "hdrf_partition",
    "greedy_partition",
    "restream_partition",
    "restream_partition_batched",
    "two_phase_partition",
    "two_phase_partition_batched",
    "two_phase_linear_partition",
    "spotlight_partition",
    "spread_mask",
    "warm_from_assignment",
    "available_strategies",
    "get_partitioner",
    "register",
    "run_partitioner",
    "partition_file",
    "FileSource",
    "RingHandle",
]
