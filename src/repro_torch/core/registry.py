"""Partitioner strategy registry of the port.

Every strategy is registered under the JAX package's uniform signature:

    fn(edges, num_vertices, k, seed=0, **cfg) -> PartitionResult

with the same errors: an unknown ``**cfg`` key raises ``TypeError``, an
unknown name raises ``KeyError`` listing the available names. This slice
registers ``adwise`` (the torch scan; ``oracle=True`` runs the copied
sequential Algorithm-1 reference) and the stateless ``hash``, ``dbh`` and
``grid``. HDRF, Greedy, 2PS(-L) and ``adwise-restream`` are the next slices
(ROADMAP.md, port queue 1).

``device=`` (``"cuda"`` by default, see
:func:`repro_torch.compat.resolve_device`) is resolved for every strategy,
so asking for a missing card raises whichever strategy is named; the
stateless hashes then compute on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch import compat
from repro_torch.core import baselines
from repro_torch.core.adwise import partition_stream
from repro_torch.core.reference import ref_adwise_partition
from repro_torch.core.types import AdwiseConfig, PartitionResult

__all__ = [
    "register",
    "get_partitioner",
    "run_partitioner",
    "available_strategies",
    "PartitionerFn",
]

PartitionerFn = Callable[..., PartitionResult]

_REGISTRY: Dict[str, PartitionerFn] = {}


def register(name: str) -> Callable[[PartitionerFn], PartitionerFn]:
    """Decorator: register ``fn`` as strategy ``name``."""

    def deco(fn: PartitionerFn) -> PartitionerFn:
        if name in _REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)


def get_partitioner(name: str) -> PartitionerFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown partitioner strategy {name!r}; "
            f"available: {', '.join(available_strategies())}"
        ) from None


def run_partitioner(
    name: str,
    edges: np.ndarray,
    num_vertices: int,
    k: int,
    seed: int = 0,
    *,
    device=None,
    **cfg,
) -> PartitionResult:
    """Resolve ``name`` and run it under the uniform signature on ``device``."""
    fn = get_partitioner(name)
    return fn(edges, num_vertices, k, seed=seed,
              device=compat.resolve_device(device), **cfg)


_ADWISE_FIELDS = {f.name for f in dataclasses.fields(AdwiseConfig)}


@register("adwise")
def _adwise(
    edges, num_vertices, k, seed=0, *, device=None, oracle=False, allowed=None,
    cost_per_score=None, **cfg,
) -> PartitionResult:
    """ADWISE (paper §III). cfg keys = AdwiseConfig fields; oracle=True runs
    the sequential Algorithm-1 reference on the host instead of the scan;
    allowed= restricts scoring to a partition subset; cost_per_score= pins
    the latency model."""
    unknown = set(cfg) - _ADWISE_FIELDS
    if unknown:
        raise TypeError(f"adwise: unknown config keys {sorted(unknown)}")
    acfg = AdwiseConfig(k=k, seed=seed, **cfg)
    if oracle:
        if allowed is not None:
            raise ValueError("adwise oracle does not support allowed= masks")
        return ref_adwise_partition(edges, num_vertices, acfg, cost_per_score)
    return partition_stream(
        edges, num_vertices, acfg, allowed=allowed,
        cost_per_score=cost_per_score, device=device,
    )


@register("dbh")
def _dbh(edges, num_vertices, k, seed=0, *, device=None, **cfg) -> PartitionResult:
    return baselines.dbh_partition(edges, num_vertices, k, seed=seed, **cfg)


@register("hash")
def _hash(edges, num_vertices, k, seed=0, *, device=None, **cfg) -> PartitionResult:
    return baselines.hash_partition(edges, num_vertices, k, seed=seed, **cfg)


@register("grid")
def _grid(edges, num_vertices, k, seed=0, *, device=None, **cfg) -> PartitionResult:
    return baselines.grid_partition(edges, num_vertices, k, seed=seed, **cfg)
