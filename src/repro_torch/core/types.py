"""Partitioner configuration, results and warm-start state.

Copied from the JAX package's ``core/types.py`` (numpy only), so both
packages read the same configuration and report results in the same shape.
The carry contract the driver relies on is the same too: a step-core's carry
exposes ``carry.cursor`` (next stream row) and ``carry.assigned`` (edges
placed so far) as int32 scalars; everything else is the strategy's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np

__all__ = ["AdwiseConfig", "PartitionResult", "WarmState"]


class WarmState(NamedTuple):
    """State carried between passes / phases of any step-core strategy.

    ``replicas``/``deg``/``sizes`` warm-start the vertex cache of the next
    pass; ``prev_assign`` (when given) enables buffered-re-streaming
    revocation: an edge's previous assignment is subtracted from the
    partition sizes at the moment the edge re-enters the window, so the
    balance terms always see the *net* partition loads while the pass
    re-places the stream. 2PS(-L) reuse ``replicas`` as the cluster→partition
    table: phase 1 leaves each clustered vertex with exactly one virtual
    replica on its cluster's partition.
    """

    replicas: np.ndarray  # (V, K) bool
    deg: np.ndarray  # (V,) int — full (or partial) streamed degrees
    sizes: np.ndarray  # (K,) int — partition loads at warm-start time
    prev_assign: Optional[np.ndarray] = None  # (m,) int32, -1 = none


@dataclasses.dataclass(frozen=True)
class AdwiseConfig:
    """Configuration of the ADWISE partitioner (paper §III defaults).

    Attributes:
      k: number of partitions.
      window_max: W_max — static capacity of the window buffer. The logical
        window size ``w`` adapts within [1, window_max].
      window_init: initial logical window size (paper: 1).
      latency_budget: latency preference L in seconds. None = no budget (the
        window grows while C1 holds).
      lam_init: initial adaptive balance weight λ (paper keeps λ ∈ [0.4, 5];
        the initial value is unspecified — we use 1.0).
      lam_lo / lam_hi: clip interval for λ (paper: [0.4, 5]).
      eps: ε used in B(p) denominator and the candidate threshold Θ = g_avg+ε.
      use_clustering: enable the clustering score CS (paper switches it off
        for low-clustering graphs such as Orkut).
      lazy: enable lazy window traversal (candidate/secondary sets).
      lazy_budget: max number of window slots rescored per step under lazy
        traversal (None = window_max // 8). Bounded staleness beyond the
        paper's candidate mechanism — see DESIGN.md §3.
      cap_slack: hard balance cap — partitions with more than
        cap_slack * m / k edges are masked out of the argmax. Guarantees the
        Eq. 2 constraint; set to None to rely purely on λ·B(p).
      assign_batch: number of vertex-disjoint assignments per scoring round.
        1 == paper-faithful sequential Algorithm 1. >1 is the beyond-paper
        SIMD batching documented in DESIGN.md.
      adapt: enable the adaptive window controller (C1/C2). When False the
        window stays at window_init.
      seed: tie-break seed.
    """

    k: int
    window_max: int = 256
    window_init: int = 1
    latency_budget: Optional[float] = None
    lam_init: float = 1.0
    lam_lo: float = 0.4
    lam_hi: float = 5.0
    eps: float = 0.01
    use_clustering: bool = True
    lazy: bool = True
    lazy_budget: Optional[int] = None
    cap_slack: Optional[float] = 1.15
    assign_batch: int = 1
    adapt: bool = True
    seed: int = 0

    def __post_init__(self) -> None:
        assert self.k >= 1
        assert 1 <= self.window_init <= self.window_max
        assert self.assign_batch >= 1

    # -- derived quantities (single source of truth for every scan caller;
    #    the streaming-scan driver in `repro_torch.core.driver` resolves through
    #    these instead of re-deriving per entry point) -----------------------

    def resolve_r_sel(self) -> int:
        """Lazy-traversal rescore budget R_sel: how many stale window slots
        are rescored per step (§III-B). Non-lazy mode rescores the whole
        window."""
        if not self.lazy:
            return self.window_max
        return min(
            self.window_max,
            max(
                self.assign_batch,
                self.lazy_budget or max(8, self.window_max // 8),
            ),
        )

    def cap_value(self, m: int, n_allowed: int) -> int:
        """Hard per-partition capacity (Eq. 2 guarantee) for an instance
        streaming ``m`` edges into ``n_allowed`` partitions; BIG when the
        cap is disabled."""
        if self.cap_slack is None:
            return int(np.iinfo(np.int32).max)
        return int(math.ceil(self.cap_slack * m / max(n_allowed, 1))) + 1


@dataclasses.dataclass
class PartitionResult:
    """Outcome of a partitioning run.

    Attributes:
      assign: int32[m] — partition id per edge, in the original stream order.
      stats: counters — score computations, window-size trace, final λ,
        wall-clock partitioning latency, and the driver's transfer counters
        (``h2d_rows``/``h2d_bytes``, ...) under the JAX package's key names,
        so ``engine.latency_model.partition_latency`` bills both alike.
    """

    assign: np.ndarray
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def k(self) -> int:
        return int(self.stats.get("k", self.assign.max() + 1))
