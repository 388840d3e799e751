"""Straggler detection and mitigation — a copy of
``repro.runtime.straggler`` (host-only Python and numpy).

Per-step wall times are tracked as an EMA (mean + variance); a step slower
than mean + `sigma`·std AND `ratio`× the mean flags a straggler event. The
mitigation policy at scale:

  1. persistent straggler host → rebalance: shift one gradient-accumulation
     microbatch from the slow host to the fastest (returned as a new
     microbatch allocation vector),
  2. chronic (≥ `evict_after` flags) → recommend eviction, which the caller
     turns into an elastic re-mesh (runtime.elastic).

On a single-host container the monitor sees per-step times only; the
allocation logic is exercised in tests with synthetic timing traces.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerDecision:
    flagged_host: Optional[int]
    evict: bool
    microbatch_alloc: np.ndarray  # (hosts,) microbatches per host


class StragglerMonitor:
    def __init__(
        self,
        hosts: int,
        microbatches_per_host: int = 1,
        sigma: float = 3.0,
        ratio: float = 1.3,
        evict_after: int = 5,
        alpha: float = 0.1,
    ):
        self.hosts = hosts
        self.sigma, self.ratio, self.evict_after, self.alpha = (
            sigma, ratio, evict_after, alpha,
        )
        self.alloc = np.full(hosts, microbatches_per_host, np.int64)
        self.mean = np.zeros(hosts)
        self.var = np.zeros(hosts)
        self.flags = np.zeros(hosts, np.int64)
        self.n = 0

    def observe(self, per_host_step_s: np.ndarray) -> StragglerDecision:
        """Feed one step's per-host wall times; get the mitigation decision."""
        t = np.asarray(per_host_step_s, float)
        # Normalize by workload (time per microbatch) so rebalanced hosts are
        # judged fairly.
        t = t / np.maximum(self.alloc, 1)
        if self.n == 0:
            self.mean, self.var = t.copy(), np.zeros_like(t)
        else:
            d = t - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        fleet_mean = float(self.mean.mean())
        std = float(np.sqrt(self.var.mean()) + 1e-12)
        slow = (self.mean > fleet_mean + self.sigma * std) & (
            self.mean > self.ratio * fleet_mean
        )
        flagged = int(np.argmax(self.mean)) if slow.any() else None
        evict = False
        if flagged is not None:
            self.flags[flagged] += 1
            evict = bool(self.flags[flagged] >= self.evict_after)
            fastest = int(np.argmin(self.mean + (self.alloc == 0) * 1e9))
            if self.alloc[flagged] > 1 and fastest != flagged:
                self.alloc[flagged] -= 1
                self.alloc[fastest] += 1
        return StragglerDecision(flagged, evict, self.alloc.copy())
