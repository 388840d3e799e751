"""Fault-tolerant training loop wrapper — a copy of ``repro.runtime.fault``
(host-only Python and numpy).

At thousand-node scale the failure model is: a step either (a) raises on this
host (XLA error, NaN loss, collective timeout surfaced as an exception), or
(b) a peer disappears (surfaced by the coordinator — here simulated through
an injectable failure hook). The loop's contract:

  1. every step runs under a watchdog; classified failures increment a
     budget-limited retry counter,
  2. TRANSIENT failures (timeout, injected flake) retry the same step from
     live state,
  3. FATAL/TOPOLOGY failures restore the last checkpoint and, on topology
     change, ask `runtime.elastic.replan_after_failure` for a smaller mesh
     before resuming (the caller rebuilds the jitted step for the new mesh),
  4. NaN/inf loss restores the checkpoint and skips the offending data step.

The loop is deliberately framework-level (no framework internals): it is
exercised in tests with injected failures and used by `launch/train.py`.

The port's train step updates the parameters and the optimizer state **in
place**, so a step whose loss comes back NaN has already changed them:
recovery from it rests on `restore_fn` restoring every one of them (the
port's `CheckpointManager.restore` copies into the live tensors).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["StepFailure", "FaultTolerantLoop"]


class StepFailure(Exception):
    """A classified step failure. kind: 'transient' | 'fatal' | 'topology'."""

    def __init__(self, kind: str, msg: str = ""):
        super().__init__(f"[{kind}] {msg}")
        self.kind = kind


@dataclasses.dataclass
class LoopStats:
    steps_done: int = 0
    retries: int = 0
    restores: int = 0
    remesh_events: int = 0
    skipped_data_steps: int = 0


class FaultTolerantLoop:
    """Drives `step_fn(state, batch) -> (state, metrics)` with recovery.

    Args:
      step_fn: train step.
      save_fn: (step, state) -> None — checkpoint write.
      restore_fn: () -> (state, step) — restore latest checkpoint.
      remesh_fn: optional (lost_nodes) -> new step_fn after an elastic replan.
      ckpt_every: checkpoint cadence in steps.
      max_retries: transient-retry budget per step.
    """

    def __init__(
        self,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        remesh_fn: Optional[Callable] = None,
        ckpt_every: int = 50,
        max_retries: int = 3,
        failure_hook: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.remesh_fn = remesh_fn
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.failure_hook = failure_hook  # (step) -> None; may raise StepFailure
        self.stats = LoopStats()

    def run(self, state: Any, batches: Callable, start_step: int, num_steps: int):
        """batches: step -> batch. Returns (state, metrics_history)."""
        history = []
        step = start_step
        while step < start_step + num_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                t0 = time.perf_counter()
                state_new, metrics = self.step_fn(state, batches(step))
                loss = float(metrics.get("loss", 0.0))
                if not np.isfinite(loss):
                    raise StepFailure("nan", f"loss={loss} at step {step}")
                state = state_new
                metrics = dict(metrics)
                metrics["step_time_s"] = time.perf_counter() - t0
                history.append((step, metrics))
                self.stats.steps_done += 1
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except StepFailure as e:
                if e.kind == "transient" and self.stats.retries < self.max_retries:
                    self.stats.retries += 1
                    continue  # retry same step, live state
                if e.kind == "topology" and self.remesh_fn is not None:
                    self.stats.remesh_events += 1
                    self.step_fn = self.remesh_fn(e)
                state, step = self.restore_fn()
                self.stats.restores += 1
                if e.kind == "nan":
                    self.stats.skipped_data_steps += 1
                    step += 1  # skip the poisoned batch
        self.save_fn(step, state)
        return state, history
