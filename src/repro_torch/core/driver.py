"""The streaming-scan driver of the port: resident streams, one instance.

Port of the resident half of the JAX package's ``core/driver.py``
(``StepCore``, ``AdwiseCore``, ``ResidentSource``, ``ScanDriver``) at z = 1.
The chunk arithmetic is the JAX driver's: ``steps_total = ceil(m/b) +
ceil(W/b) + 2`` steps split into ``n_chunks`` scan calls of ``chunk_steps``
steps, then drain calls while edges remain — so ``w_trace``, ``scan_calls``
and ``score_rows`` come out equal to the JAX package's. The stats use the
JAX package's key names.

One scan call is ``chunk_steps`` in-place steps (:mod:`repro_torch.core.
adwise`). On the CPU it is a plain loop. On the card the step is captured
once into a ``torch.cuda.CUDAGraph`` holding ``STEPS_PER_GRAPH`` steps (plus
a one-step graph for the remainder), and a scan call is a run of replays:
the Python per-op dispatch of an eager loop would cost hundreds of
microseconds a step. Capture happens after a warm-up on a scratch copy of
the carry, so the captured run starts from the carry the driver was given.
The host syncs once per scan call, to read
``assigned`` for the drain, as the JAX driver does; on a latency budget
without a pinned ``cost_per_score`` it also syncs to read the wall clock.

File-ring sources, z > 1 (spotlight) and warm starts are later slices
(ROADMAP.md, port queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.adwise import Carry, StepOut, _init_carry, _make_step
from repro_torch.core.types import AdwiseConfig
from repro_torch.kernels import ops

__all__ = ["StepCore", "AdwiseCore", "ResidentSource", "ScanDriver", "DriveResult"]

# Steps captured in one CUDA graph; a scan call replays it chunk_steps // 32
# times, then a one-step graph for the remainder.
STEPS_PER_GRAPH = 32


class StepCore:
    """Base class for streaming-strategy step-cores.

    A core is a frozen dataclass of hashable scalars; all per-run state
    lives in the carry. ``make_step`` returns an in-place
    ``step(carry, out) -> None`` that issues no host sync.
    """

    name: str = "core"

    @property
    def window_rows(self) -> int:
        return 0

    @property
    def rows_per_step(self) -> int:
        return 1

    @property
    def r_sel(self) -> int:
        return 0

    @property
    def has_budget(self) -> bool:
        return False

    def make_step(
        self, stream: Any, m_real: Any, allowed: Any, cap: Any, prev_assign: Any
    ) -> Callable[[Any, Any], None]:
        raise NotImplementedError

    def init_carry(self, budget: float, device: torch.device) -> Any:
        raise NotImplementedError

    def cap_value(self, m: int, n_allowed: int) -> int:
        return int(np.iinfo(np.int32).max)

    def set_cost(self, carry: Any, cost_per_score: float) -> None:
        raise ValueError(f"{self.name} core does not model per-score cost")

    def recalibrate(self, carry: Any, t0: float) -> None:
        """Between-chunks budget recalibration (no-op unless has_budget)."""

    def counters(self, carry: Any) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AdwiseCore(StepCore):
    """ADWISE adaptive-window scan as a step-core (math in core/adwise.py)."""

    cfg: AdwiseConfig
    num_vertices: int
    update_deg: bool = True

    name = "adwise"

    @property
    def k(self) -> int:
        return self.cfg.k

    @property
    def window_rows(self) -> int:
        return self.cfg.window_max

    @property
    def rows_per_step(self) -> int:
        return self.cfg.assign_batch

    @property
    def r_sel(self) -> int:
        return self.cfg.resolve_r_sel()

    @property
    def has_budget(self) -> bool:
        return self.cfg.latency_budget is not None

    def cap_value(self, m: int, n_allowed: int) -> int:
        return self.cfg.cap_value(m, n_allowed)

    def make_step(
        self, stream: Any, m_real: Any, allowed: Any, cap: Any, prev_assign: Any
    ) -> Callable[[Any, Any], None]:
        return _make_step(
            self.cfg, self.num_vertices, self.r_sel, stream, m_real, allowed,
            cap, self.has_budget, prev_assign, self.update_deg,
        )

    def init_carry(self, budget: float, device: torch.device) -> Carry:
        return _init_carry(self.cfg, self.num_vertices, budget, device)

    def set_cost(self, carry: Any, cost_per_score: float) -> None:
        carry.cost_per_score.fill_(cost_per_score)

    def recalibrate(self, carry: Any, t0: float) -> None:
        budget = self.cfg.latency_budget
        assert budget is not None  # only called when has_budget
        # staticcheck: disable=SC003 budget recalibration MEASURES wall clock — the sync is the measurement (§III-B latency budget)
        rows = max(int(carry.score_rows), 1)
        wall = time.perf_counter() - t0
        carry.cost_per_score.fill_(wall / (rows * self.cfg.k))
        carry.budget_left.fill_(budget - wall)

    def counters(self, carry: Any) -> dict:
        return dict(
            score_rows=np.asarray([carry.score_rows.item()]),
            final_w=np.asarray([carry.w_cap.item()]),
            lam=np.asarray([carry.lam.item()], np.float32),
            cost_per_score=np.asarray([carry.cost_per_score.item()], np.float32),
        )


class ResidentSource:
    """Whole stream resident on the device: ONE upload for the entire run.

    ``streams`` is (z, per, 2) int32 with z = 1 in this slice; ``m_per[0]``
    is the real stream length.
    """

    resident = True

    def __init__(self, streams: np.ndarray, m_per: np.ndarray) -> None:
        streams = np.ascontiguousarray(streams, np.int32)
        if streams.ndim != 3 or streams.shape[2] != 2:
            raise ValueError(f"streams must be (z, per, 2), got {streams.shape}")
        self.z, self.per = int(streams.shape[0]), int(streams.shape[1])
        if self.z != 1:
            raise NotImplementedError(
                "repro_torch drives one instance (z = 1); batched spotlight "
                "instances are ROADMAP.md port queue 1, item 8"
            )
        self.m_per = np.asarray(m_per, np.int64)
        if self.m_per.shape != (self.z,) or (self.m_per > self.per).any():
            raise ValueError(f"m_per {self.m_per} does not fit streams {streams.shape}")
        self.streams = streams

    @property
    def upload_rows(self) -> int:
        return self.z * self.per


class DriveResult(NamedTuple):
    """Raw outcome of one driven scan; callers assemble their stats."""

    sidx: np.ndarray  # (z, T·b)
    p: np.ndarray  # (z, T·b)
    w_trace: np.ndarray  # (z, T)
    assigned: np.ndarray  # (z,)
    score_rows: np.ndarray  # (z,)
    final_w: np.ndarray  # (z,)
    lam: np.ndarray  # (z,) f32
    cost_per_score: np.ndarray  # (z,) f32
    wall_time_s: float
    r_sel: int
    scan_calls: int
    steps_run: int  # steps of the scan calls (chunk_steps per call)
    warmup_steps: int  # steps run once on a scratch carry before capture
    setup_s: float  # stream upload + step build + graph capture, in wall_time_s
    h2d_rows: int
    h2d_bytes: int
    buffer_rows: int
    scan_steps_per_call: int
    steps_per_graph: int  # 0 on the CPU (plain loop)


class ScanDriver:
    """Chunked stepping loop over a resident stream, on one device."""

    def __init__(
        self,
        source: ResidentSource,
        core: Any,  # a StepCore, or an AdwiseConfig (wraps AdwiseCore)
        num_vertices: Optional[int] = None,
        *,
        allowed: Optional[np.ndarray] = None,  # (z, k) bool
        cost_per_score: Optional[float] = None,
        device=None,
    ) -> None:
        self.device = compat.resolve_device(device)
        if isinstance(core, AdwiseConfig):
            if num_vertices is None:
                raise ValueError("an AdwiseConfig core needs num_vertices")
            self.cfg: Optional[AdwiseConfig] = core
            core = AdwiseCore(cfg=core, num_vertices=num_vertices)
        else:
            self.cfg = getattr(core, "cfg", None)
        self.source = source
        self.core = core
        self.num_vertices = num_vertices
        self.z, k = source.z, core.k
        self.m_per = source.m_per
        self.r_sel = core.r_sel
        if allowed is None:
            allowed_np = np.ones((self.z, k), bool)
        else:
            allowed_np = np.asarray(allowed, bool)
            if allowed_np.shape != (self.z, k):
                raise ValueError(f"allowed must be {(self.z, k)}, got {allowed_np.shape}")
        cap = core.cap_value(int(self.m_per[0]), max(int(allowed_np[0].sum()), 1))
        self.has_budget = bool(core.has_budget)
        budget = (self.cfg.latency_budget or 0.0) if self.has_budget and self.cfg else 0.0
        dev = self.device
        self.carry = core.init_carry(budget, dev)
        self.fixed_cost = cost_per_score is not None
        if cost_per_score is not None:
            core.set_cost(self.carry, cost_per_score)
        self._m_real = torch.tensor(int(self.m_per[0]), dtype=torch.int32, device=dev)
        self._allowed = torch.as_tensor(allowed_np[0], device=dev)
        self._cap = torch.tensor(cap, dtype=torch.int32, device=dev)
        self.steps_per_graph = STEPS_PER_GRAPH if dev.type == "cuda" else 0

    def _recalibrate(self, carry: Any, t0: float) -> None:
        if self.has_budget and not self.fixed_cost:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.core.recalibrate(carry, t0)

    def _run_resident(self, n_chunks: int) -> DriveResult:
        src, core, dev = self.source, self.core, self.device
        b = core.rows_per_step
        m_max = int(self.m_per.max())
        steps_total = -(-m_max // b) + -(-core.window_rows // b) + 2
        n_chunks = max(1, min(n_chunks, steps_total))
        chunk_steps = -(-steps_total // n_chunks)
        n_chunks = -(-steps_total // chunk_steps)

        t0 = time.perf_counter()
        stream = torch.as_tensor(src.streams[0], device=dev)
        h2d_rows = src.upload_rows
        h2d_bytes = src.upload_rows * 8  # the stream; a cold pass ships no prev table
        step = core.make_step(stream, self._m_real, self._allowed, self._cap, None)
        carry = self.carry
        out = StepOut.empty(chunk_steps, b, dev)
        if dev.type == "cuda":
            run_chunk = _GraphStepper(step, carry, out, chunk_steps, self.steps_per_graph)
        else:
            run_chunk = _LoopStepper(step, carry, out, chunk_steps)
        setup_s = time.perf_counter() - t0

        outs = []
        calls = 0
        for _ in range(n_chunks):
            run_chunk()
            calls += 1
            outs.append(_snapshot(out))
            self._recalibrate(carry, t0)
        drain_left = -(-m_max // chunk_steps) + 2
        # staticcheck: disable=SC003 drain termination must observe `assigned`; one sync per extra call, none in the provisioned loop
        while int(carry.assigned) < m_max and drain_left > 0:
            run_chunk()
            calls += 1
            outs.append(_snapshot(out))
            drain_left -= 1
        sidx = torch.cat([o[0] for o in outs]).cpu().numpy()
        pout = torch.cat([o[1] for o in outs]).cpu().numpy()
        w_trace = torch.cat([o[2] for o in outs]).cpu().numpy()
        wall = time.perf_counter() - t0
        cnt = core.counters(carry)
        return DriveResult(
            sidx=sidx.reshape(1, -1),
            p=pout.reshape(1, -1),
            w_trace=w_trace.reshape(1, -1),
            assigned=np.asarray([carry.assigned.item()]),
            score_rows=cnt["score_rows"],
            final_w=cnt["final_w"],
            lam=cnt["lam"],
            cost_per_score=cnt["cost_per_score"],
            wall_time_s=wall,
            r_sel=self.r_sel,
            scan_calls=calls,
            steps_run=calls * chunk_steps,
            warmup_steps=run_chunk.warmup_steps,
            setup_s=setup_s,
            h2d_rows=int(h2d_rows),
            h2d_bytes=int(h2d_bytes),
            buffer_rows=src.per,
            scan_steps_per_call=chunk_steps,
            steps_per_graph=self.steps_per_graph,
        )

    def run(self, *, n_chunks: int = 8) -> DriveResult:
        """Drive the scan to completion over the resident stream."""
        return self._run_resident(n_chunks)

    def stats_base(self, res: DriveResult, instance: int) -> dict:
        """The JAX driver's per-instance stat fields (resident mode), plus
        the port's ``steps_run``, ``warmup_steps``, ``setup_s``,
        ``steps_per_graph`` and ``device``."""
        return dict(
            k=self.core.k,
            name=self.core.name,
            wall_time_s=res.wall_time_s,
            score_rows=int(res.score_rows[instance]),
            score_count=int(res.score_rows[instance]) * self.core.k,
            final_w=int(res.final_w[instance]),
            lam_final=float(res.lam[instance]),
            assigned=int(res.assigned[instance]),
            warm=False,
            r_sel=res.r_sel,
            modeled_cost_per_score=float(res.cost_per_score[instance]),
            scan_calls=res.scan_calls,
            h2d_rows=res.h2d_rows,
            h2d_bytes=res.h2d_bytes,
            buffer_rows=res.buffer_rows,
            scan_steps_per_call=res.scan_steps_per_call,
            h2d_wait_s=0.0,
            prefetch_depth=0,
            refill_spans=0,
            spans_prestaged=0,
            spans_missed=0,
            prestage_wall_s=0.0,
            steps_run=res.steps_run,
            warmup_steps=res.warmup_steps,
            setup_s=res.setup_s,
            steps_per_graph=res.steps_per_graph,
            device=str(self.device),
        )


def _snapshot(out: StepOut) -> tuple:
    """Device-side copies of one scan call's outputs (no host sync)."""
    return out.sidx.clone(), out.p.clone(), out.w_cap.clone()


class _LoopStepper:
    """One scan call on the CPU: ``n_steps`` eager steps."""

    warmup_steps = 0

    def __init__(self, step, carry: Carry, out: StepOut, n_steps: int) -> None:
        self.step, self.carry, self.out, self.n_steps = step, carry, out, n_steps

    def __call__(self) -> None:
        self.out.t.zero_()
        for _ in range(self.n_steps):
            self.step(self.carry, self.out)


class _GraphStepper:
    """One scan call on the card: replays of captured CUDA graphs.

    ``steps_per_graph`` steps are captured into one graph and the remainder
    of ``n_steps`` into a one-step graph. Before capture the step runs
    ``warmup_steps`` times on a scratch copy of the carry (on a side
    stream), so torch's and the kernels' lazy initialisation happens
    outside the capture and the real carry is untouched. Kernel launches
    recorded at capture are credited to the kernels' launch counters once
    per replay.
    """

    warmup_steps = 2

    def __init__(self, step, carry: Carry, out: StepOut, n_steps: int,
                 steps_per_graph: int) -> None:
        self.out = out
        g_steps = min(steps_per_graph, n_steps)
        self.n_big, self.n_small = divmod(n_steps, g_steps)
        scratch = carry.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup_steps):
                step(scratch, out)
        torch.cuda.current_stream().wait_stream(side)
        out.t.zero_()
        self.big, self.big_counts = self._capture(step, carry, out, g_steps)
        self.small, self.small_counts = (
            self._capture(step, carry, out, 1) if self.n_small else (None, {})
        )
        torch.cuda.synchronize()

    @staticmethod
    def _capture(step, carry, out, n):
        before = ops.captured_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                step(carry, out)
        after = ops.captured_counts()
        return graph, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def __call__(self) -> None:
        self.out.t.zero_()
        for _ in range(self.n_big):
            self.big.replay()
        for _ in range(self.n_small):
            self.small.replay()
        ops.credit_replays(self.big_counts, self.n_big)
        ops.credit_replays(self.small_counts, self.n_small)
