"""The streaming-scan driver of the port: resident streams, z instances.

Port of the resident half of the JAX package's ``core/driver.py``
(``StepCore``, ``AdwiseCore``, ``ResidentSource``, ``ScanDriver``). The
chunk arithmetic is the JAX driver's: ``steps_total = ceil(m_max/b) +
ceil(W/b) + 2`` steps, sized by the longest instance (shorter ones idle),
split into ``n_chunks`` scan calls of ``chunk_steps`` steps, then drain
calls while any instance has edges left — so ``w_trace``, ``scan_calls`` and
``score_rows`` come out equal to the JAX package's. The stats use the JAX
package's key names.

The driver holds z instances (spotlight's parallel partitioner instances)
as one carry with a leading instance axis: per-instance carries are built
by the core and stacked (:func:`repro_torch.core.adwise.stack_instances`),
then ``StepCore.seed_instances`` derives per-instance state from the
caller's global instance ids. One scan call is ``chunk_steps`` in-place
steps of all z instances (:mod:`repro_torch.core.adwise`). On the CPU it is
a plain loop. On the card the step is captured into a
``torch.cuda.CUDAGraph`` holding ``STEPS_PER_GRAPH`` steps (plus a one-step
graph for the remainder), and a scan call is a run of replays: the Python
per-op dispatch of an eager loop would cost hundreds of microseconds a
step. Capture happens at the first scan call, after a warm-up on a scratch
copy of the carry, so the captured run starts from the carry the driver
was given. The host syncs once per extra (drain) call, to read
``assigned``, as the JAX driver does; on a latency budget without a pinned
``cost_per_score`` it also syncs to read the wall clock.

Every resident pass ships a ``(z, per)`` int32 prior-assignment table beside
the stream, all -1 on a cold pass, and the step always runs the revocation
gather over it, as the JAX driver does, so ``h2d_rows``/``h2d_bytes`` are the
JAX package's: ``z·per·8 + z·per·4`` bytes, or ``z·per·4`` alone when a
:class:`StreamResidency` already holds the stream on the device. A
``warm=`` driver builds its carry from ``StepCore.warm_carry`` and never
calls ``init_carry``.

``trace=`` (a :class:`repro_torch.obs.Tracer`) records the JAX resident
path's spans: one ``scan-call`` span (category ``scan``) per scan call,
with ``call``, ``steps``, ``mode`` (``dispatch`` in the provisioned loop,
``drain`` after it) and ``compiled`` (true on the call that captured the
CUDA graphs), and one ``materialize`` span (category ``host``) around the
one copy of the outputs to the host. The spans are host-side: they add no
synchronisation, so on the card a ``dispatch`` span times the enqueueing of
graph replays, not their run.

File-ring sources (out-of-core) are a later slice (ROADMAP.md, port queue
1, item 10), and so is placing instances on several cards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.adwise import (
    Carry,
    StepOut,
    _init_carry,
    _make_step,
    stack_instances,
)
from repro_torch.core.types import AdwiseConfig, WarmState
from repro_torch.kernels import ops
from repro_torch.obs import resolve_tracer

__all__ = [
    "StepCore",
    "AdwiseCore",
    "ResidentSource",
    "StreamResidency",
    "ScanDriver",
    "DriveResult",
    "resolve_backend",
]

# Steps captured in one CUDA graph; a scan call replays it chunk_steps // 32
# times, then a one-step graph for the remainder.
STEPS_PER_GRAPH = 32


def resolve_backend(backend: str, z: int) -> tuple[str, int]:
    """(effective backend, n_shards), as the JAX package's
    ``resolve_backend`` resolves it on one device: 'auto', 'vmap' and
    'shard_map' all run the one batched step, ``('vmap', 0)``. Instances
    are not placed on several cards in this port."""
    if backend not in ("auto", "vmap", "shard_map"):
        raise ValueError(
            f"backend must be 'auto', 'vmap' or 'shard_map', got {backend!r}"
        )
    return "vmap", 0


class StepCore:
    """Base class for streaming-strategy step-cores.

    A core is a frozen dataclass of hashable scalars; all per-run state
    lives in the carry. ``init_carry`` / ``warm_carry`` build ONE
    instance's carry; the driver stacks z of them on a leading instance axis
    and hands the stack to ``seed_instances``. ``make_step`` gets the z
    instances' stream (z, per, 2), ``m_real`` (z,), ``allowed`` (z, K),
    ``cap`` (z,) and prior assignments (z, per), and returns an in-place
    ``step(carry, out) -> None`` over all z that issues no host sync.
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

    def warm_carry(self, budget: float, warm: WarmState, device: torch.device) -> Any:
        raise NotImplementedError(f"{self.name} does not support warm starts")

    def cap_value(self, m: int, n_allowed: int) -> int:
        return int(np.iinfo(np.int32).max)

    def seed_instances(self, carry: Any, z: int, ids: np.ndarray) -> Any:
        """Derive per-instance state after batching (default: none).

        ``ids`` are the caller's *global* instance indices for the z batch
        positions. Seed-deriving cores key on ``ids`` — never on the batch
        position — so length-bucketed batching, which permutes instances
        into sub-batches, reproduces the unbucketed streams exactly.
        """
        return carry

    def set_cost(self, carry: Any, cost_per_score: float) -> None:
        raise ValueError(f"{self.name} core does not model per-score cost")

    def recalibrate(self, carry: Any, t0: float) -> None:
        """Between-chunks budget recalibration (no-op unless has_budget)."""

    def counters(self, carry: Any) -> dict:
        """Final per-instance counters (each (z,)); by default those of a
        single-edge core: one score row per assigned edge, window 1, and
        the core's λ weight where it has one (HDRF, 2PS-L), else 0."""
        assigned = carry.assigned.cpu().numpy().astype(np.int64)
        z = assigned.shape[0]
        return dict(
            score_rows=assigned,
            final_w=np.ones((z,), np.int64),
            lam=np.full((z,), getattr(self, "lam", 0.0), np.float32),
            cost_per_score=np.zeros((z,), np.float32),
        )


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

    def warm_carry(self, budget: float, warm: WarmState, device: torch.device) -> Carry:
        return Carry.warm_start(
            self.cfg, self.num_vertices, budget, device=device,
            replicas=warm.replicas, deg=warm.deg, sizes=warm.sizes,
        )

    def set_cost(self, carry: Any, cost_per_score: float) -> None:
        carry.cost_per_score.fill_(cost_per_score)

    def recalibrate(self, carry: Any, t0: float) -> None:
        budget = self.cfg.latency_budget
        assert budget is not None  # only called when has_budget
        # One step runs every instance, so the shared per-row cost comes
        # from the batched wall over the total row count.
        # staticcheck: disable=SC003 budget recalibration MEASURES wall clock — the sync is the measurement (§III-B latency budget)
        rows = max(int(carry.score_rows.sum()), 1)
        wall = time.perf_counter() - t0
        carry.cost_per_score.fill_(wall / (rows * self.cfg.k))
        carry.budget_left.fill_(budget - wall)

    def counters(self, carry: Any) -> dict:
        return dict(
            score_rows=carry.score_rows.cpu().numpy().astype(np.int64),
            final_w=carry.w_cap.cpu().numpy().astype(np.int64),
            lam=carry.lam.cpu().numpy(),
            cost_per_score=carry.cost_per_score.cpu().numpy(),
        )


class StreamResidency:
    """Cross-pass device residency for resident sources.

    A re-streaming caller creates one holder and passes it to every pass:
    pass p publishes its uploaded device stream here and pass p+1 reuses it,
    shipping only its new prev table. Residency is keyed by the stream's
    shape, as in the JAX package. Caller contract: every pass streams the
    SAME edges — only the shape is cheap to verify, so a holder is never
    shared across different streams.
    """

    __slots__ = ("_by_shape",)

    def __init__(self) -> None:
        self._by_shape: dict[Tuple[int, ...], torch.Tensor] = {}

    def publish(self, streams: torch.Tensor, shape: Tuple[int, ...]) -> None:
        self._by_shape[tuple(shape)] = streams

    def lookup(self, shape: Tuple[int, ...]) -> Optional[torch.Tensor]:
        return self._by_shape.get(tuple(shape))


class ResidentSource:
    """Whole stream resident on the device: ONE upload for the entire run.

    ``streams`` is (z, per, 2) int32, one padded row per instance;
    ``m_per[i]`` is instance i's real stream length. ``residency`` lets
    re-streaming passes over the same streams reuse the previous pass's
    device array.
    """

    resident = True

    def __init__(
        self,
        streams: np.ndarray,
        m_per: np.ndarray,
        *,
        residency: Optional[StreamResidency] = None,
    ) -> None:
        streams = np.ascontiguousarray(streams, np.int32)
        if streams.ndim != 3 or streams.shape[2] != 2:
            raise ValueError(f"streams must be (z, per, 2), got {streams.shape}")
        self.z, self.per = int(streams.shape[0]), int(streams.shape[1])
        if self.z < 1:
            raise ValueError("streams must hold at least one instance")
        self.m_per = np.asarray(m_per, np.int64)
        if self.m_per.shape != (self.z,) or (self.m_per > self.per).any():
            raise ValueError(f"m_per {self.m_per} does not fit streams {streams.shape}")
        self.streams = streams
        self.residency = residency

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
    backend: str
    n_shards: int
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
    """Chunked stepping loop over a resident stream of z instances, on one
    device."""

    def __init__(
        self,
        source: ResidentSource,
        core: Any,  # a StepCore, or an AdwiseConfig (wraps AdwiseCore)
        num_vertices: Optional[int] = None,
        *,
        allowed: Optional[np.ndarray] = None,  # (z, k) bool
        warm: Optional[Sequence[WarmState]] = None,  # one per instance
        cost_per_score: Optional[float] = None,
        backend: str = "vmap",
        trace=None,
        instance_ids: Optional[np.ndarray] = None,  # (z,) global instance ids
        device=None,
    ) -> None:
        self.device = compat.resolve_device(device)
        self.trace = resolve_tracer(trace)
        if isinstance(core, AdwiseConfig):
            if num_vertices is None:
                raise ValueError("an AdwiseConfig core needs num_vertices")
            self.cfg: Optional[AdwiseConfig] = core
            core = AdwiseCore(cfg=core, num_vertices=num_vertices,
                              update_deg=warm is None)
        else:
            self.cfg = getattr(core, "cfg", None)
        self.source = source
        self.core = core
        self.num_vertices = num_vertices
        z, k = source.z, core.k
        self.z = z
        self.m_per = source.m_per
        self.r_sel = core.r_sel
        self.backend, self.n_shards = resolve_backend(backend, z)
        if allowed is None:
            allowed_np = np.ones((z, k), bool)
        else:
            allowed_np = np.asarray(allowed, bool)
            if allowed_np.shape != (z, k):
                raise ValueError(f"allowed must be {(z, k)}, got {allowed_np.shape}")
        caps = np.array(
            [core.cap_value(int(self.m_per[i]), max(int(allowed_np[i].sum()), 1))
             for i in range(z)],
            np.int32,
        )
        self.has_budget = bool(core.has_budget)
        budget = (self.cfg.latency_budget or 0.0) if self.has_budget and self.cfg else 0.0
        dev = self.device
        self.warm = warm is not None
        # The prior-assignment table every resident pass ships: -1 = none.
        self._prev_np = np.full((z, source.per), -1, np.int32)
        if warm is None:
            carry = stack_instances([core.init_carry(budget, dev)] * z)
        else:
            if len(warm) != z:
                raise ValueError(f"need one WarmState per instance, got {len(warm)}")
            has_prev = [w.prev_assign is not None for w in warm]
            if any(has_prev) and not all(has_prev):
                raise ValueError(
                    "all instances must agree on whether prev_assign is provided")
            for i, w in enumerate(warm):
                if w.prev_assign is None:
                    continue
                pa = np.asarray(w.prev_assign, np.int32)
                if pa.shape != (int(self.m_per[i]),):
                    raise ValueError(
                        f"instance {i}: prev_assign must align with its stream: "
                        f"{pa.shape} vs ({int(self.m_per[i])},)"
                    )
                self._prev_np[i, : len(pa)] = pa
            carry = stack_instances([core.warm_carry(budget, w, dev) for w in warm])
        ids = np.arange(z) if instance_ids is None else np.asarray(instance_ids)
        if ids.shape != (z,):
            raise ValueError(f"instance_ids must be ({z},), got {ids.shape}")
        carry = core.seed_instances(carry, z, ids)
        self.fixed_cost = cost_per_score is not None
        if cost_per_score is not None:
            core.set_cost(carry, cost_per_score)
        self.carry = carry
        self._m_real = torch.as_tensor(self.m_per.astype(np.int32), device=dev)
        self._allowed = torch.as_tensor(allowed_np, device=dev)
        self._caps = torch.as_tensor(caps, device=dev)
        self.steps_per_graph = STEPS_PER_GRAPH if dev.type == "cuda" else 0

    def _recalibrate(self, carry: Any, t0: float) -> None:
        if self.has_budget and not self.fixed_cost:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.core.recalibrate(carry, t0)

    def _run_resident(self, n_chunks: int) -> DriveResult:
        src, core, dev, z = self.source, self.core, self.device, self.z
        b = core.rows_per_step
        m_max = int(self.m_per.max())
        # Provisioned by the longest instance (shorter ones idle); the drain
        # covers top-b pick stalls.
        steps_total = -(-m_max // b) + -(-core.window_rows // b) + 2
        n_chunks = max(1, min(n_chunks, steps_total))
        chunk_steps = -(-steps_total // n_chunks)
        n_chunks = -(-steps_total // chunk_steps)

        t0 = time.perf_counter()
        residency = src.residency
        stream = residency.lookup(src.streams.shape) if residency is not None else None
        if stream is not None:
            # The previous pass left the stream on the device: only the new
            # prev table ships.
            h2d_rows = 0
            h2d_bytes = self._prev_np.size * 4
        else:
            stream = torch.as_tensor(src.streams, device=dev)
            h2d_rows = src.upload_rows
            h2d_bytes = src.upload_rows * 8 + self._prev_np.size * 4
        if residency is not None:
            residency.publish(stream, src.streams.shape)
        prev = torch.as_tensor(self._prev_np, device=dev)
        step = core.make_step(stream, self._m_real, self._allowed, self._caps, prev)
        carry = self.carry
        out = StepOut.empty(chunk_steps, z, b, dev)
        if dev.type == "cuda":
            run_chunk = _GraphStepper(step, carry, out, chunk_steps, self.steps_per_graph)
        else:
            run_chunk = _LoopStepper(step, carry, out, chunk_steps)
        setup_s = time.perf_counter() - t0

        trace = self.trace
        traced = trace.enabled
        outs = []
        calls = 0
        for _ in range(n_chunks):
            if traced:
                t_call = time.perf_counter()
            captured = run_chunk()
            calls += 1
            # Device-side copies only: the transfer to the host happens
            # once, after the stepping loop.
            outs.append(_snapshot(out))
            if traced:
                trace.add_span(
                    "scan-call", "scan", t_call, time.perf_counter(),
                    attrs=dict(call=calls, steps=chunk_steps, mode="dispatch",
                               compiled=captured),
                )
            self._recalibrate(carry, t0)
        drain_left = -(-m_max // chunk_steps) + 2
        # staticcheck: disable=SC003 drain termination must observe `assigned`; one sync per extra call, none in the provisioned loop
        while bool((carry.assigned < self._m_real).any()) and drain_left > 0:
            if traced:
                t_call = time.perf_counter()
            run_chunk()
            calls += 1
            outs.append(_snapshot(out))
            if traced:
                trace.add_span(
                    "scan-call", "scan", t_call, time.perf_counter(),
                    attrs=dict(call=calls, steps=chunk_steps, mode="drain"),
                )
            drain_left -= 1
        if traced:
            t_mat = time.perf_counter()
        # (calls·T, z, b) -> (z, calls·T·b), and (calls·T, z) -> (z, calls·T).
        sidx = torch.cat([o[0] for o in outs]).transpose(0, 1).cpu().numpy().reshape(z, -1)
        pout = torch.cat([o[1] for o in outs]).transpose(0, 1).cpu().numpy().reshape(z, -1)
        w_trace = torch.cat([o[2] for o in outs]).transpose(0, 1).cpu().numpy()
        if traced:
            trace.add_span("materialize", "host", t_mat, time.perf_counter(),
                           attrs=dict(calls=calls))
        wall = time.perf_counter() - t0
        cnt = core.counters(carry)
        return DriveResult(
            sidx=sidx,
            p=pout,
            w_trace=w_trace,
            assigned=carry.assigned.cpu().numpy(),
            score_rows=cnt["score_rows"],
            final_w=cnt["final_w"],
            lam=cnt["lam"],
            cost_per_score=cnt["cost_per_score"],
            wall_time_s=wall,
            r_sel=self.r_sel,
            backend=self.backend,
            n_shards=self.n_shards,
            scan_calls=calls,
            steps_run=calls * chunk_steps,
            warmup_steps=run_chunk.warmup_steps,
            setup_s=setup_s + run_chunk.capture_s,
            h2d_rows=int(h2d_rows),
            h2d_bytes=int(h2d_bytes),
            buffer_rows=src.per,
            scan_steps_per_call=chunk_steps,
            steps_per_graph=self.steps_per_graph,
        )

    def run(self, *, n_chunks: int = 8) -> DriveResult:
        """Drive the scan to completion over the resident streams."""
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
            warm=self.warm,
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
    """One scan call on the CPU: ``n_steps`` eager steps. Returns False (it
    captures nothing)."""

    warmup_steps = 0
    capture_s = 0.0

    def __init__(self, step, carry, out: StepOut, n_steps: int) -> None:
        self.step, self.carry, self.out, self.n_steps = step, carry, out, n_steps

    def __call__(self) -> bool:
        self.out.t.zero_()
        for _ in range(self.n_steps):
            self.step(self.carry, self.out)
        return False


class _GraphStepper:
    """One scan call on the card: replays of captured CUDA graphs.

    ``steps_per_graph`` steps are captured into one graph and the remainder
    of ``n_steps`` into a one-step graph, at the first call (which then
    returns True; ``capture_s`` is its capture time). Before capture the
    step runs ``warmup_steps`` times on a scratch copy of the carry (on a
    side stream), so torch's and the kernels' lazy initialisation happens
    outside the capture and the real carry is untouched. Kernel launches
    recorded at capture are credited to the kernels' launch counters once
    per replay.
    """

    warmup_steps = 2

    def __init__(self, step, carry, out: StepOut, n_steps: int,
                 steps_per_graph: int) -> None:
        self.step, self.carry, self.out = step, carry, out
        self.g_steps = min(steps_per_graph, n_steps)
        self.n_big, self.n_small = divmod(n_steps, self.g_steps)
        self.big = None
        self.capture_s = 0.0

    def _capture_all(self) -> None:
        t0 = time.perf_counter()
        step, carry, out = self.step, self.carry, self.out
        scratch = carry.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup_steps):
                step(scratch, out)
        torch.cuda.current_stream().wait_stream(side)
        out.t.zero_()
        self.big, self.big_counts = self._capture(step, carry, out, self.g_steps)
        self.small, self.small_counts = (
            self._capture(step, carry, out, 1) if self.n_small else (None, {})
        )
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    @staticmethod
    def _capture(step, carry, out, n):
        before = ops.captured_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                step(carry, out)
        after = ops.captured_counts()
        return graph, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def __call__(self) -> bool:
        captured = self.big is None
        if captured:
            self._capture_all()
        self.out.t.zero_()
        for _ in range(self.n_big):
            self.big.replay()
        for _ in range(self.n_small):
            self.small.replay()
        ops.credit_replays(self.big_counts, self.n_big)
        ops.credit_replays(self.small_counts, self.n_small)
        return captured
