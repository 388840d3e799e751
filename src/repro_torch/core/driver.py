"""The streaming-scan driver of the port: resident streams and file rings,
z instances.

Port of the JAX package's ``core/driver.py`` (``StepCore``, ``AdwiseCore``,
``ResidentSource``, ``FileSource``, ``ScanDriver``). The resident chunk
arithmetic is the JAX driver's: ``steps_total = ceil(m_max/b) +
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

File sources (out-of-core)
--------------------------
:class:`FileSource` is the JAX package's device-resident ring over
per-instance stream readers, with the same sizing arithmetic (``scan_steps``,
``Rq``, ``B``, ``max_span``), the same refill spans and the same h2d
counters: 8 B/row of uv on a cold pass, 12 B/row when the source has
``prev_read``, 4 B/row on instances whose uv rows survive from an adopted
:class:`RingHandle`. The step reads the ring at ``s % B``. In the JAX
package each refill returns a new donated ring; here one ``(z, B, 2)`` uv
ring and one ``(z, B)`` prev ring (filled with -1 on the device) are
allocated per pass, every refill writes into them in place, and an adopted
handle gives the next pass the same tensors. The driver builds its step over
those tensors once, so the captured CUDA graphs stay valid for the pass.

Donation ordered the JAX package's speculative refill after the scan call
in flight; here stream order does: a refill's host-to-device copies are
enqueued on the stream that replays the graphs, after scan call k's
replays, so the copy that recycles a slot runs after the last step that may
read it. The host's disk reads still overlap the scan, in the
:class:`_ReadAhead` worker (numpy only, one daemon thread). Refill rows go
through pinned staging (``pin_memory()``, whose caching allocator holds the
block until the copy that reads it has run): a copy from pageable memory
would make the host wait for the scan.

The ring path hands each scan call's placements to ``on_assign`` after the
call, with ONE synchronisation for ``assigned``, ``cursor``, ``sidx`` and
``p`` (copied into pinned host buffers before the speculative refill is
enqueued, so the wait does not include that refill's copies), as the JAX
driver syncs once per call. Its counters are those of the JAX ring:
``h2d_wait_s`` (wall in blocking refills), ``prefetch_depth``,
``refill_spans`` = ``spans_prestaged`` + ``spans_missed`` and
``prestage_wall_s`` (the worker's staging wall), with the spans ``refill``,
``refill-spec``, ``fetch``, ``stage`` (on the read-ahead thread's track),
the ``ring-adopt`` instant and the ``readahead_staged_rows`` gauge.

Instances over ranks
--------------------
With a process group of more than one rank, ``backend='shard_map'`` (and
``'auto'``) places the z instances on an ``instances`` mesh of ranks
(:func:`resolve_backend`: ``n_shards`` ranks, the largest divisor of z that
is at most the world size), as the JAX package places them on devices: rank
r steps the contiguous block of ``z / n_shards`` instances starting at
``r·z / n_shards``, with their global instance ids, and ranks at or past
``n_shards`` step nothing. Every rank joins every collective and returns
the whole batch's outcome:

- the chunk arithmetic is the batch's (the longest instance of all z), and
  each drain call (resident) or scan call (ring) is taken while *some*
  instance of the batch has edges left (one all-reduce of the flag), so
  ``scan_calls`` and ``steps_run`` are the JAX package's;
- on a latency budget, every rank recalibrates from one shared cost: the
  slowest rank's wall over the batch's score rows;
- at the end one gather gives every rank every instance's outputs and
  counters; ``h2d_rows``, ``h2d_bytes`` and the refill counts are the
  batch's (summed over the ranks' blocks), ``wall_time_s``, ``setup_s``,
  ``h2d_wait_s`` and ``prestage_wall_s`` the slowest rank's;
- on a file ring, ``on_assign`` gets the rank's own instances, by global
  index, and a pass's :class:`RingHandle` holds the rank's ring with the
  batch's geometry, so the next pass adopts it on the same rank.

A batch that resolves to ``'vmap'`` runs whole on every rank (the same
work, the same results), sharing only the budget's wall. With no process
group, or a world of 1, nothing here issues a collective.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Deque, List, NamedTuple, Optional, Sequence, Tuple

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
from repro_torch import dist as rdist
from repro_torch.obs import resolve_tracer

__all__ = [
    "StepCore",
    "AdwiseCore",
    "ResidentSource",
    "FileSource",
    "RingBuf",
    "RingHandle",
    "StreamResidency",
    "ScanDriver",
    "DriveResult",
    "resolve_backend",
    "resolve_prefetch",
    "PREFETCH_ENV",
]

# Steps captured in one CUDA graph; a scan call replays it chunk_steps // 32
# times, then a one-step graph for the remainder.
STEPS_PER_GRAPH = 32

PREFETCH_ENV = "ADWISE_PREFETCH"


def resolve_prefetch(prefetch: Optional[int] = None) -> int:
    """Effective read-ahead depth: explicit argument > ``ADWISE_PREFETCH``
    env var > default 2. ``0`` selects the synchronous bit-parity path
    (no worker thread, every span read inline between scan calls)."""
    if prefetch is None:
        raw = os.environ.get(PREFETCH_ENV, "").strip()
        prefetch = int(raw) if raw else 2
    return max(0, int(prefetch))


def resolve_backend(backend: str, z: int, world: Optional[int] = None) -> tuple[str, int]:
    """(effective backend, n_shards), as the JAX package resolves it with
    the ranks of the default process group (``world``, default its size)
    in place of the devices: 'auto' picks 'shard_map' when there is more
    than one rank; 'shard_map' places the z instances on ``n_shards``
    ranks, the largest divisor of z that is at most min(world, z), and
    degrades to ``('vmap', 0)`` — the one batched step on every rank — when
    that is 1."""
    if world is None:
        world = rdist.world_size()
    if backend == "auto":
        backend = "shard_map" if world > 1 else "vmap"
    if backend == "vmap":
        return "vmap", 0
    if backend != "shard_map":
        raise ValueError(
            f"backend must be 'auto', 'vmap' or 'shard_map', got {backend!r}"
        )
    nd = min(world, z)
    n_shards = max((d for d in range(1, nd + 1) if z % d == 0), default=1)
    if n_shards <= 1:
        return "vmap", 0
    return "shard_map", n_shards


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

    def recalibrate(self, carry: Any, t0: float,
                    share: Optional[Callable[[float, int], Tuple[float, int]]] = None) -> None:
        """Between-chunks budget recalibration (no-op unless has_budget).
        ``share(wall, rows)`` gives the batch's (wall, score rows) from this
        rank's when the batch runs on several ranks."""

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

    def recalibrate(self, carry: Any, t0: float,
                    share: Optional[Callable[[float, int], Tuple[float, int]]] = None) -> None:
        budget = self.cfg.latency_budget
        assert budget is not None  # only called when has_budget
        # One step runs every instance, so the shared per-row cost comes
        # from the batched wall over the total row count.
        # staticcheck: disable=SC003 budget recalibration MEASURES wall clock — the sync is the measurement (§III-B latency budget)
        rows = int(carry.score_rows.sum())
        wall = time.perf_counter() - t0
        if share is not None:
            wall, rows = share(wall, rows)
        rows = max(rows, 1)
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
    shared across different streams. A rank past an ``instances`` mesh
    holds no block of the stream and publishes None: the shape is still
    resident for the batch, so every rank bills pass p+1 alike.
    """

    __slots__ = ("_by_shape",)

    def __init__(self) -> None:
        self._by_shape: dict[Tuple[int, ...], Optional[torch.Tensor]] = {}

    def publish(self, streams: Optional[torch.Tensor], shape: Tuple[int, ...]) -> None:
        self._by_shape[tuple(shape)] = streams

    def holds(self, shape: Tuple[int, ...]) -> bool:
        return tuple(shape) in self._by_shape

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

    def select(self, lo: int, hi: int) -> "ResidentSource":
        """Instances ``lo .. hi - 1`` (a rank's block), sharing the
        residency holder."""
        return ResidentSource(self.streams[lo:hi], self.m_per[lo:hi], residency=self.residency)


class RingBuf(NamedTuple):
    """Device-resident stream ring: slot ``s % B`` holds logical row ``s``.

    Allocated once per pass and written in place by every refill, so the
    step built over it (and the CUDA graphs captured from that step) read
    the rows each refill ships.
    """

    uv: torch.Tensor  # (z, B, 2) int32
    prev: torch.Tensor  # (z, B) int32 prior-pass assignment, -1 = none


class RingHandle(NamedTuple):
    """Cross-pass hand-off of a completed ring pass (file mode).

    A re-streaming pass with the same geometry adopts it through
    ``FileSource(resume=...)``: instances whose whole stream fit in the ring
    without wrapping keep their uv rows on the device and ship only prev
    placements. The adopting pass writes into the same tensors.
    """

    buf: Optional[RingBuf]  # a sharded pass: this rank's instances' rows (None: none)
    hi: np.ndarray  # (z,) per-instance upload high-water marks at pass end
    B: int  # ring rows per instance
    z: int
    m_per: np.ndarray  # (z,) real stream lengths the pass ran over


# One staged block: (start_row, row_count, uv rows or None, prev rows or
# None). uv is None for cross-pass resumed instances (prev-only refills).
_Block = Tuple[int, int, Optional[np.ndarray], Optional[np.ndarray]]


def _read_rows(src: "FileSource", i: int, start: int, c: int
               ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Instance i's host rows [start, start + c): uv (unless its uv rows are
    still on the device from an adopted ring) and, with ``prev_read``, the
    prior pass's placements. A reader that returns another row count raises."""
    uv: Optional[np.ndarray] = None
    if not src.uv_resident[i]:
        uv = np.ascontiguousarray(src.readers[i].read(start, c), np.int32)
        if len(uv) != c:
            raise RuntimeError(
                f"instance {i}: reader returned {len(uv)} of {c} rows at offset {start}")
    prev: Optional[np.ndarray] = None
    if src.prev_read is not None:
        prev = np.ascontiguousarray(src.prev_read[i](start, c), np.int32)
        if len(prev) != c:
            raise RuntimeError(
                f"instance {i}: prev_read returned {len(prev)} of {c} rows at offset {start}")
    return uv, prev


class _ReadAhead:
    """Host read-ahead worker: stage stream/prev rows while the scan runs.

    One daemon thread services all z instances, least-staged first, reading
    ``Rq``-row blocks (the final ragged tail ends exactly at ``m_i``) into a
    bounded per-instance staging deque, at most ``depth_rows`` rows past
    what :meth:`take` has consumed. Every refill span is a whole number of
    Rq blocks (or ends exactly at ``m_i``), so ``take`` always pops whole
    blocks and never splits one. The worker touches numpy only, never the
    device.

    Disk reads happen OUTSIDE the lock (the lock only guards the deques and
    the progress counters); worker exceptions are captured and re-raised in
    the consumer's next ``take``. ``close`` is idempotent and joins the
    thread — safe on every exception path.
    """

    def __init__(self, source: "FileSource", depth_rows: int) -> None:
        self._src = source
        self._depth = int(depth_rows)
        self._cv = threading.Condition()
        z = source.z
        self._staged: List[Deque[_Block]] = [collections.deque() for _ in range(z)]
        # Worker-side read position and consumer-side pop position per
        # instance; both only ever advance.
        self._next = np.zeros((z,), np.int64)
        self._taken = np.zeros((z,), np.int64)
        self._exc: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name="adwise-readahead", daemon=True)
        self._thread.start()

    # -- worker side -------------------------------------------------------
    def _pick(self) -> Optional[int]:
        """Least-staged eligible instance, or None (caller holds the lock)."""
        src = self._src
        best, best_lag = None, 0
        for i in range(src.z):
            if self._next[i] >= src.m_per[i]:
                continue  # instance fully staged
            lag = int(self._next[i] - self._taken[i])
            if lag >= self._depth:
                continue  # at the bound: wait for the consumer
            if best is None or lag < best_lag:
                best, best_lag = i, lag
        return best

    def _loop(self) -> None:
        src = self._src
        try:
            while True:
                with self._cv:
                    while True:
                        if self._stop:
                            return
                        i = self._pick()
                        if i is not None:
                            break
                        if (self._next >= src.m_per).all():
                            return  # everything staged; worker retires
                        self._cv.wait()
                    start = int(self._next[i])
                    c = min(src.Rq, int(src.m_per[i]) - start)
                # Reads outside the lock: the consumer keeps popping while
                # the worker is on disk.
                trace = src.trace
                t_stage = time.perf_counter()
                uv, prev = _read_rows(src, i, start, c)
                t_staged = time.perf_counter()
                if trace.enabled:
                    # Recorded from the worker thread, so the span lands on
                    # the `adwise-readahead` track.
                    trace.add_span(
                        "stage", "stage", t_stage, t_staged,
                        attrs=dict(instance=i, start=start, rows=c, prev=prev is not None),
                    )
                with self._cv:
                    # Worker-side staging wall: what h2d_wait_s (blocking
                    # refills only) cannot see. Accumulated even when
                    # untraced, so the overlap is always measured.
                    src.prestage_wall_s += t_staged - t_stage
                    self._staged[i].append((start, c, uv, prev))
                    self._next[i] = start + c
                    if trace.enabled:
                        depth = int((self._next - self._taken).sum())
                    self._cv.notify_all()
                if trace.enabled:
                    trace.gauge("readahead_staged_rows", depth)
        except BaseException as e:  # surfaced via take(); the thread must not die silently
            with self._cv:
                self._exc = e
                self._cv.notify_all()

    # -- consumer side -----------------------------------------------------
    def take(self, i: int, start: int, count: int
             ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], bool]:
        """Pop ``count`` staged rows of instance i beginning at ``start``.

        Returns ``(uv_rows, prev_rows, waited)`` — ``waited`` is True when
        the consumer had to block on the worker (a pipeline miss).
        """
        end = start + count
        uv_parts: List[np.ndarray] = []
        prev_parts: List[np.ndarray] = []
        waited = False
        with self._cv:
            assert start == int(self._taken[i]), (
                f"instance {i}: take at {start}, staged position is {int(self._taken[i])}")
            while self._taken[i] < end:
                if self._exc is not None:
                    raise RuntimeError("read-ahead worker failed") from self._exc
                if self._staged[i]:
                    b_start, c, uv, prev = self._staged[i].popleft()
                    assert b_start == int(self._taken[i])
                    assert b_start + c <= end, (
                        f"instance {i}: staged block [{b_start}, {b_start + c}) straddles "
                        f"take end {end} — span/block alignment broken")
                    if uv is not None:
                        uv_parts.append(uv)
                    if prev is not None:
                        prev_parts.append(prev)
                    self._taken[i] = b_start + c
                    self._cv.notify_all()  # freed depth: wake the worker
                else:
                    waited = True
                    self._cv.wait()
        uv_all = (uv_parts[0] if len(uv_parts) == 1
                  else np.concatenate(uv_parts) if uv_parts else None)
        prev_all = (prev_parts[0] if len(prev_parts) == 1
                    else np.concatenate(prev_parts) if prev_parts else None)
        return uv_all, prev_all, waited

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)


class FileSource:
    """Bounded device-resident ring buffer over per-instance stream readers.

    ``readers[i]`` is instance i's locally addressed stream (an
    ``EdgeFileReader`` / sub-reader, or anything with ``num_edges`` and
    ``read(start, count)``); ``prev_read[i](start, count)`` optionally
    supplies the prior pass's placements for buffered re-streaming
    revocation.

    Sizing, as in the JAX package (``W = core.window_rows``,
    ``b = core.rows_per_step``): ``S = (B0 - W) // b`` scan steps per call
    consume at most ``F = W + S·b`` rows, where
    ``B0 = max(chunk_edges, W + b)``. Refills are quantized to spans that
    are multiples of ``Rq`` (a power of two); the ring holds
    ``B = (⌈F/Rq⌉ + 2)·Rq`` rows, so a quantized refill always leaves ≥ F
    uploaded-but-unread rows ahead of the cursor while never overwriting a
    live slot (row ``s`` lands in slot ``s % B`` only once row ``s − B`` is
    behind the cursor). One host read stays within ``max_span`` ≤ B0 rows.

    Invariants (checked): ``cursor ≤ hi ≤ cursor + B`` and ``hi`` advances
    monotonically — every stream row is read from disk and shipped to the
    device exactly once per pass.

    ``prefetch >= 1`` starts a :class:`_ReadAhead` worker that stages up to
    ``prefetch · max_span`` rows ahead of consumption, and the driver issues
    a speculative refill after each scan call. ``prefetch=0`` is the
    synchronous path. ``resume`` adopts a previous pass's
    :class:`RingHandle`: matching-geometry instances that never wrapped ship
    prev-only spans (4 B/row instead of 12 B/row).
    """

    resident = False

    def __init__(
        self,
        readers: Sequence,
        *,
        chunk_edges: int,
        cfg: Optional[AdwiseConfig] = None,
        core: Optional[StepCore] = None,
        prev_read: Optional[List[Callable[[int, int], np.ndarray]]] = None,
        prefetch: Optional[int] = None,
        resume: Optional[RingHandle] = None,
        trace: Any = None,
    ) -> None:
        self.trace = resolve_tracer(trace)
        self.readers = list(readers)
        self.z = len(self.readers)
        if self.z < 1:
            raise ValueError("FileSource needs at least one reader")
        self.m_per = np.array([r.num_edges for r in self.readers], np.int64)
        self.prev_read = prev_read
        if core is not None:
            w_max, b = core.window_rows, core.rows_per_step
        elif cfg is not None:
            w_max, b = cfg.window_max, cfg.assign_batch
        else:
            raise ValueError("FileSource needs a cfg or a step-core")
        b0 = int(max(chunk_edges, w_max + b))
        self.scan_steps = max(1, (b0 - w_max) // b)
        f = w_max + self.scan_steps * b  # worst-case rows consumed per call
        self.Rq = 1 << max(2, (max(f // 8, 1)).bit_length())
        self.B = (-(-f // self.Rq) + 2) * self.Rq
        # Single disk reads stay within b0, kept a multiple of Rq so span
        # shapes stay quantized.
        self.max_span = max(self.Rq, (b0 // self.Rq) * self.Rq)
        # Host-side high-water mark: rows [0, hi) are on the device.
        self.hi = np.zeros((self.z,), np.int64)
        self.h2d_rows = 0
        self.h2d_bytes = 0
        self.h2d_wait_s = 0.0
        self.prestage_wall_s = 0.0
        self.refill_spans = 0
        self.spans_prestaged = 0
        self.spans_missed = 0
        self.prefetch = resolve_prefetch(prefetch)
        # Distinct (uv, prev) device addresses the refills wrote to: one
        # pair per pass, shared with the pass that adopts the ring.
        self.ring_addrs: set = set()
        # uv_resident[i]: instance i's uv rows survive from the adopted
        # previous-pass ring — refills ship prev-only spans.
        self.uv_resident = np.zeros((self.z,), bool)
        self._resume_buf: Optional[RingBuf] = None
        if resume is not None:
            self._adopt(resume)
        self._worker: Optional[_ReadAhead] = None
        self._worker_started = False

    def select(self, lo: int, hi: int) -> "FileSource":
        """Instances ``lo .. hi - 1`` (a rank's block) with this source's
        geometry, counters at zero. Taken before any refill; an adopted
        ring is the rank's own (its handle came from the same block)."""
        sub = copy.copy(self)
        sub.readers = self.readers[lo:hi]
        sub.z = hi - lo
        sub.m_per = self.m_per[lo:hi].copy()
        sub.prev_read = None if self.prev_read is None else self.prev_read[lo:hi]
        sub.hi = np.zeros((sub.z,), np.int64)
        sub.uv_resident = self.uv_resident[lo:hi].copy()
        sub.ring_addrs = set()
        return sub

    def _adopt(self, resume: RingHandle) -> None:
        """Adopt a previous pass's ring under the cross-pass contract: same
        geometry (B, z, per-instance m), and only instances whose whole
        stream fit without wrapping (``m_i <= B`` and the pass uploaded all
        of it) keep uv residency."""
        if self.prev_read is None:
            raise ValueError(
                "resuming a ring without prev_read would re-run the same pass; "
                "cross-pass adoption is for re-streaming revocation only")
        if (resume.B != self.B or resume.z != self.z
                or not (np.asarray(resume.m_per) == self.m_per).all()):
            return  # geometry changed (re-chunked): full re-ship fallback
        fits = (self.m_per <= resume.B) & (np.asarray(resume.hi) >= self.m_per)
        if fits.any():
            self.uv_resident = fits
            self._resume_buf = resume.buf
            if self.trace.enabled:
                self.trace.instant(
                    "ring-adopt", "refill",
                    resident_instances=int(fits.sum()), z=self.z, B=self.B,
                )

    def alloc(self, device: torch.device) -> RingBuf:
        """The ring for this pass: the adopted previous-pass ring when
        resuming, else a fresh one on ``device``: uv zeros, prev all -1 (no
        prior placement — 0 would be a real partition id and would trigger
        a false revocation), filled on the device. Stale prev rows in an
        adopted ring are harmless: hi restarts at 0, so every row's prev is
        shipped again before the cursor can reach it."""
        if self._resume_buf is not None:
            buf, self._resume_buf = self._resume_buf, None
            if buf.uv.device.type != device.type:
                raise ValueError(f"adopted ring lives on {buf.uv.device}, not {device}")
            return buf
        return RingBuf(
            uv=torch.zeros((self.z, self.B, 2), dtype=torch.int32, device=device),
            prev=torch.full((self.z, self.B), -1, dtype=torch.int32, device=device),
        )

    def _fetch(self, i: int, start: int, c: int
               ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], bool]:
        """One span's host rows: from the staging queue when pipelined,
        read inline otherwise. Lazily starts the worker so sizing-only
        FileSource uses never spawn a thread."""
        if self.prefetch > 0 and not self._worker_started:
            self._worker_started = True
            self._worker = _ReadAhead(self, self.prefetch * self.max_span)
        if self._worker is not None:
            return self._worker.take(i, start, c)
        uv, prev = _read_rows(self, i, start, c)
        # The synchronous path stalls on every span by construction.
        return uv, prev, True

    def refill(self, buf: RingBuf, cursors: np.ndarray, *, speculative: bool = False) -> RingBuf:
        """Ship the new tail rows of every instance into ``buf``, in place;
        returns ``buf``.

        ``cursors[i]`` is instance i's scan cursor — rows behind it are dead
        and their slots are free to overwrite. A ``speculative`` refill
        passes the guaranteed-progress lower bound instead of the true
        cursor and is left out of the measured ``h2d_wait_s`` stall: its
        staging work overlaps the scan call in flight, and its copies are
        enqueued behind that call on the same stream.
        """
        trace = self.trace
        traced = trace.enabled
        t_start = time.perf_counter() if (traced or not speculative) else 0.0
        shipped_rows = 0
        call_spans = 0
        call_missed = 0
        with_prev = self.prev_read is not None
        pin = buf.uv.device.type == "cuda"
        self.ring_addrs.add((buf.uv.data_ptr(), buf.prev.data_ptr()))
        for i in range(self.z):
            cur = int(cursors[i])
            m_i = int(self.m_per[i])
            hi = int(self.hi[i])
            if cur > hi:
                raise RuntimeError(
                    f"instance {i}: scan cursor {cur} overran the uploaded "
                    f"high-water mark {hi} — ring refill bound violated")
            target = min(cur + self.B, m_i)
            if target <= hi:
                continue
            span_total = target - hi
            if target < m_i:
                # Quantize to Rq blocks; B ≥ F + 2·Rq keeps ≥ F rows ahead
                # of the cursor even after flooring.
                span_total -= span_total % self.Rq
            end = hi + span_total
            while hi < end:
                slot = hi % self.B
                # Never wrap inside a write; never exceed the chunk bound.
                c = min(end - hi, self.B - slot, self.max_span)
                if traced:
                    t_fetch = time.perf_counter()
                rows, prows, waited = self._fetch(i, hi, c)
                if traced:
                    trace.add_span(
                        "fetch", "fetch", t_fetch, time.perf_counter(),
                        attrs=dict(instance=i, start=hi, rows=c, prestaged=not waited),
                    )
                self.refill_spans += 1
                call_spans += 1
                if waited:
                    self.spans_missed += 1
                    call_missed += 1
                else:
                    self.spans_prestaged += 1
                if rows is not None:
                    _ship(buf.uv[i, slot:slot + c], rows, pin)
                    self.h2d_rows += c
                    self.h2d_bytes += c * 8
                if with_prev:
                    _ship(buf.prev[i, slot:slot + c], prows, pin)
                    self.h2d_bytes += c * 4
                shipped_rows += c
                hi += c
            self.hi[i] = hi
        if not speculative:
            t_end = time.perf_counter()
            self.h2d_wait_s += t_end - t_start
            if traced:
                # Same (t_start, t_end) floats that fed h2d_wait_s: the
                # `refill` category total reconciles with it exactly.
                trace.add_span(
                    "refill", "refill", t_start, t_end,
                    attrs=dict(rows=shipped_rows, spans=call_spans,
                               missed=call_missed, Rq=self.Rq),
                )
        elif traced and call_spans:
            trace.add_span(
                "refill-spec", "refill-spec", t_start, time.perf_counter(),
                attrs=dict(rows=shipped_rows, spans=call_spans,
                           missed=call_missed, Rq=self.Rq),
            )
        return buf

    def close(self) -> None:
        """Join the read-ahead worker (idempotent; safe on exception paths).
        After close, further refills fall back to synchronous reads."""
        if self._worker is not None:
            self._worker.close()
            self._worker = None

    def __enter__(self) -> "FileSource":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _ship(dst: torch.Tensor, rows: np.ndarray, pin: bool) -> None:
    """Copy host rows into a slice of the ring, enqueued on the current
    stream. On the card the rows go through a pinned block first, so the
    copy is asynchronous and the host does not wait for the scan in flight;
    the caching host allocator keeps the block until the copy has run."""
    host = torch.from_numpy(rows)
    if pin:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=pin)


class DriveResult(NamedTuple):
    """Raw outcome of one driven scan; callers assemble their stats."""

    # Per-instance step outputs over every scan call — collected in
    # resident mode only (the file path streams them to `on_assign`).
    sidx: Optional[np.ndarray]  # (z, T·b)
    p: Optional[np.ndarray]  # (z, T·b)
    w_trace: Optional[np.ndarray]  # (z, T)
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
    # Refill-pipeline accounting (file mode; zeros for resident sources).
    h2d_wait_s: float = 0.0  # wall spent in blocking refills
    prefetch_depth: int = 0
    refill_spans: int = 0
    spans_prestaged: int = 0
    spans_missed: int = 0
    prestage_wall_s: float = 0.0  # the read-ahead worker's staging wall
    ring_addrs: int = 0  # distinct ring addresses the refills wrote to


class ScanDriver:
    """The stepping loop over a source of z instances: the resident stream
    (chunked scan calls, outputs collected once) or a file ring (refill →
    scan → one sync → emit, per call), on this rank's device — all z
    instances, or this rank's block of them when the batch resolves to
    'shard_map' over several ranks (module docstring)."""

    def __init__(
        self,
        source: Any,  # a ResidentSource or a FileSource
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
        # A traced driver over an untraced FileSource lends it its tracer,
        # so refill/stage spans land in the same timeline.
        src_trace = getattr(source, "trace", None)
        if self.trace.enabled and src_trace is not None and not src_trace.enabled:
            source.trace = self.trace
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
        # This rank's block of instances: all of them unless the batch is
        # sharded over an `instances` mesh of ranks.
        self.sharded = self.n_shards > 1
        self.mesh = rdist.rank_mesh("instances", self.n_shards if self.sharded else None)
        lo, hi = 0, z
        if self.sharded:
            per_rank = z // self.n_shards
            c = self.mesh.coord
            lo, hi = (z, z) if c is None else (c * per_rank, (c + 1) * per_rank)
        self.block = (lo, hi)
        self.m_local = self.m_per[lo:hi]
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
        # A file pass reads prior placements through the source's prev_read.
        self._prev_np = np.full((z, source.per), -1, np.int32) if source.resident else None
        if warm is not None:
            if len(warm) != z:
                raise ValueError(f"need one WarmState per instance, got {len(warm)}")
            has_prev = [w.prev_assign is not None for w in warm]
            if any(has_prev) and not all(has_prev):
                raise ValueError(
                    "all instances must agree on whether prev_assign is provided")
            if any(has_prev) and not source.resident:
                raise ValueError(
                    "file-mode warm states must not carry prev_assign; pass "
                    "prev_read to the FileSource instead")
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
        ids = np.arange(z) if instance_ids is None else np.asarray(instance_ids)
        if ids.shape != (z,):
            raise ValueError(f"instance_ids must be ({z},), got {ids.shape}")
        self.fixed_cost = cost_per_score is not None
        # The rank's source and carry: None on a rank past the mesh.
        self.local: Any = None
        self.carry: Any = None
        if hi > lo:
            self.local = source if (lo, hi) == (0, z) else source.select(lo, hi)
            if warm is None:
                carry = stack_instances([core.init_carry(budget, dev)] * (hi - lo))
            else:
                carry = stack_instances([core.warm_carry(budget, w, dev) for w in warm[lo:hi]])
            carry = core.seed_instances(carry, hi - lo, ids[lo:hi])
            if cost_per_score is not None:
                core.set_cost(carry, cost_per_score)
            self.carry = carry
            self._m_real = torch.as_tensor(self.m_local.astype(np.int32), device=dev)
            self._allowed = torch.as_tensor(allowed_np[lo:hi], device=dev)
            self._caps = torch.as_tensor(caps[lo:hi], device=dev)
        self.steps_per_graph = STEPS_PER_GRAPH if dev.type == "cuda" else 0
        # Set after a completed ring drive: the cross-pass hand-off a
        # re-streaming pass may adopt (FileSource(resume=...)).
        self.ring_handle: Optional[RingHandle] = None

    def _more(self, flag: bool) -> bool:
        """Whether the batch has work left: ``flag`` on some rank when the
        batch is sharded (every rank takes the same branch), else ``flag``."""
        return self.mesh.any(flag) if self.sharded else bool(flag)

    def _share_cost(self, wall: float, rows: int) -> Tuple[float, int]:
        """The batch's (wall, score rows): the slowest rank's wall, and the
        rows of every rank's block (a sharded batch) or of this rank's
        whole batch."""
        vals = self.mesh.gather_values([wall, rows])
        return float(vals[:, 0].max()), int(vals[:, 1].sum()) if self.sharded else rows

    def _recalibrate(self, carry: Any, t0: float) -> None:
        if self.has_budget and not self.fixed_cost:
            share = self._share_cost if self.mesh.world > 1 else None
            if carry is None:  # a rank past the mesh joins the shared cost
                self._share_cost(time.perf_counter() - t0, 0)
                return
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.core.recalibrate(carry, t0, share)

    def _run_resident(self, n_chunks: int) -> DriveResult:
        src, core, dev = self.source, self.core, self.device
        local, carry = self.local, self.carry
        b = core.rows_per_step
        m_max = int(self.m_per.max())
        # Provisioned by the longest instance of the batch (shorter ones
        # idle); the drain covers top-b pick stalls.
        steps_total = -(-m_max // b) + -(-core.window_rows // b) + 2
        n_chunks = max(1, min(n_chunks, steps_total))
        chunk_steps = -(-steps_total // n_chunks)
        n_chunks = -(-steps_total // chunk_steps)

        t0 = time.perf_counter()
        # The batch's upload bill; a rank uploads its block. A residency
        # holder is per process, keyed by the batch's shape, and every rank
        # (one past the mesh too) publishes that shape, so the ranks agree
        # on a hit.
        residency = src.residency
        resident = residency is not None and residency.holds(src.streams.shape)
        stream = residency.lookup(src.streams.shape) if resident else None
        if resident:
            # The previous pass left the stream on the device: only the new
            # prev table ships.
            h2d_rows = 0
            h2d_bytes = self._prev_np.size * 4
        else:
            h2d_rows = src.upload_rows
            h2d_bytes = src.upload_rows * 8 + self._prev_np.size * 4
        trace = self.trace
        traced = trace.enabled and local is not None
        outs = []
        run_chunk: Any = None
        if residency is not None and local is None:
            residency.publish(None, src.streams.shape)
        if local is not None:
            if stream is None:
                stream = torch.as_tensor(local.streams, device=dev)
            if residency is not None:
                residency.publish(stream, src.streams.shape)
            lo, hi = self.block
            prev = torch.as_tensor(self._prev_np[lo:hi], device=dev)
            step = core.make_step(stream, self._m_real, self._allowed, self._caps, prev)
            out = StepOut.empty(chunk_steps, hi - lo, b, dev)
            if dev.type == "cuda":
                run_chunk = _GraphStepper(step, carry, out, chunk_steps, self.steps_per_graph)
            else:
                run_chunk = _LoopStepper(step, carry, out, chunk_steps)
        setup_s = time.perf_counter() - t0

        calls = 0
        for _ in range(n_chunks):
            calls += 1
            if run_chunk is not None:
                if traced:
                    t_call = time.perf_counter()
                captured = run_chunk()
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
        while self._more(carry is not None and bool((carry.assigned < self._m_real).any())) \
                and drain_left > 0:
            calls += 1
            if run_chunk is not None:
                if traced:
                    t_call = time.perf_counter()
                run_chunk()
                outs.append(_snapshot(out))
                if traced:
                    trace.add_span(
                        "scan-call", "scan", t_call, time.perf_counter(),
                        attrs=dict(call=calls, steps=chunk_steps, mode="drain"),
                    )
            drain_left -= 1
        mine = None
        if run_chunk is not None:
            if traced:
                t_mat = time.perf_counter()
            z = hi - lo
            # (calls·T, z, b) -> (z, calls·T·b), and (calls·T, z) -> (z, calls·T).
            sidx = torch.cat([o[0] for o in outs]).transpose(0, 1).cpu().numpy().reshape(z, -1)
            pout = torch.cat([o[1] for o in outs]).transpose(0, 1).cpu().numpy().reshape(z, -1)
            w_trace = torch.cat([o[2] for o in outs]).transpose(0, 1).cpu().numpy()
            if traced:
                trace.add_span("materialize", "host", t_mat, time.perf_counter(),
                               attrs=dict(calls=calls))
            mine = dict(core.counters(carry), sidx=sidx, p=pout, w_trace=w_trace,
                        assigned=carry.assigned.cpu().numpy())
        wall = time.perf_counter() - t0
        setup_s += run_chunk.capture_s if run_chunk is not None else 0.0
        warmup = run_chunk.warmup_steps if run_chunk is not None else 0
        out_all, (wall, setup_s, warmup), _ = self._gather(mine, [wall, setup_s, warmup], [])
        return DriveResult(
            sidx=out_all["sidx"],
            p=out_all["p"],
            w_trace=out_all["w_trace"],
            assigned=out_all["assigned"],
            score_rows=out_all["score_rows"],
            final_w=out_all["final_w"],
            lam=out_all["lam"],
            cost_per_score=out_all["cost_per_score"],
            wall_time_s=wall,
            r_sel=self.r_sel,
            backend=self.backend,
            n_shards=self.n_shards,
            scan_calls=calls,
            steps_run=calls * chunk_steps,
            warmup_steps=int(warmup),
            setup_s=setup_s,
            h2d_rows=int(h2d_rows),
            h2d_bytes=int(h2d_bytes),
            buffer_rows=src.per,
            scan_steps_per_call=chunk_steps,
            steps_per_graph=self.steps_per_graph,
        )

    def _gather(self, mine: Optional[dict], slowest: List[float], summed: List[float]
                ) -> Tuple[dict, List[float], List[float]]:
        """The batch's outcome from the ranks' blocks. ``mine``: this rank's
        per-instance arrays (leading axis: its block), None past the mesh;
        ``slowest`` / ``summed``: its scalars, of which the batch's are the
        largest / the sum over the ranks. Without sharding, this rank's own.
        Returns (per-instance arrays over all z, in instance order, the
        slowest values, the summed values)."""
        if not self.sharded:
            assert mine is not None
            return mine, slowest, summed
        parts = self.mesh.gather_objects((mine, slowest, summed))
        blocks = [p[0] for p in parts if p[0] is not None]
        out = {key: np.concatenate([blk[key] for blk in blocks]) for key in blocks[0]}
        top = [max(p[1][j] for p in parts) for j in range(len(slowest))]
        tot = [sum(p[2][j] for p in parts) for j in range(len(summed))]
        return out, top, tot

    def _run_ring(self, on_assign: Callable[[int, np.ndarray, np.ndarray], None]) -> DriveResult:
        core, dev = self.core, self.device
        src, carry = self.local, self.carry
        lo = self.block[0]
        m_max = int(self.m_per.max())
        S = self.source.scan_steps
        pipelined = self.source.prefetch > 0
        iters = 0
        # Every step with a non-empty window assigns >= 1 edge per instance,
        # so the calls are bounded by m_max plus the window build-up.
        max_iters = -(-(m_max + core.window_rows) // S) + 8
        # Host mirrors of the synced counters, one sync per scan call. The
        # loop body: top-up refill (true cursor) -> scan call k -> copies of
        # its outputs and counters to the host -> SPECULATIVE refill for
        # call k+1 (from the guaranteed-progress lower bound, enqueued
        # behind call k) -> the one sync -> emit. At prefetch=0 the
        # speculative refill is skipped.
        z = len(self.m_local)
        assigned = np.zeros((z,), np.int64)
        cursors = np.zeros((z,), np.int64)
        trace = self.trace
        traced = trace.enabled and src is not None
        done_before = 0
        run_chunk: Any = None
        buf = None
        setup_s = 0.0
        t0 = time.perf_counter()
        try:
            if src is not None:
                buf = src.alloc(dev)
                step = core.make_step(buf.uv, self._m_real, self._allowed, self._caps, buf.prev)
                out = StepOut.empty(S, z, core.rows_per_step, dev)
                if dev.type == "cuda":
                    run_chunk = _GraphStepper(step, carry, out, S, self.steps_per_graph)
                else:
                    run_chunk = _LoopStepper(step, carry, out, S)
                emitted = _HostCopy((carry.assigned, carry.cursor, out.sidx, out.p), dev)
                setup_s = time.perf_counter() - t0
            while self._more(src is not None and not (assigned >= self.m_local).all()):
                iters += 1
                if iters > max_iters:
                    raise RuntimeError(
                        f"streaming scan failed to converge: {assigned} of "
                        f"{self.m_local} assigned after {iters - 1} calls")
                if src is not None:
                    buf = src.refill(buf, cursors)
                    if traced:
                        t_call = time.perf_counter()
                    captured = run_chunk()
                    emitted.start()
                    if pipelined:
                        # Safe without syncing: the call in flight advances every
                        # unfinished instance by >= S assignments, so rows below
                        # lb are dead for every later call, and the copies are
                        # enqueued behind that call on the same stream.
                        lb = np.minimum(assigned + S, self.m_local)
                        buf = src.refill(buf, lb, speculative=True)
                    # staticcheck: disable=SC003 ring-mode termination: ONE sync per scan call for assigned, cursor, sidx and p, amortized over S steps
                    a_h, c_h, sidx_h, p_h = emitted.wait()
                    assigned = a_h.astype(np.int64)
                    # The next refill needs the host cursor to size disk reads,
                    # and file mode streams placements to on_assign to stay
                    # O(chunk): both come from the same sync.
                    cursors = c_h.astype(np.int64)
                    sidx = sidx_h.transpose(1, 0, 2).reshape(z, -1)
                    pout = p_h.transpose(1, 0, 2).reshape(z, -1)
                    for i in range(z):
                        live = sidx[i] >= 0
                        if live.any():
                            on_assign(lo + i, sidx[i][live].astype(np.int64), pout[i][live])
                    if traced:
                        # Refill -> scan call -> speculative refill -> the one
                        # sync -> emit: the whole host wait for scan call k.
                        # `rows` stays an np scalar; the exporter unwraps it.
                        done = assigned.sum()
                        trace.add_span(
                            "scan-call", "scan", t_call, time.perf_counter(),
                            attrs=dict(call=iters, steps=S, rows=done - done_before,
                                       compiled=captured),
                        )
                        done_before = done
                self._recalibrate(carry, t0)
            if src is not None and not (cursors <= src.hi).all():
                raise RuntimeError(f"scan cursors {cursors} overran uploaded rows {src.hi}")
            wall = time.perf_counter() - t0
        finally:
            if src is not None:
                src.close()
        mine = None
        slowest = [wall, setup_s, 0, 0.0, 0.0]
        summed = [0, 0, 0, 0, 0, 0]
        if src is not None:
            mine = dict(core.counters(carry), assigned=carry.assigned.cpu().numpy(), hi=src.hi.copy())
            slowest = [wall, setup_s + run_chunk.capture_s, run_chunk.warmup_steps,
                       src.h2d_wait_s, src.prestage_wall_s]
            summed = [src.h2d_rows, src.h2d_bytes, src.refill_spans, src.spans_prestaged,
                      src.spans_missed, len(src.ring_addrs)]
        out_all, slowest, summed = self._gather(mine, slowest, summed)
        wall, setup_s, warmup, h2d_wait_s, prestage_wall_s = slowest
        h2d_rows, h2d_bytes, refill_spans, prestaged, missed, ring_addrs = summed
        self.ring_handle = RingHandle(buf=buf, hi=out_all["hi"], B=self.source.B, z=self.z,
                                      m_per=self.m_per.copy())
        return DriveResult(
            sidx=None,
            p=None,
            w_trace=None,
            assigned=out_all["assigned"],
            score_rows=out_all["score_rows"],
            final_w=out_all["final_w"],
            lam=out_all["lam"],
            cost_per_score=out_all["cost_per_score"],
            wall_time_s=wall,
            r_sel=self.r_sel,
            backend=self.backend,
            n_shards=self.n_shards,
            scan_calls=iters,
            steps_run=iters * S,
            warmup_steps=int(warmup),
            setup_s=setup_s,
            h2d_rows=int(h2d_rows),
            h2d_bytes=int(h2d_bytes),
            buffer_rows=self.source.B,
            scan_steps_per_call=S,
            steps_per_graph=self.steps_per_graph,
            h2d_wait_s=h2d_wait_s,
            prefetch_depth=self.source.prefetch,
            refill_spans=int(refill_spans),
            spans_prestaged=int(prestaged),
            spans_missed=int(missed),
            prestage_wall_s=prestage_wall_s,
            ring_addrs=int(ring_addrs),
        )

    def run(
        self,
        *,
        n_chunks: int = 8,
        on_assign: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
    ) -> DriveResult:
        """Drive the scan to completion.

        Resident sources step through ``n_chunks`` provisioned scan calls
        (+ drain) and return the collected step outputs; file sources loop
        refill → scan until every instance has assigned its stream, emitting
        finished placements through ``on_assign(i, local_idx, p)`` (required
        — the file path never holds O(m) outputs).
        """
        if self.source.resident:
            return self._run_resident(n_chunks)
        if on_assign is None:
            raise ValueError("file-mode driving requires on_assign")
        return self._run_ring(on_assign)

    def stats_base(self, res: DriveResult, instance: int) -> dict:
        """The JAX driver's per-instance stat fields, plus the port's
        ``steps_run``, ``warmup_steps``, ``setup_s``, ``steps_per_graph`` and
        ``device``; after a file drive also ``ring_addrs`` and
        ``ring_handle`` (the ring a later pass may adopt)."""
        ring = {} if self.source.resident else dict(
            ring_addrs=res.ring_addrs, ring_handle=self.ring_handle)
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
            h2d_wait_s=res.h2d_wait_s,
            prefetch_depth=res.prefetch_depth,
            refill_spans=res.refill_spans,
            spans_prestaged=res.spans_prestaged,
            spans_missed=res.spans_missed,
            prestage_wall_s=res.prestage_wall_s,
            steps_run=res.steps_run,
            warmup_steps=res.warmup_steps,
            setup_s=res.setup_s,
            steps_per_graph=res.steps_per_graph,
            device=str(self.device),
            **ring,
        )


def _snapshot(out: StepOut) -> tuple:
    """Device-side copies of one scan call's outputs (no host sync)."""
    return out.sidx.clone(), out.p.clone(), out.w_cap.clone()


class _HostCopy:
    """Host copies of a fixed set of device tensors, taken once per scan
    call. ``start`` enqueues the copies (into pinned buffers on the card, so
    they are asynchronous) and records an event; ``wait`` synchronises on
    that event alone and returns numpy views of the buffers, valid until the
    next ``start``."""

    def __init__(self, tensors: Sequence[torch.Tensor], device: torch.device) -> None:
        pin = device.type == "cuda"
        self.src = tuple(tensors)
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in self.src)
        self.ready = torch.cuda.Event() if pin else None

    def start(self) -> None:
        for h, d in zip(self.host, self.src):
            h.copy_(d, non_blocking=self.ready is not None)
        if self.ready is not None:
            self.ready.record()

    def wait(self) -> Tuple[np.ndarray, ...]:
        if self.ready is not None:
            self.ready.synchronize()
        return tuple(h.numpy() for h in self.host)


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
