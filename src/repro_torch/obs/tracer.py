"""Host-side span tracer for the streaming-partition pipeline.

Copy of the JAX package's ``obs/tracer.py`` (standard library only), so
the port records the same spans without importing that package.

Span model
----------
A *span* is a named interval ``[t0, t1]`` on the monotonic clock
(``time.perf_counter``), tagged with a category and structured attrs and
placed on a *track*. Tracks default to the recording thread's name (the
main stepping loop records onto ``main``, the read-ahead worker onto
``adwise-readahead``); callers can override with ``track=`` to create
virtual lanes (restream passes use ``restream-pass-<j>``). Nesting is
by timestamp containment per track — exactly how Perfetto renders
Chrome trace events — so spans carry no explicit parent pointers.

Two recording paths, by temperature:

* ``with tracer.span(name, cat=...):`` — context manager, for coarse
  spans (passes, phases, supersteps, CLI sections).
* ``tracer.add_span(name, cat, t0, t1)`` — explicit timestamps, for hot
  loops. The caller takes ``perf_counter()`` itself, which lets a span
  share the *exact* float pair that also feeds a stats counter (e.g. the
  blocking-refill span reuses the timestamps behind ``h2d_wait_s``), so
  category wall totals reconcile with the scalar counters bit-for-bit.

Overhead contract
-----------------
Hot paths gate on ``tracer.enabled`` (a plain class attribute — one
attribute load) and only then take timestamps or build attr dicts. With
tracing disabled callers hold :data:`NULL_TRACER`, a module-level
singleton whose ``span()`` returns a shared no-op span object: the
disabled path allocates nothing per call and records nothing, which is
what lets the driver keep a tracer on its hottest loops unconditionally.

Everything here is host-side and stdlib-only by design: spans must wrap
dispatch and host waits only — never values still on device. Calling the
tracer *inside* a step closure would run once at capture and never on a
CUDA-graph replay (or, eagerly, add a per-step host call);
``tools/staticcheck`` rule SC003 flags exactly that (see
``tools/staticcheck/README.md``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "resolve_tracer",
    "TraceSummary",
    "SpanRecord",
]


class SpanRecord(NamedTuple):
    """One recorded interval. ``t0``/``t1`` are perf_counter seconds."""

    name: str
    cat: str
    track: str
    thread: str
    t0: float
    t1: float
    attrs: Dict[str, Any]


class InstantRecord(NamedTuple):
    name: str
    cat: str
    track: str
    thread: str
    t: float
    attrs: Dict[str, Any]


class CounterRecord(NamedTuple):
    name: str
    track: str
    t: float
    value: float


class TraceSummary(NamedTuple):
    """Per-category wall totals over a tracer's recorded spans.

    ``categories`` maps category -> ``{"count": n, "wall_s": total}``;
    the totals are sums of span durations (concurrent spans in one
    category double-count, by design — they reconcile with the *scalar*
    counters, which accumulate the same way: the ``refill`` category
    total equals ``h2d_wait_s``, the ``stage`` total equals
    ``prestage_wall_s``, and the ``scan`` count equals ``scan_calls``).
    """

    events: int
    wall_s: float
    categories: Dict[str, Dict[str, float]]
    tracks: Tuple[str, ...]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "events": self.events,
            "wall_s": self.wall_s,
            "categories": self.categories,
            "tracks": list(self.tracks),
        }


class _Span:
    """Context-manager span; records itself on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_attrs", "_t0")

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        cat: str,
        track: Optional[str],
        attrs: Dict[str, Any],
    ) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs: Any) -> "_Span":
        """Attach attrs discovered mid-span (e.g. per-pass quality)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._tracer.add_span(
            self._name,
            self._cat,
            self._t0,
            time.perf_counter(),
            track=self._track,
            attrs=self._attrs,
        )


class _NullSpan:
    """Shared no-op span: zero allocation on the disabled path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans/instants/counters; thread-safe; export-ready.

    The epoch ``t0`` is taken at construction; exported timestamps are
    relative to it. All recording methods may be called from any thread.
    """

    enabled: bool = True

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.spans: List[SpanRecord] = []
        self.instants: List[InstantRecord] = []
        self.counters: List[CounterRecord] = []

    # -- recording ---------------------------------------------------------
    def _track(self, track: Optional[str]) -> str:
        if track is not None:
            return track
        name = threading.current_thread().name
        return "main" if name == "MainThread" else name

    def span(
        self, name: str, cat: str = "misc", track: Optional[str] = None, **attrs: Any
    ) -> _Span:
        """Open a context-manager span (coarse path)."""
        return _Span(self, name, cat, track, attrs)

    def add_span(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        track: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a finished interval with caller-taken timestamps."""
        rec = SpanRecord(
            name,
            cat,
            self._track(track),
            threading.current_thread().name,
            t0,
            t1,
            attrs if attrs is not None else {},
        )
        with self._lock:
            self.spans.append(rec)

    def instant(
        self, name: str, cat: str = "misc", track: Optional[str] = None, **attrs: Any
    ) -> None:
        rec = InstantRecord(
            name,
            cat,
            self._track(track),
            threading.current_thread().name,
            time.perf_counter(),
            attrs,
        )
        with self._lock:
            self.instants.append(rec)

    def gauge(self, name: str, value: float, track: Optional[str] = None) -> None:
        rec = CounterRecord(name, self._track(track), time.perf_counter(), float(value))
        with self._lock:
            self.counters.append(rec)

    # -- reading -----------------------------------------------------------
    def summary(self) -> TraceSummary:
        """Per-category totals over everything recorded so far.

        Cumulative over the tracer's lifetime: a tracer threaded through
        several restream passes summarizes all of them.
        """
        with self._lock:
            spans = list(self.spans)
            n_other = len(self.instants) + len(self.counters)
        cats: Dict[str, Dict[str, float]] = {}
        tracks: Dict[str, None] = {}
        lo, hi = float("inf"), float("-inf")
        for s in spans:
            c = cats.setdefault(s.cat, {"count": 0, "wall_s": 0.0})
            c["count"] += 1
            c["wall_s"] += s.t1 - s.t0
            tracks.setdefault(s.track)
            lo, hi = min(lo, s.t0), max(hi, s.t1)
        return TraceSummary(
            events=len(spans) + n_other,
            wall_s=(hi - lo) if spans else 0.0,
            categories=cats,
            tracks=tuple(tracks),
        )

    def export(self, path: str) -> int:
        """Write a Chrome trace-event JSON; returns the event count."""
        from .export import export_chrome_trace

        return export_chrome_trace(self, path)


class NullTracer:
    """API-compatible no-op. ``enabled`` is False; hot paths branch on it
    and skip even timestamp-taking; the coarse path gets a shared no-op
    span object, so the disabled path allocates nothing per call."""

    __slots__ = ()
    enabled: bool = False
    t0: float = 0.0

    def span(
        self, name: str, cat: str = "misc", track: Optional[str] = None, **attrs: Any
    ) -> _NullSpan:
        return _NULL_SPAN

    def add_span(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        track: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        return None

    def instant(
        self, name: str, cat: str = "misc", track: Optional[str] = None, **attrs: Any
    ) -> None:
        return None

    def gauge(self, name: str, value: float, track: Optional[str] = None) -> None:
        return None

    def summary(self) -> TraceSummary:
        return TraceSummary(events=0, wall_s=0.0, categories={}, tracks=())

    def export(self, path: str) -> int:
        raise RuntimeError("cannot export from a NullTracer (tracing is disabled)")


NULL_TRACER = NullTracer()


def resolve_tracer(trace: Any) -> Any:
    """``None`` -> the module-level null singleton; anything else passes
    through. The single entry point every ``trace=`` kwarg funnels into."""
    return NULL_TRACER if trace is None else trace
