"""Chrome trace-event JSON export + schema validation.

Copy of the JAX package's ``obs/export.py`` (standard library only).

Emits the JSON-object flavor of the Chrome trace-event format:
``{"traceEvents": [...]}`` with

* ``"X"`` complete events (one per span: ``ts``/``dur`` in microseconds
  relative to the tracer's epoch),
* ``"i"`` instant events,
* ``"C"`` counter events (gauges render as counter tracks),
* ``"M"`` metadata events naming the process and one thread per track.

Load the file at https://ui.perfetto.dev or chrome://tracing. Perfetto
nests ``X`` events on a track by timestamp containment, so the span tree
needs no explicit depth. Tracks map to synthetic tids in first-seen
order; virtual lanes (e.g. ``restream-pass-2``) are just extra tids.

``validate_chrome_trace`` is the schema check ``chip_smoke.py`` runs on
its traced run's export; tests import it too.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

__all__ = ["chrome_trace", "export_chrome_trace", "validate_chrome_trace"]

_PID = 1


def _san(v: Any) -> Any:
    """JSON-safe attr values. numpy scalars arrive because hot-loop spans
    must not call int()/float() on host mirrors of traced values (that is
    an SC003 sync pattern); they are unwrapped here, at export time."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(v)


def chrome_trace(tracer: Any) -> Dict[str, Any]:
    """Build the trace-event document from a :class:`~repro_torch.obs.Tracer`."""
    with tracer._lock:
        spans = list(tracer.spans)
        instants = list(tracer.instants)
        counters = list(tracer.counters)
    epoch = tracer.t0
    tids: Dict[str, int] = {}

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
        return tids[track]

    def us(t: float) -> float:
        return round((t - epoch) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    for s in spans:
        events.append(
            {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": us(s.t0),
                "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
                "pid": _PID,
                "tid": tid(s.track),
                "args": {k: _san(v) for k, v in s.attrs.items()},
            }
        )
    for i in instants:
        events.append(
            {
                "name": i.name,
                "cat": i.cat,
                "ph": "i",
                "s": "t",
                "ts": us(i.t),
                "pid": _PID,
                "tid": tid(i.track),
                "args": {k: _san(v) for k, v in i.attrs.items()},
            }
        )
    for c in counters:
        events.append(
            {
                "name": c.name,
                "ph": "C",
                "ts": us(c.t),
                "pid": _PID,
                "tid": tid(c.track),
                "args": {c.name: c.value},
            }
        )
    events.sort(key=lambda e: e["ts"])
    meta: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": _PID,
            "args": {"name": "adwise-pipeline"},
        }
    ]
    for track, t in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": t,
                "args": {"name": track},
            }
        )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(tracer: Any, path: str) -> int:
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"), default=str)
    return len(doc["traceEvents"])


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema check: required keys per phase, non-negative monotonic ts.

    Returns a list of human-readable problems (empty == valid). This is
    the gate ``chip_smoke.py`` applies to its traced run's export.
    """
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["document is not an object with a 'traceEvents' list"]
    last_ts = float("-inf")
    for n, e in enumerate(doc["traceEvents"]):
        if not isinstance(e, dict):
            errors.append(f"event {n}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            errors.append(f"event {n}: unknown ph {ph!r}")
            continue
        for key in ("name", "pid") + (() if ph == "M" else ("ts", "tid")):
            if key not in e:
                errors.append(f"event {n} (ph={ph}): missing key {key!r}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {n}: ts must be a non-negative number, got {ts!r}")
            continue
        if ts < last_ts:
            errors.append(f"event {n}: ts {ts} not monotonic (prev {last_ts})")
        last_ts = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {n}: X event needs non-negative dur, got {dur!r}")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            errors.append(f"event {n}: instant needs scope s in t/p/g")
    if not any(e.get("ph") == "X" for e in doc["traceEvents"] if isinstance(e, dict)):
        errors.append("no complete ('X') span events present")
    return errors
