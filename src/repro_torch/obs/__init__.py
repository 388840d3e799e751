"""Host-side tracing of the port's partition pipeline.

A copy of the JAX package's ``obs`` (standard library only): the same span
model, tracks and Chrome trace-event export, so traces of the two
packages open side by side in Perfetto.

    from repro_torch.obs import Tracer
    tr = Tracer()
    res = partition_stream(edges, n, cfg, trace=tr)
    tr.export("trace.json")          # open in https://ui.perfetto.dev
    print(res.stats["trace_summary"])
"""
from .export import chrome_trace, export_chrome_trace, validate_chrome_trace
from .tracer import (
    NULL_TRACER,
    NullTracer,
    SpanRecord,
    Tracer,
    TraceSummary,
    resolve_tracer,
)

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "resolve_tracer",
    "TraceSummary",
    "SpanRecord",
    "chrome_trace",
    "export_chrome_trace",
    "validate_chrome_trace",
]
