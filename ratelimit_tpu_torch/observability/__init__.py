"""Request tracing + metrics exposition.

Port of the parts of ratelimit_tpu/observability/ that the HTTP and
debug listeners need, standard library only:

- ``trace``:      spans, W3C traceparent, sampling, the trace ring,
                  JSONL/log exporters, and the process-wide TRACER.
- ``prometheus``: text exposition for ``GET /metrics``.
- ``tracez``:     ``GET /debug/tracez`` rendering.

The flight recorder, SLO engine, event journal, launch recorder, time
series, anomaly detectors and hot-key sketch are not ported yet
(ROADMAP.md, Queue 1, observability and overload).
"""

from .trace import (
    NOOP_SPAN,
    TRACEPARENT_HEADER,
    FinishedTrace,
    JsonlExporter,
    Span,
    SpanContext,
    TRACER,
    Tracer,
    format_traceparent,
    log_exporter,
    parse_traceparent,
)

__all__ = [
    "NOOP_SPAN",
    "TRACEPARENT_HEADER",
    "FinishedTrace",
    "JsonlExporter",
    "Span",
    "SpanContext",
    "TRACER",
    "Tracer",
    "format_traceparent",
    "log_exporter",
    "parse_traceparent",
]
