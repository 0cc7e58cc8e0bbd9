"""Request tracing, metrics exposition and the observability planes.

Port of ratelimit_tpu/observability/, standard library and numpy only,
with the same exports:

- ``trace``:      spans, W3C traceparent, sampling, the trace ring,
                  JSONL/log exporters, and the process-wide TRACER.
- ``prometheus``: text exposition for ``GET /metrics``.
- ``tracez``:     ``GET /debug/tracez`` rendering.
- ``hotkeys``:    Space-Saving top-K sketch of the hottest descriptor
                  stems (``GET /debug/hotkeys``).
- ``flight``:     lock-free per-request decision ring (the black box
                  the detectors snapshot into incident reports).
- ``detectors``:  EWMA-baselined anomaly triggers + incident capture
                  (``GET /debug/incidents``).
- ``slo``:        per-domain availability/latency SLIs and error-
                  budget burn rates (``GET /debug/slo``).
- ``events``:     bounded lifecycle event journal — the ordered
                  timeline behind an incident (``GET /debug/events``).
- ``launches``:   lock-free per-LAUNCH device-batch ring — the
                  dispatch timeline (``GET /debug/launches``).
- ``timeseries``: in-process bounded time-series store — capacity /
                  latency history (``GET /debug/timeseries``).
"""

from .detectors import (
    AnomalyDetectors,
    Detector,
    ErrorRateDetector,
    Ewma,
    LatencySpikeDetector,
    OverLimitSurgeDetector,
    QueueSaturationDetector,
)
from .events import EVENT_TYPES, EventJournal, make_event_journal
from .flight import (
    CORR_HEADER,
    FLIGHT_CODE_DEGRADED,
    FLIGHT_CODE_FALLBACK,
    FLIGHT_CODE_FORWARDED,
    FLIGHT_CODE_SHED,
    FLIGHT_DTYPE,
    FlightRecorder,
    format_corr,
    make_flight_recorder,
    mint_corr,
    parse_corr,
)
from .hotkeys import HotKeyEntry, HotKeySketch
from .launches import (
    LAUNCH_DTYPE,
    OUTCOME_FALLBACK,
    OUTCOME_FAULT,
    OUTCOME_OK,
    LaunchRecorder,
    make_launch_recorder,
)
from .slo import SloEngine
from .timeseries import (
    TimeSeriesStore,
    make_timeseries,
    register_default_series,
)
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
    "CORR_HEADER",
    "EVENT_TYPES",
    "NOOP_SPAN",
    "TRACEPARENT_HEADER",
    "AnomalyDetectors",
    "Detector",
    "ErrorRateDetector",
    "EventJournal",
    "Ewma",
    "FLIGHT_CODE_DEGRADED",
    "FLIGHT_CODE_FALLBACK",
    "FLIGHT_CODE_FORWARDED",
    "FLIGHT_CODE_SHED",
    "FLIGHT_DTYPE",
    "FinishedTrace",
    "FlightRecorder",
    "HotKeyEntry",
    "HotKeySketch",
    "JsonlExporter",
    "LAUNCH_DTYPE",
    "LatencySpikeDetector",
    "LaunchRecorder",
    "OUTCOME_FALLBACK",
    "OUTCOME_FAULT",
    "OUTCOME_OK",
    "OverLimitSurgeDetector",
    "QueueSaturationDetector",
    "SloEngine",
    "Span",
    "SpanContext",
    "TRACER",
    "Tracer",
    "TimeSeriesStore",
    "format_corr",
    "format_traceparent",
    "log_exporter",
    "make_event_journal",
    "make_flight_recorder",
    "make_launch_recorder",
    "make_timeseries",
    "mint_corr",
    "parse_corr",
    "parse_traceparent",
    "register_default_series",
]
