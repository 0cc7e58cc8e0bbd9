"""In-process request tracing: spans, W3C traceparent, trace ring.

A copy of ratelimit_tpu/observability/trace.py (standard library only).

The reference (in later revisions) wraps every ShouldRateLimit in
OpenTelemetry spans; this is the dependency-free equivalent sized for
a serving hot path.  One request produces one trace: a root span
opened at the transport (gRPC handler / HTTP /json bridge) with child
spans for each serving phase — decode, service, backend dispatch,
kernel — so "where did THIS request's 40 ms go" has an answer without
attaching a profiler.

Design constraints, in order:

1. Near-zero cost when not recording.  ``Tracer.start_span`` returns
   the NOOP_SPAN singleton when tracing is disabled, and a discarded
   lightweight trace when the head-sampling decision says no and
   error-capture is off.  The per-request cost of an unsampled path is
   one attribute load, one RNG draw, and (gRPC only) a metadata scan.
2. No locks on the request path.  All spans of one request start and
   finish on the request's handler thread (the dispatcher's
   cross-thread leg is carried by perf_counter stamps in the WorkItem
   trace dict and converted to spans AFTER ``wait()`` returns, back on
   the handler thread), so the in-flight buffer is plain lists.  Only
   the finished-trace ring takes a lock, once per COMMITTED trace.
3. Errors and over-limit decisions are always interesting.  The
   sampling policy is head-probabilistic (TRACE_SAMPLE_RATE) with a
   tail override: a trace that ends in an error or OVER_LIMIT commits
   even when the head decision was "no" (``sample_errors``).  An
   inbound W3C ``traceparent`` with the sampled flag set forces the
   head decision to "yes" — upstream chose this request, we keep it.

Propagation is contextvar-based (``Tracer.span`` parents onto the
current span), which follows the handler thread without threading a
span argument through service/limiter/backends signatures.
"""

# tpu-lint: disable-file=shared-state -- spans/trace bufs are request-owned (contextvar-scoped, one thread); the shared rings mutate under _ring_lock
from __future__ import annotations

import contextvars
import json
import logging
import random
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("ratelimit.trace")

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

_rand = random.Random()
_rand_lock = threading.Lock()


def _gen_id(nbytes: int) -> str:
    # random.getrandbits under a lock: ~3x faster than os.urandom and
    # collision-safe enough for in-process trace ids (not security).
    with _rand_lock:
        return f"{_rand.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class SpanContext:
    """Parsed W3C trace-context identity: who called us, sampled or
    not (https://www.w3.org/TR/trace-context/)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """`00-<32hex>-<16hex>-<2hex>` -> SpanContext, or None on any
    malformation (a bad header must never fail the request)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    # version ff is forbidden; all-zero ids are invalid per spec.
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, bool(int(flags, 16) & 0x01))


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


class _NoopSpan:
    """Shared do-nothing span: the disabled/unsampled fast path."""

    __slots__ = ()
    recording = False
    sampled = False
    trace_id = ""
    span_id = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass

    def set_status(self, status, detail=""):
        pass

    def traceparent(self) -> str:
        return ""


NOOP_SPAN = _NoopSpan()


class _TraceBuf:
    """One request's in-flight trace accumulator (handler-thread
    only, so no lock — see module docstring)."""

    __slots__ = (
        "trace_id",
        "parent_id",
        "head_sampled",
        "spans",
        "start_unix",
        "seq",
    )

    def __init__(self, trace_id: str, parent_id: str, head_sampled: bool):
        self.trace_id = trace_id
        self.parent_id = parent_id  # upstream caller's span id ("" if root)
        self.head_sampled = head_sampled
        self.spans: List[dict] = []
        self.start_unix = time.time()  # display only, never duration math
        self.seq = 0  # child span id counter (see Span.__init__)

    def next_span_id(self) -> str:
        # Child span ids only need uniqueness WITHIN the trace (tree
        # edges + tracez rendering); a counter is ~10x cheaper than a
        # locked RNG draw per span.  The ROOT span id stays random —
        # it leaves the process in the outbound traceparent.
        self.seq += 1
        return f"{self.seq:016x}"


class Span:
    """A recording span; use as a context manager, or via
    ``Tracer.record_span`` for stamp-derived spans."""

    __slots__ = (
        "name",
        "span_id",
        "parent_id",
        "start",
        "end",
        "status",
        "detail",
        "attrs",
        "_buf",
        "_tracer",
        "_token",
        "_is_root",
    )

    def __init__(
        self,
        tracer: "Tracer",
        buf: _TraceBuf,
        name: str,
        parent_id: str,
        is_root: bool = False,
    ):
        self.name = name
        self.span_id = _gen_id(8) if is_root else buf.next_span_id()
        self.parent_id = parent_id
        self.start = 0.0
        self.end = 0.0
        self.status = "ok"
        self.detail = ""
        self.attrs: Optional[Dict[str, object]] = None
        self._buf = buf
        self._tracer = tracer
        self._token = None
        self._is_root = is_root

    recording = True

    @property
    def trace_id(self) -> str:
        return self._buf.trace_id

    @property
    def sampled(self) -> bool:
        """True when the HEAD decision chose this trace (inbound
        sampled flag or the probabilistic draw) — the signal outbound
        propagation keys on.  False on the error-capture-only path,
        which records locally but commits only on a bad ending."""
        return self._buf.head_sampled

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def set_status(self, status: str, detail: str = "") -> None:
        self.status = status
        self.detail = detail

    def traceparent(self) -> str:
        """Outbound W3C header continuing this trace."""
        return format_traceparent(
            self._buf.trace_id, self.span_id, self._buf.head_sampled
        )

    def __enter__(self) -> "Span":
        self.start = time.perf_counter()
        self._token = self._tracer._current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter()
        self._tracer._current.reset(self._token)
        if exc is not None and self.status == "ok":
            self.set_status("error", f"{type(exc).__name__}: {exc}")
        self._buf.spans.append(self._record())
        if self._is_root:
            self._tracer._commit(self._buf, self)
        return False  # never swallow

    def _record(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": (self.end - self.start) * 1e3,
            "status": self.status,
            "detail": self.detail,
            "attrs": self.attrs or {},
        }


class FinishedTrace:
    """An immutable committed trace (what the ring, tracez, and the
    exporters see)."""

    __slots__ = (
        "trace_id",
        "parent_id",
        "root_name",
        "status",
        "detail",
        "duration_ms",
        "start_unix",
        "sampled",
        "spans",
    )

    def __init__(self, buf: _TraceBuf, root: Span):
        self.trace_id = buf.trace_id
        self.parent_id = buf.parent_id
        self.root_name = root.name
        self.status = root.status
        self.detail = root.detail
        self.duration_ms = (root.end - root.start) * 1e3
        self.start_unix = buf.start_unix
        self.sampled = buf.head_sampled
        # Relative starts: absolute perf_counter values are meaningless
        # across processes; ms offsets from the root read directly.
        t0 = root.start
        self.spans = tuple(
            dict(s, start_ms=(s.pop("start") - t0) * 1e3) for s in buf.spans
        )

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "root": self.root_name,
            "status": self.status,
            "detail": self.detail,
            "duration_ms": round(self.duration_ms, 3),
            "start_unix": self.start_unix,
            "sampled": self.sampled,
            "spans": [
                dict(
                    s,
                    start_ms=round(s["start_ms"], 3),
                    duration_ms=round(s["duration_ms"], 3),
                )
                for s in self.spans
            ],
        }


class Tracer:
    """Owns the sampling policy, the current-span contextvar, the
    bounded finished-trace ring, and the exporter fan-out."""

    def __init__(
        self,
        sample_rate: float = 0.0,
        sample_errors: bool = True,
        enabled: bool = True,
        ring_size: int = 256,
        slow_size: int = 32,
    ):
        self._current: contextvars.ContextVar = contextvars.ContextVar(
            "ratelimit_current_span", default=None
        )
        self._ring_lock = threading.Lock()
        self._exporters: List[Callable[[FinishedTrace], None]] = []
        self.configure(
            sample_rate=sample_rate,
            sample_errors=sample_errors,
            enabled=enabled,
            ring_size=ring_size,
            slow_size=slow_size,
        )

    def configure(
        self,
        sample_rate: Optional[float] = None,
        sample_errors: Optional[bool] = None,
        enabled: Optional[bool] = None,
        ring_size: Optional[int] = None,
        slow_size: Optional[int] = None,
    ) -> None:
        """Re-point the policy knobs (runner startup; tests).  Resizing
        the ring drops its contents — acceptable at (re)configure time."""
        if sample_rate is not None:
            self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        if sample_errors is not None:
            self.sample_errors = bool(sample_errors)
        if enabled is not None:
            self.enabled = bool(enabled)
        if ring_size is not None or not hasattr(self, "_recent"):
            n = max(1, int(ring_size if ring_size is not None else 256))
            with self._ring_lock:
                self._recent: deque = deque(maxlen=n)
        if slow_size is not None or not hasattr(self, "_slow"):
            n = max(1, int(slow_size if slow_size is not None else 32))
            with self._ring_lock:
                self._slow: List[FinishedTrace] = []
                self._slow_size = n

    # -- span creation ---------------------------------------------------

    def start_span(
        self, name: str, traceparent: Optional[str] = None
    ) -> Span:
        """Open a ROOT span for one request.  Decides sampling:
        inbound sampled flag wins, else probabilistic; unsampled
        requests still record when error-capture is on (committed only
        if they end in error/over-limit)."""
        if not self.enabled:
            return NOOP_SPAN  # type: ignore[return-value]
        ctx = parse_traceparent(traceparent)
        if ctx is not None and ctx.sampled:
            head = True
        elif self.sample_rate > 0.0:
            with _rand_lock:
                head = _rand.random() < self.sample_rate
        else:
            head = False
        if not head and not self.sample_errors:
            return NOOP_SPAN  # type: ignore[return-value]
        if ctx is not None:
            buf = _TraceBuf(ctx.trace_id, ctx.span_id, head)
            parent = ctx.span_id
        else:
            buf = _TraceBuf(_gen_id(16), "", head)
            parent = ""
        return Span(self, buf, name, parent, is_root=True)

    def span(self, name: str) -> Span:
        """Child span of the CURRENT span (contextvar); NOOP when
        nothing is recording on this thread."""
        cur = self._current.get()
        if cur is None or not cur.recording:
            return NOOP_SPAN  # type: ignore[return-value]
        return Span(self, cur._buf, name, cur.span_id)

    def current(self) -> Optional[Span]:
        """The recording span active on this thread, or None."""
        cur = self._current.get()
        return cur if cur is not None and cur.recording else None

    def record_span(
        self,
        name: str,
        start: float,
        end: float,
        attrs: Optional[dict] = None,
        parent: Optional[Span] = None,
    ) -> None:
        """Append a span from explicit perf_counter stamps — the
        cross-thread seam: the dispatcher stamps launch/complete into
        the WorkItem trace dict, and the waiting handler thread turns
        them into spans here after wait()."""
        p = parent if parent is not None else self._current.get()
        if p is None or not p.recording:
            return
        s = Span(self, p._buf, name, p.span_id)
        s.start, s.end = start, end
        if attrs:
            s.attrs = dict(attrs)
        p._buf.spans.append(s._record())

    # -- commit + retrieval ----------------------------------------------

    def _commit(self, buf: _TraceBuf, root: Span) -> None:
        if not (buf.head_sampled or root.status != "ok"):
            return  # recorded for the error policy, ended clean: drop
        trace = FinishedTrace(buf, root)
        with self._ring_lock:
            self._recent.append(trace)
            slow = self._slow
            if len(slow) < self._slow_size:
                slow.append(trace)
                slow.sort(key=lambda t: -t.duration_ms)
            elif trace.duration_ms > slow[-1].duration_ms:
                slow[-1] = trace
                slow.sort(key=lambda t: -t.duration_ms)
        for export in self._exporters:
            try:
                export(trace)
            except Exception:
                logger.exception("trace exporter failed")

    def recent(self) -> List[FinishedTrace]:
        with self._ring_lock:
            return list(self._recent)

    def slowest(self) -> List[FinishedTrace]:
        with self._ring_lock:
            return list(self._slow)

    def clear(self) -> None:
        with self._ring_lock:
            self._recent.clear()
            self._slow = []

    # -- exporters -------------------------------------------------------

    def add_exporter(self, fn: Callable[[FinishedTrace], None]) -> None:
        self._exporters.append(fn)

    def clear_exporters(self) -> None:
        self._exporters = []


class JsonlExporter:
    """Append one JSON line per committed trace to `path` (the
    poor-man's OTLP file exporter; ingest with jq / pandas)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def __call__(self, trace: FinishedTrace) -> None:
        line = json.dumps(trace.as_dict(), separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


def log_exporter(trace: FinishedTrace) -> None:
    """One INFO line per committed trace (grep-able breadcrumb)."""
    logger.info(
        "trace %s %s %.2fms status=%s spans=%d",
        trace.trace_id,
        trace.root_name,
        trace.duration_ms,
        trace.status,
        len(trace.spans),
    )


# The process-wide tracer, disabled-by-policy until the runner (or a
# test) configures it.  A module global rather than dependency
# injection for the same reason ``logging`` is: every serving layer
# participates, and threading a tracer through each signature would
# couple all of them to observability.
TRACER = Tracer(sample_rate=0.0, sample_errors=True, enabled=True)
