"""Anomaly detectors + incident capture: the self-dumping black box.

Port of ratelimit_tpu/observability/detectors.py, unchanged.  Nothing
here reads a bank's tensors: a tick and a capture read host counters,
histograms and rings only, so a stalled CUDA stream never holds the
sampler.  The ``overload`` seam carries trips and ticks to the
overload controller (overload/controller.py) when the runner builds one.

A sampler thread evaluates EWMA-baselined triggers once per
``ANOMALY_INTERVAL_S`` tick:

- **latency-spike**:   delta-p99 of the ShouldRateLimit response
  histogram vs its EWMA baseline;
- **over-limit-surge**: per-domain OVER_LIMIT fraction (from the SLO
  engine's window rollups) vs its per-domain baseline;
- **queue-saturation**: dispatcher intake high-water mark since the
  last tick vs an absolute depth threshold;
- **error-rate**:      service/backend error fraction of total
  requests this tick vs an absolute threshold.

On trip, the detector atomically snapshots the evidence — the flight
recorder ring (observability/flight.py), the slowest committed traces
(the /debug/tracez source), every live counter/gauge, and the SLO
summary — into a bounded incident report: an in-memory ring (served
at ``GET /debug/incidents``) and, when ``INCIDENT_DIR`` is set, an
on-disk JSON file with the oldest files pruned past ``INCIDENT_MAX``.
Capture happens at trip time, on the sampler thread, so the ring still
holds the decisions AROUND the anomaly — the entire point of a flight
recorder (waiting for an operator would let the ring lap the evidence).

Per-detector cooldowns keep one incident per episode instead of one
per tick.  All interval/cooldown math runs on the injectable monotonic
clock seam (utils/time.py), so tests drive ticks with synthetic time —
no sleeps (tests/test_torch_slo_detectors.py).

Thresholds are constructor/env knobs; docs/INCIDENT_RUNBOOK.md covers
tuning them and reading the reports.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..stats.manager import StatsStore
from ..utils.time import MonotonicClock, REAL_MONOTONIC

logger = logging.getLogger("ratelimit.detectors")


class Ewma:
    """Exponentially weighted moving average with a None cold state:
    the first observation seeds the baseline (never trips), so a
    detector cannot fire on its own startup transient."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        if self.value is None:
            self.value = float(x)
        else:
            self.value += self.alpha * (float(x) - self.value)
        return self.value


def quantile_from_counts(bounds, counts, q: float) -> float:
    """Quantile by in-bucket linear interpolation over a DELTA bucket
    vector (same math as stats.Histogram._quantile, but usable on the
    per-tick difference of two cumulative snapshots)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cumulative = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cumulative + c >= rank:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * (rank - cumulative) / c
        cumulative += c
    return bounds[-1]


class Detector:
    """One trigger.  ``evaluate()`` returns a human-readable reason
    when tripped, else None; baseline state lives on the instance."""

    name = "detector"

    def evaluate(self) -> Optional[str]:
        raise NotImplementedError


class LatencySpikeDetector(Detector):
    """Delta-p99 of a response histogram vs its EWMA baseline."""

    name = "latency_spike"

    def __init__(
        self,
        histogram,
        factor: float = 4.0,
        min_samples: int = 20,
        min_p99_ms: float = 1.0,
        alpha: float = 0.3,
    ):
        self.histogram = histogram
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self.min_p99_ms = float(min_p99_ms)
        self.baseline = Ewma(alpha)
        self._last_counts: Optional[list] = None

    def evaluate(self) -> Optional[str]:
        bounds, counts, _sum, _count = self.histogram.snapshot()
        last, self._last_counts = self._last_counts, counts
        if last is None:
            return None
        delta = [c - p for c, p in zip(counts, last)]
        n = sum(delta)
        if n < self.min_samples:
            return None
        p99 = quantile_from_counts(bounds, delta, 0.99)
        base = self.baseline.value  # pre-update: the spike must not
        self.baseline.update(p99)  # drag its own baseline up first
        if base is None:
            return None
        if p99 > self.min_p99_ms and p99 > self.factor * base:
            return (
                f"p99 latency {p99:.2f}ms over {n} requests is "
                f">{self.factor:g}x the {base:.2f}ms baseline"
            )
        return None


class OverLimitSurgeDetector(Detector):
    """Per-domain OVER_LIMIT fraction vs its EWMA baseline (one
    baseline per domain; domains are bounded by the SLO engine)."""

    name = "over_limit_surge"

    def __init__(
        self,
        slo,
        factor: float = 4.0,
        min_requests: int = 20,
        min_rate: float = 0.2,
        alpha: float = 0.3,
    ):
        self.slo = slo
        self.factor = float(factor)
        self.min_requests = int(min_requests)
        self.min_rate = float(min_rate)
        self.alpha = float(alpha)
        self._baselines: Dict[str, Ewma] = {}
        self._last: Dict[str, tuple] = {}  # domain -> (over, requests)

    def evaluate(self) -> Optional[str]:
        reasons = []
        for domain, s in self.slo.stats_by_domain().items():
            over, requests = s.over_limit, s.requests
            last_over, last_req = self._last.get(domain, (over, requests))
            self._last[domain] = (over, requests)
            d_req = requests - last_req
            if d_req < self.min_requests:
                continue
            rate = (over - last_over) / d_req
            ewma = self._baselines.get(domain)
            if ewma is None:
                ewma = self._baselines[domain] = Ewma(self.alpha)
            base = ewma.value
            ewma.update(rate)
            if base is None:
                continue
            if rate > self.min_rate and rate > self.factor * max(base, 0.01):
                reasons.append(
                    f"domain {domain!r}: OVER_LIMIT rate {rate:.1%} over "
                    f"{d_req} requests (baseline {base:.1%})"
                )
        return "; ".join(reasons) if reasons else None


class QueueSaturationDetector(Detector):
    """Dispatcher intake depth high-water mark since the last tick vs
    an absolute threshold (fed by the dispatcher's per-tick drain seam
    so a between-scrapes burst is not invisible)."""

    name = "queue_saturation"

    def __init__(self, depth_fn: Callable[[], int], threshold: int = 512):
        self.depth_fn = depth_fn
        self.threshold = int(threshold)

    def evaluate(self) -> Optional[str]:
        depth = int(self.depth_fn())
        if depth >= self.threshold:
            return (
                f"dispatcher queue depth hwm {depth} >= "
                f"{self.threshold} since last tick"
            )
        return None


class ErrorRateDetector(Detector):
    """Service/backend error fraction of total requests per tick."""

    name = "error_rate"

    def __init__(
        self,
        store: StatsStore,
        threshold: float = 0.05,
        min_errors: int = 5,
        scope: str = "ratelimit.service.call.should_rate_limit",
        requests_counter: str = "ratelimit_server.ShouldRateLimit.total_requests",
    ):
        self.store = store
        self.threshold = float(threshold)
        self.min_errors = int(min_errors)
        self._error_counters = (
            store.counter(scope + ".redis_error"),
            store.counter(scope + ".service_error"),
        )
        self._requests = store.counter(requests_counter)
        self._last_errors = 0
        self._last_requests = 0

    def evaluate(self) -> Optional[str]:
        errors = sum(c.value() for c in self._error_counters)
        requests = self._requests.value()
        d_err = errors - self._last_errors
        d_req = requests - self._last_requests
        self._last_errors, self._last_requests = errors, requests
        if d_err < self.min_errors:
            return None
        rate = d_err / max(d_req, d_err)
        if rate > self.threshold:
            return (
                f"{d_err} backend/service errors over {max(d_req, d_err)} "
                f"requests ({rate:.1%} > {self.threshold:.1%})"
            )
        return None


class AnomalyDetectors:
    """Owns the detector set, the sampler thread, and incident capture
    (module docstring).  ``tick()`` is the deterministic seam tests and
    the smoke script drive directly."""

    def __init__(
        self,
        store: StatsStore,
        detectors: List[Detector],
        flight=None,
        tracer=None,
        slo=None,
        incident_dir: str = "",
        incident_max: int = 16,
        interval_s: float = 5.0,
        cooldown_s: float = 60.0,
        clock: Optional[MonotonicClock] = None,
        overload=None,
        events=None,
        timeseries=None,
    ):
        """``overload`` (overload/controller.py), when wired, rides
        the sampler: every TRIPPED detector evaluation is forwarded to
        ``overload.on_detector_trip`` (before cooldown gating — the
        backpressure hold must keep extending while the condition
        persists, even when no new incident is captured), and
        ``overload.tick()`` runs once per sampler tick after the
        detectors, so control actions use this tick's signals.
        ``events`` (observability/events.py), when wired, folds the
        journal's live window into every incident capture — the
        lifecycle narrative next to the decision evidence — and stamps
        the capture itself onto the timeline.  ``timeseries``
        (observability/timeseries.py), when wired, embeds the bounded
        per-series {last,avg,max} digest — was RSS climbing, what was
        the launch rate — next to the same evidence."""
        self.store = store
        self.detectors = list(detectors)
        self.flight = flight
        self.tracer = tracer
        self.slo = slo
        self.overload = overload
        self.events = events
        self.timeseries = timeseries
        self.incident_dir = incident_dir
        self.incident_max = max(1, int(incident_max))
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or REAL_MONOTONIC
        self._incidents: deque = deque(maxlen=self.incident_max)
        self._last_trip: Dict[str, float] = {}
        self._seq = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Stats-only tallies (register_stats): captured total and per
        # detector — a bounded family (the detector set is fixed).
        self.captured = 0
        self._captured_by: Dict[str, int] = {
            d.name: 0 for d in self.detectors
        }
        if incident_dir:
            os.makedirs(incident_dir, exist_ok=True)

    # -- evaluation -------------------------------------------------------

    def tick(self) -> List[dict]:
        """One sampler pass: roll the SLO windows, evaluate every
        detector, capture an incident per tripped detector outside its
        cooldown.  Returns the incidents captured this tick."""
        if self.slo is not None:
            self.slo.roll()
        now = self.clock.now()
        captured = []
        for d in self.detectors:
            try:
                reason = d.evaluate()
            except Exception:
                logger.exception("detector %s failed", d.name)
                continue
            if reason is None:
                continue
            if self.overload is not None:
                self.overload.on_detector_trip(d.name, reason)
            last = self._last_trip.get(d.name)
            if last is not None and now - last < self.cooldown_s:
                continue
            self._last_trip[d.name] = now
            captured.append(self._capture(d.name, reason))
        if self.overload is not None:
            self.overload.tick()
        return captured

    def _capture(self, detector: str, reason: str) -> dict:
        """Snapshot the black box NOW, on the sampler thread."""
        seq = next(self._seq)
        incident = {
            "id": f"incident-{seq:06d}-{detector}",
            "detector": detector,
            "reason": reason,
            "captured_unix": time.time(),  # display stamp, not duration
            "captured_monotonic": self.clock.now(),
            "ring": (
                self.flight.snapshot_dicts()
                if self.flight is not None
                else []
            ),
            "slowest_traces": (
                [t.as_dict() for t in self.tracer.slowest()]
                if self.tracer is not None
                else []
            ),
            "counters": self.store.counters(),
            "gauges": self.store.gauges(),
            "slo": self.slo.summary() if self.slo is not None else None,
            # The lifecycle narrative around the anomaly (events.py):
            # quarantines, floor moves, reloads — time-ordered, so the
            # report answers "what was CHANGING when this tripped".
            "events": (
                self.events.snapshot()
                if self.events is not None
                else []
            ),
            # The capacity/latency history digest (timeseries.py):
            # bounded per-series {last,avg,max} — answers "was this
            # building up" without shipping the whole ring.
            "timeseries": (
                self.timeseries.summary()
                if self.timeseries is not None
                else {}
            ),
        }
        self._incidents.append(incident)
        self.captured += 1
        self._captured_by[detector] = self._captured_by.get(detector, 0) + 1
        logger.error(
            "anomaly detector %s tripped: %s (incident %s)",
            detector,
            reason,
            incident["id"],
        )
        if self.events is not None:
            # AFTER the snapshot above on purpose: the incident's own
            # entry belongs to the NEXT capture's window, not its own.
            self.events.emit(
                "incident",
                incident=incident["id"],
                detector=detector,
                reason=reason,
            )
        if self.incident_dir:
            self._write_incident(incident)
        return incident

    def _write_incident(self, incident: dict) -> None:
        try:
            name = (
                f"incident_{int(incident['captured_unix'])}_"
                f"{incident['id']}.json"
            )
            path = os.path.join(self.incident_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(incident, f, indent=1, default=str)
            os.replace(tmp, path)  # readers never see a partial report
            self._prune_files()
        except OSError:
            logger.exception("failed to write incident report")

    def _prune_files(self) -> None:
        files = sorted(
            f
            for f in os.listdir(self.incident_dir)
            if f.startswith("incident_") and f.endswith(".json")
        )
        for stale in files[: -self.incident_max]:
            try:
                os.unlink(os.path.join(self.incident_dir, stale))
            except OSError:
                pass

    # -- read surface -----------------------------------------------------

    def incidents(self) -> List[dict]:
        """Retained incidents, newest first (``GET /debug/incidents``)."""
        return list(self._incidents)[::-1]

    def register_stats(self, store, scope: str = "ratelimit.incidents") -> None:
        store.counter_fn(scope + ".captured", lambda: self.captured)
        store.gauge_fn(scope + ".retained", lambda: len(self._incidents))
        for name in self._captured_by:
            store.counter_fn(
                scope + "." + name,
                lambda n=name: self._captured_by.get(n, 0),
            )

    # -- sampler thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._loop, name="anomaly-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("anomaly sampler tick failed")
