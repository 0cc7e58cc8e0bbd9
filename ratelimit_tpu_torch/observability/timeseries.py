"""In-process time-series store: bounded capacity/latency history.

Port of ratelimit_tpu/observability/timeseries.py, unchanged.  Every
series reads host state (counters, histograms, the engines' live-key
tallies, the dispatchers' intake), never a tensor on the card.

Counters and gauges answer "what is the value NOW"; an incident (and a
soak) needs "what was it over the last hour" — is RSS flat or
climbing, did slot occupancy step up with that config reload, what was
the launch rate when p99 spiked?  Production limiters keep exactly
this in-process (Monarch-style in-memory time series; Envoy's runtime
stats history), because the moment you need the history is the moment
the external scraper may not have been pointed here yet.

A fixed-interval sampler (``TSDB_INTERVAL_S``, thread + deterministic
``tick()`` seam like observability/detectors.py) snapshots three
source kinds into bounded numpy ring buffers sized by
``TSDB_RETENTION_S``:

- **gauges**      — a callable sampled verbatim (queue depth,
  slot_fill_pct, promotion/over-limit cache sizes, process RSS);
- **counters**    — a monotonic callable differentiated into a
  per-second rate on the injectable monotonic clock (decisions/s,
  launches/s, per-algo items/s);
- **histograms**  — delta-p99 between consecutive cumulative
  snapshots via detectors.quantile_from_counts (the per-phase serving
  latencies).

Write discipline: ``tick()`` has ONE writer (the sampler thread or a
test driving it directly).  Each tick writes its row's timestamp and
values first and publishes the row's seq LAST, so concurrent readers
(``GET /debug/timeseries``, incident capture, /fleet.json scrape)
window-check seqs exactly like the flight/launch rings and never see a
torn row.  Series registration happens during wiring, BEFORE the
sampler starts.

``TSDB_INTERVAL_S=0`` disables the store entirely (the runner builds
None; no thread, no route data).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.time import MonotonicClock, REAL_MONOTONIC
from .detectors import quantile_from_counts

__all__ = ["TimeSeriesStore", "make_timeseries", "register_default_series"]


class TimeSeriesStore:
    """Bounded multi-series ring sampler.  Construct via
    :func:`make_timeseries` (interval 0 maps to None)."""

    def __init__(
        self,
        interval_s: float = 5.0,
        retention_s: float = 3600.0,
        clock: Optional[MonotonicClock] = None,
        wall=None,
    ):
        if interval_s <= 0:
            raise ValueError("TimeSeriesStore interval must be positive")
        import time as _time

        self.interval_s = float(interval_s)
        self.retention_s = float(retention_s)
        self.slots = max(2, int(math.ceil(retention_s / interval_s)))
        self.clock = clock or REAL_MONOTONIC
        self._wall = wall or _time.time
        self._seqs = np.zeros(self.slots, np.int64)
        self._ts_unix = np.zeros(self.slots, np.float64)
        self._values: Dict[str, np.ndarray] = {}
        self._gauges: List[tuple] = []  # (name, fn)
        self._counters: List[list] = []  # [name, fn, last_value]
        self._hists: List[list] = []  # [name, hist, last_counts]
        self._hwm = 0  # published ticks (single writer)
        self._last_mono: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration (wiring time, before the sampler starts) -----------

    def _new_series(self, name: str) -> None:
        if name in self._values:
            raise ValueError(f"duplicate series {name!r}")
        self._values[name] = np.full(self.slots, np.nan)

    def add_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Sample ``fn()`` verbatim each tick."""
        self._new_series(name)
        self._gauges.append((name, fn))

    def add_counter(self, name: str, fn: Callable[[], float]) -> None:
        """Differentiate a monotonic ``fn()`` into a per-second rate
        (NaN on the seeding tick — a rate needs two observations)."""
        self._new_series(name)
        self._counters.append([name, fn, None])

    def add_histogram_p99(self, name: str, hist) -> None:
        """Per-tick delta-p99 of a stats.Histogram: the p99 of what
        was observed SINCE the last tick (NaN when nothing was)."""
        self._new_series(name)
        self._hists.append([name, hist, None])

    def series_names(self) -> List[str]:
        return sorted(self._values)

    # -- sampling ---------------------------------------------------------

    def tick(self) -> None:
        """One sampler pass (the deterministic seam tests drive)."""
        seq = self._hwm + 1
        row = (seq - 1) % self.slots
        now = self.clock.now()
        last, self._last_mono = self._last_mono, now
        dt = now - last if last is not None else 0.0
        values = self._values
        self._ts_unix[row] = self._wall()  # tpu-lint: disable=shared-state -- single-writer tick; readers window-check _seqs, published last
        for name, fn in self._gauges:
            try:
                values[name][row] = float(fn())
            except Exception:
                values[name][row] = np.nan
        for entry in self._counters:
            name, fn, prev = entry
            try:
                cur = float(fn())
            except Exception:
                values[name][row] = np.nan
                continue
            values[name][row] = (
                (cur - prev) / dt if prev is not None and dt > 0 else np.nan
            )
            entry[2] = cur
        for entry in self._hists:
            name, hist, prev = entry
            try:
                bounds, counts, _sum, _count = hist.snapshot()
            except Exception:
                values[name][row] = np.nan
                continue
            if prev is None:
                values[name][row] = np.nan
            else:
                delta = [c - p for c, p in zip(counts, prev)]
                values[name][row] = (
                    quantile_from_counts(bounds, delta, 0.99)
                    if sum(delta) > 0
                    else np.nan
                )
            entry[2] = counts
        # Publish LAST: readers window-check seqs, so a row is visible
        # only after every series value for it landed.
        self._seqs[row] = seq  # tpu-lint: disable=shared-state -- single-writer tick; the seq publish IS the row's visibility barrier
        self._hwm = seq  # tpu-lint: disable=shared-state -- single-writer tick counter; readers derive the window from _seqs

    # -- read surface -----------------------------------------------------

    def snapshot(
        self,
        since: int = 0,
        series: Optional[List[str]] = None,
    ) -> dict:
        """Columnar view of the live ticks with ``seq > since`` —
        the /debug/events cursor contract (pass the max seq you saw
        last time), one row per retained tick, oldest first.  NaN
        renders as None (JSON has no NaN)."""
        seqs = self._seqs.copy()
        hwm = int(seqs.max())
        names = (
            [n for n in series if n in self._values]
            if series is not None
            else self.series_names()
        )
        floor = max(int(since), 0, hwm - self.slots)
        live = np.nonzero(seqs > floor)[0]
        order = live[np.argsort(seqs[live], kind="stable")]
        cols: Dict[str, list] = {}
        for name in names:
            vals = self._values[name][order]
            cols[name] = [
                None if math.isnan(v) else round(v, 6) for v in vals.tolist()
            ]
        return {
            "seq": hwm,
            "interval_s": self.interval_s,
            "retention_s": self.retention_s,
            "seqs": seqs[order].tolist(),
            "ts_unix": [round(t, 3) for t in self._ts_unix[order].tolist()],
            "series": cols,
        }

    def summary(self) -> Dict[str, dict]:
        """Per-series {last, avg, max} over the live window — the
        sparkline digest /fleet.json and incident captures embed
        (bounded: one dict per registered series, no history)."""
        seqs = self._seqs.copy()
        hwm = int(seqs.max())
        live = seqs > max(0, hwm - self.slots)
        out: Dict[str, dict] = {}
        for name in self.series_names():
            vals = self._values[name][live]
            vals = vals[~np.isnan(vals)]
            if len(vals) == 0:
                out[name] = {"last": None, "avg": None, "max": None}
                continue
            out[name] = {
                "last": round(float(vals[-1]), 6),
                "avg": round(float(vals.mean()), 6),
                "max": round(float(vals.max()), 6),
            }
        return out

    def register_stats(self, store, scope: str = "ratelimit.tsdb") -> None:
        store.gauge_fn(scope + ".series", lambda: len(self._values))
        store.gauge_fn(scope + ".capacity", lambda: self.slots)
        store.counter_fn(scope + ".ticks", lambda: self._hwm)

    # -- sampler thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="tsdb-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        import logging

        log = logging.getLogger("ratelimit.tsdb")
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("tsdb sampler tick failed")


def _rss_mb() -> float:
    """Resident set size in MiB from /proc/self/status (no psutil
    dependency)."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def register_default_series(
    ts: TimeSeriesStore,
    store,
    cache=None,
    launches=None,
    overload=None,
    local_cache=None,
    rss: bool = True,
) -> None:
    """Wire the standard serving series (runner.start): decisions/s
    (total + per-algo from the launch recorder's bounded tallies),
    launches/s, dispatcher queue depth, slot-table fill, promotion /
    over-limit cache sizes, process RSS, and the per-phase serving
    p99s from the existing histograms.  Sources that are not wired
    (no cache, recorder off) simply contribute no series."""
    ts.add_counter(
        "decisions_per_s",
        store.counter("ratelimit_server.ShouldRateLimit.total_requests").value,
    )
    base = "ratelimit_server.ShouldRateLimit"
    # Bounded literal phase set (metrics-discipline: names are built
    # from this tuple, never from traffic).
    for phase in ("decode", "service", "serialize"):
        ts.add_histogram_p99(
            "p99_" + phase + "_ms",
            store.histogram(base + ".phase." + phase + "_ms"),
        )
    ts.add_histogram_p99(
        "p99_response_ms", store.histogram(base + ".response_ms")
    )
    if launches is not None:
        ts.add_counter("launches_per_s", launches.stamped)
        for algo in sorted(launches.items_by_algo()):
            ts.add_counter(
                f"decisions_per_s.{algo}",
                lambda a=algo: launches.items_by_algo().get(a, 0),
            )
    if cache is not None:
        dispatchers = getattr(cache, "_dispatchers", None)
        if dispatchers is not None:
            ts.add_gauge(
                "queue_depth",
                lambda: max(
                    (d.queue_depth() for d in dispatchers.values()),
                    default=0,
                ),
            )
        if hasattr(cache, "engines"):

            def _slot_fill() -> int:
                pct = 0
                for e in cache.engines():
                    fill = (
                        100
                        * e.stat_live_keys
                        // max(1, e.model.num_slots)
                    )
                    if fill > pct:
                        pct = fill
                return pct

            ts.add_gauge("slot_fill_pct", _slot_fill)
    promotion = getattr(overload, "promotion", None)
    if promotion is not None:
        ts.add_gauge("promotion_cache_size", lambda: len(promotion))
    if local_cache is not None:
        ts.add_gauge("over_limit_cache_size", lambda: len(local_cache))
    if rss:
        ts.add_gauge("rss_mb", _rss_mb)


def make_timeseries(
    interval_s: float,
    retention_s: float,
    clock: Optional[MonotonicClock] = None,
    wall=None,
) -> Optional[TimeSeriesStore]:
    """Settings seam: TSDB_INTERVAL_S <= 0 disables the store entirely
    (callers keep None; no sampler thread, no history)."""
    if interval_s <= 0:
        return None
    return TimeSeriesStore(interval_s, retention_s, clock=clock, wall=wall)
