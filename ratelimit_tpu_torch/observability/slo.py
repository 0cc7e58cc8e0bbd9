"""Per-domain SLO engine: availability + latency SLIs and error-budget
burn rates.

Port of ratelimit_tpu/observability/slo.py, unchanged.

Follows the "meaningful availability" framing [Hauer et al., NSDI
2020]: availability is measured from the USER's side of the boundary —
the fraction of rate-limit decisions that were actually served (a
request that errored or timed out is unavailability; an OVER_LIMIT
decision is the service doing its job and is tracked as its own
signal, never as badness).  The latency SLI is the fraction of
requests answered under ``SLO_LATENCY_MS``.

Two layers:

- **Rollups** (hot path): one :class:`~ratelimit_tpu_torch.stats.manager.
  SloStats` per domain, interned by the stats Manager like the
  per-rule families — bounded by the CONFIGURED domain set (traffic
  for unconfigured domains folds into ``_other``), so per-domain
  metric cardinality is a config review, not a traffic property.
  ``observe()`` is called on the RPC thread next to the per-phase
  histogram sink and costs one dict probe + a few int bumps.
- **Windows** (read path): a ring of periodic snapshots per domain,
  rolled by the anomaly sampler thread (or lazily at scrape time, so
  burn rates stay live even with detectors disabled).  The window SLIs
  and burn rates derive from the oldest in-window snapshot vs now:

      burn_rate = bad_fraction_in_window / (1 - SLO_TARGET)

  Burn 1.0 = consuming error budget exactly at the sustainable rate;
  the classic fast-burn page threshold is 14.4x over short windows
  [Google SRE workbook].  Exported per domain on ``/metrics`` as
  float gauges (``availability``, ``latency_sli``, ``burn_rate``,
  ``latency_burn_rate``) plus the cumulative rollup counters, and
  summarized at ``GET /debug/slo``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..stats.manager import Manager, SloStats
from ..utils.time import MonotonicClock, REAL_MONOTONIC


class _DomainWindow:
    """Snapshot ring for one domain: (t, requests, over, errors, slow)
    tuples appended by roll(), trimmed to the window."""

    __slots__ = ("stats", "snaps")

    def __init__(self, stats: SloStats):
        self.stats = stats
        self.snaps: deque = deque()

    def current(self, t: float) -> Tuple[float, int, int, int, int]:
        s = self.stats
        return (t, s.requests, s.over_limit, s.errors, s.slow)


class SloEngine:
    """Owner of the per-domain SLIs (module docstring)."""

    def __init__(
        self,
        stats_manager: Manager,
        target: float = 0.999,
        window_s: float = 3600.0,
        latency_threshold_ms: float = 50.0,
        clock: Optional[MonotonicClock] = None,
        min_roll_interval_s: float = 1.0,
    ):
        if not (0.0 < target < 1.0):
            raise ValueError(f"SLO_TARGET must be in (0, 1), got {target}")
        self.manager = stats_manager
        self.target = float(target)
        self.window_s = float(window_s)
        self.latency_threshold_ms = float(latency_threshold_ms)
        self.clock = clock or REAL_MONOTONIC
        self.min_roll_interval_s = float(min_roll_interval_s)
        # domain -> _DomainWindow; reads on the hot path are one dict
        # probe (GIL-atomic).  Mutated only under _lock (set_domains,
        # intern of "_other").  Reentrant: window reads lock around
        # their snapshot-deque iteration and may lazily roll() inside.
        self._domains: Dict[str, _DomainWindow] = {}
        self._lock = threading.RLock()
        self._last_roll = float("-inf")
        self._other = self._intern("_other")

    # -- hot path ---------------------------------------------------------

    def observe(self, domain: str, over_limit: bool, latency_ms: float) -> None:
        """One served decision (RPC handler thread, post-serialize)."""
        w = self._domains.get(domain)
        s = (w or self._other).stats
        s.requests += 1
        if over_limit:
            s.over_limit += 1
        if latency_ms > self.latency_threshold_ms:
            s.slow += 1

    def observe_error(self, domain: str) -> None:
        """One failed decision (ServiceError/CacheError boundary)."""
        w = self._domains.get(domain)
        s = (w or self._other).stats
        s.requests += 1
        s.errors += 1

    # -- domain set (config reload seam) ----------------------------------

    def _intern(self, domain: str) -> _DomainWindow:
        w = _DomainWindow(self.manager.slo_stats(domain))
        # Seed the window with the state AT intern time, so the first
        # window reads deltas from "now", not from cumulative zero (a
        # domain re-adopted after running as _other must not inherit
        # phantom traffic).
        w.snaps.append(w.current(self.clock.now()))
        base = f"{self.manager.slo_scope}.{domain}"
        store = self.manager.store
        # Float gauges: burn 1.4x must not truncate to 1 (int gauges
        # would).  Lazily rolled so scrapes stay live without the
        # sampler thread.
        store.float_gauge_fn(
            base + ".availability", lambda: self._sli(w)[0]
        )
        store.float_gauge_fn(
            base + ".latency_sli", lambda: self._sli(w)[1]
        )
        store.float_gauge_fn(
            base + ".burn_rate", lambda: self._sli(w)[2]
        )
        store.float_gauge_fn(
            base + ".latency_burn_rate", lambda: self._sli(w)[3]
        )
        self._domains[domain] = w
        return w

    def set_domains(self, domains: Iterable[str]) -> None:
        """Adopt the configured domain set (service config reload).
        New domains intern their families; removed domains keep their
        (already-minted, bounded) families but their future traffic
        folds into ``_other`` — metric names never churn mid-scrape."""
        with self._lock:
            for d in domains:
                if d not in self._domains:
                    self._intern(d)

    def domains(self) -> List[str]:
        return sorted(self._domains)

    # -- windows ----------------------------------------------------------

    def roll(self) -> None:
        """Append one window snapshot per domain and trim to the
        window (sampler thread each tick; also lazily from reads)."""
        now = self.clock.now()
        with self._lock:
            self._last_roll = now
            horizon = now - self.window_s
            for w in self._domains.values():
                w.snaps.append(w.current(now))
                while len(w.snaps) > 1 and w.snaps[0][0] < horizon:
                    w.snaps.popleft()

    def _maybe_roll(self) -> None:
        if self.clock.now() - self._last_roll >= self.min_roll_interval_s:
            self.roll()

    def _window_deltas(self, w: _DomainWindow) -> Tuple[int, int, int, int]:
        """(requests, over_limit, errors, slow) accumulated across the
        window: oldest in-window snapshot vs live tallies."""
        now = self.clock.now()
        cur = w.current(now)
        base = None
        horizon = now - self.window_s
        with self._lock:  # roll() mutates the deque concurrently
            for snap in w.snaps:
                if snap[0] >= horizon:
                    base = snap
                    break
        if base is None:
            # No in-window snapshot yet (engine younger than one roll):
            # the whole life of the process is the window.
            base = (0.0, 0, 0, 0, 0)
        return (
            cur[1] - base[1],
            cur[2] - base[2],
            cur[3] - base[3],
            cur[4] - base[4],
        )

    def _sli(self, w: _DomainWindow) -> Tuple[float, float, float, float]:
        """(availability, latency_sli, burn_rate, latency_burn_rate)
        over the window.  No traffic reads as fully healthy (1.0 SLIs,
        0 burn) — an idle domain is not an incident."""
        self._maybe_roll()
        requests, _over, errors, slow = self._window_deltas(w)
        if requests <= 0:
            return (1.0, 1.0, 0.0, 0.0)
        err_frac = errors / requests
        slow_frac = slow / requests
        budget = 1.0 - self.target
        return (
            1.0 - err_frac,
            1.0 - slow_frac,
            err_frac / budget,
            slow_frac / budget,
        )

    def stats_by_domain(self) -> Dict[str, SloStats]:
        """Live per-domain rollup handles (the OVER_LIMIT-surge
        detector delta-tracks these itself, detectors.py)."""
        with self._lock:
            return {name: w.stats for name, w in self._domains.items()}

    # -- read surface -----------------------------------------------------

    def summary(self) -> dict:
        """The ``GET /debug/slo`` body."""
        self._maybe_roll()
        with self._lock:
            items = list(self._domains.items())
        domains = {}
        for name, w in items:
            requests, over, errors, slow = self._window_deltas(w)
            avail, lat_sli, burn, lat_burn = self._sli(w)
            s = w.stats
            domains[name] = {
                "window": {
                    "requests": requests,
                    "over_limit": over,
                    "errors": errors,
                    "slow": slow,
                    "availability": avail,
                    "latency_sli": lat_sli,
                    "burn_rate": burn,
                    "latency_burn_rate": lat_burn,
                },
                "cumulative": {
                    "requests": s.requests,
                    "over_limit": s.over_limit,
                    "errors": s.errors,
                    "slow": s.slow,
                },
            }
        return {
            "target": self.target,
            "window_s": self.window_s,
            "latency_threshold_ms": self.latency_threshold_ms,
            "error_budget": 1.0 - self.target,
            "domains": domains,
        }
