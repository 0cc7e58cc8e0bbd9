"""Time sources and fixed-window math.

Mirrors reference src/utils/utilities.go and src/utils/time.go:
``UnitToDivider`` (utilities.go:17-30), ``CalculateReset``
(utilities.go:32-36), and the ``TimeSource`` seam (utilities.go:9-12)
that lets tests pin the clock.
"""

from __future__ import annotations

import time

from ..api import Unit

_DIVIDERS = {
    Unit.SECOND: 1,
    Unit.MINUTE: 60,
    Unit.HOUR: 60 * 60,
    Unit.DAY: 60 * 60 * 24,
}


def unit_to_divider(unit: Unit) -> int:
    """Length of the fixed window, in seconds, for a limit unit."""
    try:
        return _DIVIDERS[Unit(unit)]
    except KeyError:
        raise ValueError(f"unknown rate limit unit: {unit!r}") from None


def reset_seconds(unit: Unit, now: int) -> int:
    """Seconds until the current window for `unit` rolls over
    (reference CalculateReset, utilities.go:32-36)."""
    divider = unit_to_divider(unit)
    return divider - now % divider


def calculate_reset(unit: Unit, time_source: "TimeSource") -> int:
    """Seconds until the current window for `unit` rolls over."""
    return reset_seconds(unit, time_source.unix_now())


def reset_seconds_cached(unit: Unit, now: int, cache: dict) -> int:
    """reset_seconds memoized per unit for one request's status
    assembly (shared by the sync and write-behind backends)."""
    d = cache.get(unit)
    if d is None:
        d = cache[unit] = reset_seconds(unit, now)
    return d


def window_start(now: int, unit: Unit) -> int:
    """Start timestamp of the fixed window containing `now`
    (the ``(now/divider)*divider`` of reference cache_key.go:74)."""
    divider = unit_to_divider(unit)
    return (now // divider) * divider


class TimeSource:
    """Clock seam: tests substitute a pinned implementation."""

    def unix_now(self) -> int:
        raise NotImplementedError


class RealTimeSource(TimeSource):
    def unix_now(self) -> int:
        return int(time.time())


class PinnedTimeSource(TimeSource):
    """A clock pinned to a settable instant (reference MockClock
    pattern, test/service/ratelimit_test.go:72-76).

    First-class rather than test-only: wire-level tests inject it
    through the Runner's clock seam so window-progression assertions
    can never straddle a real second/minute rollover, and offline
    tools (config_check replay, bench replay) use it to evaluate
    limits at a fixed instant.
    """

    def __init__(self, now: int = 0):
        self.now = int(now)

    def advance(self, seconds: int) -> int:
        self.now += int(seconds)
        return self.now

    def unix_now(self) -> int:
        return self.now


class MonotonicClock:
    """Monotonic-clock seam for duration/interval math (detectors,
    EWMA baselines, SLO windows, the flight recorder's timestamps).

    The wall-clock :class:`TimeSource` seam above pins *window* math;
    this one pins *elapsed-time* math, so anomaly detectors and SLO
    burn windows are unit-testable with synthetic time — tests drive
    :class:`FakeMonotonicClock.advance` instead of sleeping (the same
    no-sleeps discipline the dispatcher tests follow).  Durations
    must come from here or ``time.monotonic``/``perf_counter`` —
    never the wall clock (tpu-lint ``timing-discipline``)."""

    def now(self) -> float:
        """Seconds on a monotonic clock (arbitrary epoch)."""
        raise NotImplementedError

    def now_ns(self) -> int:
        """Nanoseconds on the same clock (flight-record stamps)."""
        return int(self.now() * 1e9)


class RealMonotonicClock(MonotonicClock):
    def now(self) -> float:
        return time.monotonic()

    def now_ns(self) -> int:
        return time.monotonic_ns()


#: Process-wide default; inject a FakeMonotonicClock in tests.
REAL_MONOTONIC = RealMonotonicClock()


class FakeMonotonicClock(MonotonicClock):
    """A settable monotonic clock (PinnedTimeSource's twin for
    elapsed-time seams): tests advance it explicitly, so detector
    cooldowns, EWMA cadences and SLO windows progress deterministically
    with no real sleeping."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def advance(self, seconds: float) -> float:
        self._now += float(seconds)
        return self._now

    def now(self) -> float:
        return self._now


class MonotonicBatchClock(TimeSource):
    """A time source snapshotted once per batch.

    The batched engine evaluates a whole descriptor batch at one
    logical timestamp so all keys in the batch share a consistent
    window; the dispatcher snapshots this clock at batch assembly.
    """

    def __init__(self, base: TimeSource | None = None):
        self._base = base or RealTimeSource()
        self._now = self._base.unix_now()

    def snapshot(self) -> int:
        self._now = self._base.unix_now()
        return self._now

    def unix_now(self) -> int:
        return self._now
