"""Stat tree with reference-compatible names.

Mirrors reference src/stats/manager.go + manager_impl.go.  The scope
layout (manager_impl.go:10-18) is::

    ratelimit.service.rate_limit.<rule key>.{total_hits,over_limit,
        near_limit,over_limit_with_local_cache,within_limit,shadow_mode}
    ratelimit.service.{config_load_success,config_load_error,global_shadow_mode}
    ratelimit.service.call.should_rate_limit.{redis_error,service_error}

``redis_error`` keeps its reference name (tests in the reference assert
it; here it counts TPU-engine/backend failures).  Counters are
monotonically increasing with thread-safe ``add``; a sink (statsd or
null) drains deltas periodically (``ratelimit_tpu.stats.sink``).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, Optional


class Counter:
    """A monotonically increasing, thread-safe counter."""

    __slots__ = ("name", "_value", "_lock", "_last_flushed")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._last_flushed = 0
        self._lock = threading.Lock()

    def add(self, delta: int) -> None:
        if delta:
            with self._lock:
                self._value += int(delta)

    def inc(self) -> None:
        self.add(1)

    def value(self) -> int:
        with self._lock:
            return self._value

    def drain_delta(self) -> int:
        """Value accumulated since the last drain (for statsd export)."""
        with self._lock:
            delta = self._value - self._last_flushed
            self._last_flushed = self._value
            return delta


class Gauge:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def add(self, delta: int) -> None:
        with self._lock:
            self._value += int(delta)

    def value(self) -> int:
        with self._lock:
            return self._value


class Timer:
    """Millisecond timer: count / total / max (the gostats timer the
    gRPC interceptor feeds, reference src/metrics/metrics.go:41-44)."""

    __slots__ = (
        "name",
        "_count",
        "_total_ms",
        "_max_ms",
        "_samples",
        "_dropped",
        "_dropped_flushed",
        "_lock",
    )

    # Per-flush sample retention cap: statsd timers are per-observation
    # ("|ms" lines); beyond this the flush interval reports a sampled
    # subset, which statsd aggregation tolerates.  Drops are COUNTED
    # (``samples_dropped``) so a saturated flush interval is visible
    # instead of silently biasing the exported distribution.
    MAX_SAMPLES = 512

    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._total_ms = 0.0
        self._max_ms = 0.0
        self._samples: list = []
        self._dropped = 0
        self._dropped_flushed = 0
        self._lock = threading.Lock()

    def add_duration_ms(self, ms: float) -> None:
        with self._lock:
            self._count += 1
            self._total_ms += ms
            if ms > self._max_ms:
                self._max_ms = ms
            if len(self._samples) < self.MAX_SAMPLES:
                self._samples.append(ms)
            else:
                self._dropped += 1

    def drain_samples(self) -> list:
        """Samples observed since the last drain (statsd export)."""
        with self._lock:
            samples, self._samples = self._samples, []
            return samples

    def drain_dropped(self) -> int:
        """Drop count accumulated since the last drain (exported as a
        ``<name>.timer_samples_dropped`` statsd counter)."""
        with self._lock:
            delta = self._dropped - self._dropped_flushed
            self._dropped_flushed = self._dropped
            return delta

    def summary(self) -> Dict[str, float]:
        with self._lock:
            mean = self._total_ms / self._count if self._count else 0.0
            return {
                "count": self._count,
                "total_ms": self._total_ms,
                "mean_ms": mean,
                "max_ms": self._max_ms,
                "samples_dropped": self._dropped,
            }


def _log_bounds(start_ms: float = 0.125, count: int = 18) -> tuple:
    """Power-of-two bucket ladder: 0.125ms .. ~16.4s.  Fixed (not
    per-histogram adaptive) so bucket series from any process align
    and Prometheus quantile math works across restarts."""
    return tuple(start_ms * (2**i) for i in range(count))


class Histogram:
    """Fixed log-bucket latency histogram (milliseconds).

    The quantile-carrying successor to Timer's count/total/max: O(1)
    memory, lock-held work is one bisect + three adds, and the bucket
    counts expose directly as a Prometheus histogram.  ``summary()``
    derives p50/p90/p99 by linear interpolation inside the bucket
    containing each quantile (the same estimate PromQL's
    histogram_quantile computes server-side).
    """

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_max", "_lock")

    DEFAULT_BOUNDS = _log_bounds()

    def __init__(self, name: str, bounds: Optional[tuple] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        # One overflow cell past the last bound (the +Inf bucket).
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        idx = bisect_right(self.bounds, ms)
        with self._lock:
            self._counts[idx] += 1
            self._sum += ms
            self._count += 1
            if ms > self._max:
                self._max = ms

    def snapshot(self):
        """(bounds, per-bucket counts incl. overflow, sum, count) —
        the Prometheus exposition surface."""
        with self._lock:
            return self.bounds, list(self._counts), self._sum, self._count

    def _quantile(self, counts, q: float) -> float:
        """Linear interpolation within the bucket holding quantile q;
        the overflow bucket reports the last finite bound (like
        histogram_quantile's +Inf clamp)."""
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cumulative = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cumulative + c >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - cumulative) / c
                return lo + (hi - lo) * frac
            cumulative += c
        return self.bounds[-1]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            counts = list(self._counts)
            total, total_sum, mx = self._count, self._sum, self._max
        mean = total_sum / total if total else 0.0
        return {
            "count": total,
            "total_ms": total_sum,
            "mean_ms": mean,
            "max_ms": mx,
            "p50_ms": self._quantile(counts, 0.50),
            "p90_ms": self._quantile(counts, 0.90),
            "p99_ms": self._quantile(counts, 0.99),
        }


class StatsStore:
    """Flat name -> Counter/Gauge registry; idempotent creation."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._gauge_fns: Dict[str, "callable"] = {}
        self._float_gauge_fns: Dict[str, "callable"] = {}
        self._counter_fns: Dict[str, "callable"] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def histogram(self, name: str, bounds: Optional[tuple] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, bounds)
            return h

    def histogram_names(self) -> list:
        with self._lock:
            return list(self._histograms.keys())

    def histograms(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._histograms.items())
        return {name: h.summary() for name, h in items}

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer(name)
            return t

    def timers(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._timers.items())
        return {name: t.summary() for name, t in items}

    def live_counters(self) -> list:
        """Live Counter objects (drain-oriented export; statsd)."""
        with self._lock:
            return list(self._counters.values())

    def live_timers(self) -> list:
        """Live Timer objects (drain-oriented export; statsd)."""
        with self._lock:
            return list(self._timers.values())

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def counter_fn(self, name: str, fn) -> None:
        """Register a live COUNTER evaluated at snapshot time (the
        gauge_fn pattern for monotonically increasing tallies kept as
        plain ints by their owner — e.g. the resolution/stem cache
        hit counts, which deliberately avoid a per-request Lock).
        Rendered with counter type on /metrics; the statsd exporter
        delta-tracks them itself (StatsdExporter._fn_last) since,
        unlike Counter objects, they carry no drain cursor."""
        with self._lock:
            self._counter_fns[name] = fn

    def counters(self) -> Dict[str, int]:
        with self._lock:
            out = {name: c.value() for name, c in self._counters.items()}
            fns = list(self._counter_fns.items())
        for name, fn in fns:
            out[name] = int(fn())
        return out

    def counter_fn_values(self) -> Dict[str, int]:
        """Just the fn-backed counters (statsd export: the exporter
        delta-tracks these itself, since live Counter objects carry
        their own drain cursor but plain-int owners cannot)."""
        with self._lock:
            fns = list(self._counter_fns.items())
        return {name: int(fn()) for name, fn in fns}

    def gauge_fn(self, name: str, fn) -> None:
        """Register a live gauge evaluated at snapshot time (reference
        gostats StatGenerator pattern, local_cache_stats.go)."""
        with self._lock:
            self._gauge_fns[name] = fn

    def float_gauge_fn(self, name: str, fn) -> None:
        """Register a live FLOAT gauge (SLO burn rates, SLI ratios —
        values whose useful range is fractional, where the int gauges
        above would truncate 1.4x burn to 1).  Exported on /metrics as
        a gauge and flushed to statsd as ``|g``; kept in a separate
        registry so the integer contract of gauges()/snapshot() — and
        every golden test over it — is untouched."""
        with self._lock:
            self._float_gauge_fns[name] = fn

    def float_gauges(self) -> Dict[str, float]:
        with self._lock:
            fns = list(self._float_gauge_fns.items())
        return {name: float(fn()) for name, fn in fns}

    def gauges(self) -> Dict[str, int]:
        with self._lock:
            out = {name: g.value() for name, g in self._gauges.items()}
            fns = list(self._gauge_fns.items())
        for name, fn in fns:
            out[name] = int(fn())
        return out

    def snapshot(self) -> Dict[str, int]:
        out = self.counters()
        out.update(self.gauges())
        return out


class RateLimitStats:
    """Per-rule counters (reference manager_impl.go:27-38)."""

    __slots__ = (
        "key",
        "total_hits",
        "over_limit",
        "near_limit",
        "over_limit_with_local_cache",
        "within_limit",
        "shadow_mode",
    )

    def __init__(self, scope_prefix: str, key: str, store: StatsStore):
        self.key = key
        base = f"{scope_prefix}.{key}"
        self.total_hits = store.counter(base + ".total_hits")
        self.over_limit = store.counter(base + ".over_limit")
        self.near_limit = store.counter(base + ".near_limit")
        self.over_limit_with_local_cache = store.counter(
            base + ".over_limit_with_local_cache"
        )
        self.within_limit = store.counter(base + ".within_limit")
        self.shadow_mode = store.counter(base + ".shadow_mode")


class ShouldRateLimitStats:
    """Panic-recovery counters (reference manager_impl.go:40-45)."""

    __slots__ = ("redis_error", "service_error")

    def __init__(self, scope: str, store: StatsStore):
        self.redis_error = store.counter(scope + ".redis_error")
        self.service_error = store.counter(scope + ".service_error")


class ServiceStats:
    """Service-level counters (reference manager_impl.go:47-54)."""

    __slots__ = (
        "config_load_success",
        "config_load_error",
        "should_rate_limit",
        "global_shadow_mode",
    )

    def __init__(self, scope: str, store: StatsStore):
        self.config_load_success = store.counter(scope + ".config_load_success")
        self.config_load_error = store.counter(scope + ".config_load_error")
        self.should_rate_limit = ShouldRateLimitStats(
            scope + ".call.should_rate_limit", store
        )
        self.global_shadow_mode = store.counter(scope + ".global_shadow_mode")


class SloStats:
    """Per-domain SLO rollup tallies (observability/slo.py).

    Plain ints bumped lock-free on the RPC thread (the same accepted
    stats-only race as the resolution-cache tallies); exported through
    the store's counter_fn seam so the statsd exporter delta-tracks
    them and /metrics renders cumulative counters.  ``slow`` counts
    requests over the latency SLO threshold; ``errors`` counts
    service/backend failures (the availability SLI's bad events —
    OVER_LIMIT is correct behavior for a rate limiter, so it is
    tallied separately, not as unavailability)."""

    __slots__ = ("domain", "requests", "over_limit", "errors", "slow")

    def __init__(self, domain: str):
        self.domain = domain
        self.requests = 0
        self.over_limit = 0
        self.errors = 0
        self.slow = 0


# Per-domain SLO families are bounded by the CONFIGURED domain set
# (SloEngine.set_domains folds unconfigured traffic into "_other");
# this cap is the backstop against a pathological config.
MAX_SLO_DOMAINS = 64


class Manager:
    """Owner of the stat scopes (reference stats.Manager seam)."""

    def __init__(self, store: Optional[StatsStore] = None, extra_tags: Optional[Dict[str, str]] = None):
        self.store = store or StatsStore()
        # gostats ScopeWithTags folds tags into the scope; we suffix the
        # root scope name with sorted tag pairs for the same effect.
        root = "ratelimit"
        if extra_tags:
            root += "".join(f".__{k}={v}" for k, v in sorted(extra_tags.items()))
        self.service_scope = root + ".service"
        self.rl_scope = self.service_scope + ".rate_limit"
        self.slo_scope = root + ".tpu.slo"
        self._rule_stats: Dict[str, RateLimitStats] = {}
        self._slo_stats: Dict[str, SloStats] = {}
        self._lock = threading.Lock()

    def rate_limit_stats(self, key: str) -> RateLimitStats:
        """Per-rule stats; equivalent calls return the same counters
        (reference manager.go:11-12)."""
        with self._lock:
            s = self._rule_stats.get(key)
            if s is None:
                s = self._rule_stats[key] = RateLimitStats(self.rl_scope, key, self.store)
            return s

    # Reference-parity alias (manager_impl.go NewStats).
    new_stats = rate_limit_stats

    def service_stats(self) -> ServiceStats:
        return ServiceStats(self.service_scope, self.store)

    def slo_stats(self, domain: str) -> SloStats:
        """Per-domain SLO rollups; equivalent calls return the same
        tallies (the rate_limit_stats interning pattern applied to
        domains).  This method is the cardinality seam: metric names
        are minted HERE, once per interned domain, never per request
        — past MAX_SLO_DOMAINS everything folds into "_other"."""
        with self._lock:
            s = self._slo_stats.get(domain)
            if s is None:
                if (
                    len(self._slo_stats) >= MAX_SLO_DOMAINS
                    and domain != "_other"
                ):
                    domain = "_other"
                    s = self._slo_stats.get(domain)
                    if s is not None:
                        return s
                s = self._slo_stats[domain] = SloStats(domain)
                base = f"{self.slo_scope}.{domain}"
                store = self.store
                store.counter_fn(base + ".requests", lambda: s.requests)
                store.counter_fn(base + ".over_limit", lambda: s.over_limit)
                store.counter_fn(base + ".errors", lambda: s.errors)
                store.counter_fn(base + ".slow", lambda: s.slow)
            return s
