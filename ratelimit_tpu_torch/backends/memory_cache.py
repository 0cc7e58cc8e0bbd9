"""MemoryRateLimitCache: an exact, host-only counter backend.

Port of ratelimit_tpu/backends/memory_cache.py (``BACKEND_TYPE=memory``).
The in-process analog of running the reference against a local Redis: a
dict of window-keyed counters with synchronous increments and the same
threshold semantics (``limiter.base.decide``).  Used as a CPU-only
deployment, and as the behavioural oracle of the differential tests.
It runs on the host only and launches no kernel.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import Code, DescriptorStatus, RateLimitRequest
from ..config import RateLimitRule
from ..limiter.base import decide
from ..limiter.cache_key import CacheKeyGenerator
from ..limiter.local_cache import LocalCache
from ..utils.time import (
    RealTimeSource,
    TimeSource,
    reset_seconds,
    unit_to_divider,
    window_start,
)


class MemoryRateLimitCache:
    def __init__(
        self,
        time_source: Optional[TimeSource] = None,
        local_cache: Optional[LocalCache] = None,
        near_ratio: float = 0.8,
        cache_key_prefix: str = "",
        expiration_jitter_max_seconds: int = 0,
        jitter_rand: Optional[random.Random] = None,
    ):
        self.time_source = time_source or RealTimeSource()
        self.local_cache = local_cache
        self.near_ratio = near_ratio
        self.key_generator = CacheKeyGenerator(cache_key_prefix)
        self.expiration_jitter_max_seconds = int(expiration_jitter_max_seconds)
        self.jitter_rand = jitter_rand or random.Random()
        self._counters: Dict[str, Tuple[int, int]] = {}  # key -> (count, expiry)
        # The window increment is a read-modify-write: two gRPC pool
        # threads hitting the same key could both read count=N and both
        # store N+hits, admitting traffic past the limit.  One lock per
        # RMW: this backend is the exact host oracle, not the hot path.
        self._counters_lock = threading.Lock()
        self._gc_cursor = 0

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[Optional[RateLimitRule]],
    ) -> List[DescriptorStatus]:
        hits_addend = max(1, request.hits_addend)
        now = self.time_source.unix_now()
        self._maybe_gc(now)

        statuses: List[DescriptorStatus] = []
        append = statuses.append
        for desc, rule in zip(request.descriptors, limits):
            key = self.key_generator.generate(request.domain, desc, rule, now)
            if rule is None or rule.unlimited:
                append(DescriptorStatus(code=Code.OK))
                continue
            rlimit = rule.limit
            unit = rlimit.unit
            cache_key = key.key
            rule.stats.total_hits.add(hits_addend)
            divider = unit_to_divider(unit)
            duration = reset_seconds(unit, now)

            if self.local_cache is not None and self.local_cache.contains(cache_key):
                if rule.shadow_mode:
                    # Skip the counter (fixed_cache_impl.go:57-67).
                    rule.stats.within_limit.add(hits_addend)
                    append(
                        DescriptorStatus(
                            code=Code.OK,
                            current_limit=rlimit,
                            limit_remaining=rlimit.requests_per_unit,
                            duration_until_reset=duration,
                        )
                    )
                else:
                    rule.stats.over_limit.add(hits_addend)
                    rule.stats.over_limit_with_local_cache.add(hits_addend)
                    append(
                        DescriptorStatus(
                            code=Code.OVER_LIMIT,
                            current_limit=rlimit,
                            limit_remaining=0,
                            duration_until_reset=duration,
                        )
                    )
                continue

            expiry = window_start(now, unit) + divider
            if self.expiration_jitter_max_seconds > 0:
                expiry += self.jitter_rand.randrange(self.expiration_jitter_max_seconds)
            with self._counters_lock:
                count, _ = self._counters.get(cache_key, (0, 0))
                after = count + hits_addend
                self._counters[cache_key] = (after, expiry)

            d = decide(
                limit=rlimit.requests_per_unit,
                before=after - hits_addend,
                after=after,
                hits=hits_addend,
                near_ratio=self.near_ratio,
                shadow_mode=rule.shadow_mode,
            )
            rule.stats.over_limit.add(d.over_limit)
            rule.stats.near_limit.add(d.near_limit)
            rule.stats.within_limit.add(d.within_limit)
            rule.stats.shadow_mode.add(d.shadow_mode)
            if self.local_cache is not None and d.set_local_cache:
                self.local_cache.set(cache_key, divider)
            append(
                DescriptorStatus(
                    code=d.code,
                    current_limit=rlimit,
                    limit_remaining=d.limit_remaining,
                    duration_until_reset=duration,
                )
            )
        return statuses

    def flush(self) -> None:
        pass

    def _maybe_gc(self, now: int, batch: int = 128) -> None:
        """Incremental expiry sweep (Redis-style active expiration).
        Under the counters lock: an unlocked delete racing a concurrent
        RMW could resurrect an expired window mid-write."""
        with self._counters_lock:
            if not self._counters:
                return
            keys = list(self._counters.keys())
            start = self._gc_cursor % len(keys)
            for key in keys[start : start + batch]:
                entry = self._counters.get(key)
                if entry is not None and entry[1] <= now:
                    del self._counters[key]
            self._gc_cursor = start + batch
