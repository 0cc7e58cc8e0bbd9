"""Host-side over-limit cache.

The reference keeps a freecache LRU of keys already known to be over
their limit so repeat offenders never touch Redis
(src/limiter/base_limiter.go:63-72,103-115).  Here it shields the
device batch path the same way: a key that went over-limit is cached
with TTL = the full window length, and subsequent hits on it are
decided host-side without occupying batch slots.

freecache is byte-budgeted; we approximate the
``LOCAL_CACHE_SIZE_IN_BYTES`` knob by dividing by an assumed ~64 bytes
per entry and evicting in FIFO order (entries all expire within one
window, so FIFO ~= LRU here).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..stats.manager import StatsStore

APPROX_ENTRY_BYTES = 64


class LocalCache:
    def __init__(self, size_bytes: int, clock=None):
        self.max_entries = max(1, size_bytes // APPROX_ENTRY_BYTES)
        self._entries: "OrderedDict[str, float]" = OrderedDict()
        self._lock = threading.Lock()
        self._clock = clock or time.monotonic
        # freecache-parity counters (reference local_cache_stats.go):
        # all mutate under _lock, read lock-free by the stats gauges
        # (plain int reads are atomic under the GIL).
        self.hit_count = 0
        self.miss_count = 0
        self.expired_count = 0
        self.evacuate_count = 0
        self.overwrite_count = 0

    def contains(self, key: str) -> bool:
        """True if `key` is cached and unexpired
        (base_limiter.go:63-72)."""
        now = self._clock()
        with self._lock:
            expiry = self._entries.get(key)
            if expiry is None:
                self.miss_count += 1
                return False
            if expiry <= now:
                del self._entries[key]
                self.expired_count += 1
                self.miss_count += 1
                return False
            self.hit_count += 1
            return True

    def set(self, key: str, ttl_seconds: int) -> None:
        """Cache `key` for `ttl_seconds` (the unit's full window,
        base_limiter.go:103-115)."""
        now = self._clock()
        with self._lock:
            if key in self._entries:
                self.overwrite_count += 1
            self._entries[key] = now + ttl_seconds
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evacuate_count += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def register_stats(self, store: StatsStore, scope: str = "ratelimit.localcache") -> None:
        """Expose freecache-style gauges, re-read at every stats
        snapshot like the reference's StatGenerator (reference
        src/limiter/local_cache_stats.go: evacuate/expired/entry/hit/
        miss/lookup/overwrite counts; averageAccessTime is a freecache
        internal with no analog here and is omitted)."""
        store.gauge_fn(scope + ".entryCount", lambda: len(self))
        store.gauge_fn(scope + ".hitCount", lambda: self.hit_count)
        store.gauge_fn(scope + ".missCount", lambda: self.miss_count)
        store.gauge_fn(
            scope + ".lookupCount",
            lambda: self.hit_count + self.miss_count,
        )
        store.gauge_fn(scope + ".expiredCount", lambda: self.expired_count)
        store.gauge_fn(scope + ".evacuateCount", lambda: self.evacuate_count)
        store.gauge_fn(
            scope + ".overwriteCount", lambda: self.overwrite_count
        )
