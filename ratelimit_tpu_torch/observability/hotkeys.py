"""Hot-key tracking: a Space-Saving top-K sketch over descriptor stems.

Port of ratelimit_tpu/observability/hotkeys.py, unchanged.

The reference service treats per-descriptor near-limit stats as a
first-class operational surface (stats per rule key); what it cannot
answer is *which concrete key values* dominate the traffic — the
per-value keyspace is unbounded, so it can never become a metric
family.  This module answers that question with bounded memory: a
Space-Saving (stream-summary) sketch [Metwally et al. 2005] of the
``capacity`` heaviest descriptor stems, fed from the resolution fast
path (``cuda_cache.do_limit_resolved``) at interned-stem granularity.

Hot-path contract
-----------------

The per-request cost must be ~one counter bump, so the sketch hands
out :class:`HotKeyEntry` handles that the resolution cache pins on its
:class:`~ratelimit_tpu_torch.limiter.resolution.ResolvedDescriptor` entries
(``rd.hot``).  The serving loop then does::

    e = rd.hot
    if e is None or e.key is None:       # first sight / evicted
        e = sketch.track(rd.stem)        # locked, rare
        rd.hot = e
    e.hits += hits_addend                # lock-free bump

``track`` is the only structural mutation and takes the sketch lock;
counter bumps are plain attribute adds whose rare lost increments
under concurrent RPC threads are an accepted stats-only race (the
same trade the resolution cache's hit tally makes).  An entry evicted
while a stale handle still points at it has ``key = None`` — the
handle check routes the next observation through ``track`` again, and
any bump that raced the eviction lands on the dead entry (an
undercount, never a misattribution: entries are never re-keyed).

Space-Saving semantics
----------------------

At most ``capacity`` keys are tracked.  A new key arriving at
capacity evicts the minimum-count entry and *inherits its count* as
both starting estimate and error bound, giving the classic
guarantees (single-writer feed):

    estimate >= true count >= estimate - error

and any key whose true count exceeds N/capacity is guaranteed
tracked.  Eviction uses a lazy min-heap: bumps never touch the heap;
``track`` pops stale entries (count moved since push, or already
dead) and re-pushes until the top is current — amortized O(log K)
per registration, O(1) per observation.

Exposure
--------

``GET /debug/hotkeys`` (server/http_server.py) renders
:meth:`HotKeySketch.snapshot` as JSON — key stem, estimated hits,
error bound, over-limit/near-limit share.  :meth:`register_stats`
exports a BOUNDED ``ratelimit.tpu.hotkeys.*`` family (tracked /
capacity / evictions / observed / min_count / top_hits) — never
per-key metric names, which would be unbounded cardinality (the
exact bug class a bounded family exists to prevent).
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional


class HotKeyEntry:
    """One tracked stem.  ``key is None`` marks an evicted (dead)
    entry — holders of a dead handle must re-``track``.  Counter
    fields are bumped lock-free by the serving threads."""

    __slots__ = ("key", "hits", "error", "over_limit", "near_limit")

    def __init__(self, key: str, hits: int = 0, error: int = 0):
        self.key: Optional[str] = key
        self.hits = hits
        self.error = error
        self.over_limit = 0
        self.near_limit = 0


class HotKeySketch:
    """Space-Saving top-K over descriptor stems (module docstring)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("HotKeySketch capacity must be positive")
        self.capacity = int(capacity)
        self._entries: dict = {}  # stem -> HotKeyEntry (live only)
        # Lazy min-heap of (count_at_push, seq, entry); seq breaks
        # count ties so entries (not comparable) never compare.
        self._heap: List[tuple] = []
        self._seq = 0
        self._lock = threading.Lock()
        # Stats-only tallies (register_stats): evictions is mutated
        # under the lock; observed is bumped lock-free by the feeder
        # alongside the entry bumps.
        self.evictions = 0
        self.observed = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- registration (locked, off the per-observation path) ------------

    def track(self, key: str) -> HotKeyEntry:
        """The entry for ``key``, registering it (evicting the current
        minimum when at capacity) if unseen.  Callers cache the
        returned handle and bump its counters directly."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                # Refresh the stored key reference so handle-validity
                # identity checks upstream keep hitting the fast path
                # after a config reload rebuilds equal-valued stems.
                e.key = key
                return e
            if len(self._entries) >= self.capacity:
                victim = self._pop_min()
                del self._entries[victim.key]
                victim.key = None  # dead marker for stale handles
                self.evictions += 1
                # Space-Saving: the newcomer inherits the evicted
                # minimum's count as estimate AND error bound.
                e = HotKeyEntry(key, hits=victim.hits, error=victim.hits)
            else:
                e = HotKeyEntry(key)
            self._entries[key] = e
            self._push(e)
            return e

    def _push(self, e: HotKeyEntry) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (e.hits, self._seq, e))

    def _pop_min(self) -> HotKeyEntry:
        """Lazy-heap minimum: skip dead entries, re-push ones whose
        count moved since they were pushed.  Terminates because every
        live entry is on the heap and counts only grow."""
        heap = self._heap
        while True:
            count, _seq, e = heapq.heappop(heap)
            if e.key is None:
                continue  # already evicted under an older push
            if e.hits != count:
                self._push(e)  # stale snapshot: re-file at its count
                continue
            return e

    # -- read surface ----------------------------------------------------

    def min_count(self) -> int:
        """The current eviction floor (= the worst-case error a new
        arrival inherits).  O(K); called at scrape/snapshot time."""
        with self._lock:
            if not self._entries:
                return 0
            return min(e.hits for e in self._entries.values())

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Tracked keys, heaviest first: estimated hits, error bound,
        and over/near-limit hit shares.  ``limit`` trims the list."""
        with self._lock:
            entries = sorted(
                self._entries.values(), key=lambda e: e.hits, reverse=True
            )
        out = []
        for e in entries[: limit or len(entries)]:
            hits = e.hits
            out.append(
                {
                    "key": e.key,
                    "hits": hits,
                    "error": e.error,
                    "over_limit": e.over_limit,
                    "near_limit": e.near_limit,
                    "over_limit_share": e.over_limit / hits if hits else 0.0,
                    "near_limit_share": e.near_limit / hits if hits else 0.0,
                }
            )
        return out

    def snapshot_dict(self, limit: Optional[int] = None) -> dict:
        """The ``GET /debug/hotkeys`` JSON body."""
        return {
            "capacity": self.capacity,
            "tracked": len(self._entries),
            "observed": self.observed,
            "evictions": self.evictions,
            "min_count": self.min_count(),
            "keys": self.snapshot(limit),
        }

    def register_stats(self, store, scope: str = "ratelimit.tpu.hotkeys") -> None:
        """The bounded metric family (never per-key names — see the
        module docstring on cardinality)."""
        store.gauge_fn(scope + ".tracked", lambda: len(self._entries))
        store.gauge_fn(scope + ".capacity", lambda: self.capacity)
        store.counter_fn(scope + ".evictions", lambda: self.evictions)
        store.counter_fn(scope + ".observed", lambda: self.observed)
        store.gauge_fn(scope + ".min_count", self.min_count)
        store.gauge_fn(scope + ".top_hits", self._top_hits)

    def _top_hits(self) -> int:
        with self._lock:
            if not self._entries:
                return 0
            return max(e.hits for e in self._entries.values())
