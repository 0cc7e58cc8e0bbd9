"""Write-behind cache mode: decide on the host, commit hits to the card
asynchronously -- the memcached-backend analog.

Port of ratelimit_tpu/backends/write_behind.py
(``BACKEND_TYPE=cuda-write-behind`` and ``cuda-sharded-write-behind``).
The reference's memcached mode reads current values, decides client-
side, and increments in a background goroutine pool (reference
src/memcached/cache_impl.go:58-174: GetMulti -> decide -> runAsync
increaseAsync, with Flush() as the deterministic test hook :176-178).
Its incr->add->incr race dance (:144-168) exists because memcached is a
SHARED external store: concurrent processes race on the same key.

Here each process owns its counters, so the host can fold its own
in-flight hits into the decision and stay EXACT while the device commit
runs behind:

    decision basis = last device readback + pending uncommitted hits

The RPC path never waits on the card: do_limit reads and updates the
host view under a lock, answers, and enqueues the device commit on the
same micro-batching dispatcher the sync backend uses, whose launch runs
the engine's served chunk (K1 by value up to 128 lanes and its device
form beyond; K6 on a bank-sharded engine).  Device readbacks reconcile
the view (apply: the device value replaces the readback component,
pending drains), on the dispatcher's completer thread.  ``flush()``
drains the dispatcher: everything enqueued before it is committed AND
reconciled after it returns.

Async envelope (the reference's, which the port follows and does not
extend):
- Device-side slot eviction (table full) resets counters the host view
  still carries; the view reconciles at the next readback of that key.
  Until then decisions are STRICTER -- the safe direction for a limiter.
- Checkpoint-restore rebuilds the view from the restored slot table and
  counters (``on_restored``), so restored limits enforce immediately.
- A failed device commit drains its pending hits from the view
  (WorkItem.on_error): those hits never landed, so decisions fall back
  to the last device-confirmed values instead of over-counting.
- The view is capped at 4x the device table: past the cap, expired
  windows prune first, then the soonest-expiring entries go.
- No fault domain: a stalled kernel leaves RPCs answering, exactly,
  from the view while pending hits and the dispatcher's intake grow.
- No per-second bank and no algorithm banks: SECOND-unit limits share
  the one bank, and a rule's ``algorithm:`` is counted as a fixed
  window.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..api import Code, DescriptorStatus, RateLimitRequest
from ..config import RateLimitRule
from ..limiter.base import decide_batch
from ..limiter.cache_key import CacheKeyGenerator
from ..limiter.local_cache import LocalCache
from ..utils.time import (
    RealTimeSource,
    TimeSource,
    reset_seconds_cached,
    unit_to_divider,
    window_start,
)
from .cuda_cache import _CODE_BY_VALUE, warmup_engine
from .dispatcher import LANE_DTYPE, BatchDispatcher, LanePack, WorkItem

# Prune the host view of expired windows every N reconciled batches.
_PRUNE_EVERY = 256


class WriteBehindRateLimitCache:
    """RateLimitCache with async device commits (memcached-mode latency
    envelope: the request path is pure host work)."""

    def __init__(
        self,
        engine,
        time_source: Optional[TimeSource] = None,
        local_cache: Optional[LocalCache] = None,
        expiration_jitter_max_seconds: int = 0,
        cache_key_prefix: str = "",
        jitter_rand: Optional[random.Random] = None,
        batch_window_us: int = 200,
        batch_limit: int = 4096,
        unhealthy_after: int = 3,
        pipeline_depth: int = 2,
    ):
        """`engine` is a CounterEngine or a ShardedCounterEngine; its
        table lives wherever the engine was built (the card unless the
        caller asked for the CPU)."""
        self.engine = engine
        self.time_source = time_source or RealTimeSource()
        self.local_cache = local_cache
        self.key_generator = CacheKeyGenerator(cache_key_prefix)
        self.expiration_jitter_max_seconds = int(expiration_jitter_max_seconds)
        self.jitter_rand = jitter_rand or random.Random()
        self._jitter_lock = threading.Lock()

        # key -> [device_count, pending_hits, expiry].  device_count is
        # the value from the last reconciled readback; pending_hits are
        # enqueued but not yet reconciled.  Both mutate under _view_lock
        # (RPC threads on decide, the dispatcher completer on apply).
        self._view: Dict[str, list] = {}
        self._view_lock = threading.Lock()
        self._batches_reconciled = 0
        # Host-memory bound: the device table self-bounds at num_slots,
        # the host dict must too.
        self._max_view_keys = max(4 * engine.model.num_slots, 1 << 14)

        # The same two-stage dispatcher as the sync backend; nobody
        # blocks on item.wait(), and apply runs on the completer.
        self._dispatcher = BatchDispatcher(
            engine,
            batch_window_us=max(1, batch_window_us),
            batch_limit=batch_limit,
            name="cuda-writebehind",
            pipeline_depth=pipeline_depth,
            unhealthy_after=unhealthy_after,
        )

    # -- RateLimitCache seam --------------------------------------------

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[Optional[RateLimitRule]],
    ) -> List[DescriptorStatus]:
        n = len(request.descriptors)
        if n != len(limits):
            raise ValueError("one limit per descriptor expected")
        hits_addend = max(1, request.hits_addend)
        now = self.time_source.unix_now()

        keys = []
        for desc, rule in zip(request.descriptors, limits):
            key = self.key_generator.generate(request.domain, desc, rule, now)
            keys.append(key)
            if rule is not None and not rule.unlimited:
                rule.stats.total_hits.add(hits_addend)

        statuses: List[Optional[DescriptorStatus]] = [None] * n
        rows: List[int] = []  # engine-bound lanes
        reset_cache: dict = {}
        for i, (key, rule) in enumerate(zip(keys, limits)):
            if key.key == "":
                statuses[i] = DescriptorStatus(code=Code.OK)
                continue
            if self.local_cache is not None and self.local_cache.contains(key.key):
                duration = self._reset_seconds(rule, now, reset_cache)
                if rule.shadow_mode:
                    # Shadow + cached over-limit: skip the counter,
                    # answer OK (fixed_cache_impl.go:57-67 semantics).
                    rule.stats.within_limit.add(hits_addend)
                    statuses[i] = DescriptorStatus(
                        code=Code.OK,
                        current_limit=rule.limit,
                        limit_remaining=rule.limit.requests_per_unit,
                        duration_until_reset=duration,
                    )
                else:
                    rule.stats.over_limit.add(hits_addend)
                    rule.stats.over_limit_with_local_cache.add(hits_addend)
                    statuses[i] = DescriptorStatus(
                        code=Code.OVER_LIMIT,
                        current_limit=rule.limit,
                        limit_remaining=0,
                        duration_until_reset=duration,
                    )
                continue
            rows.append(i)

        if not rows:
            return statuses  # type: ignore[return-value]

        m = len(rows)
        jitters = None
        if self.expiration_jitter_max_seconds > 0:
            with self._jitter_lock:
                jitters = [
                    self.jitter_rand.randrange(self.expiration_jitter_max_seconds)
                    for _ in rows
                ]

        befores = np.empty(m, dtype=np.int64)
        limits_arr = np.empty(m, dtype=np.int64)
        shadow_arr = np.empty(m, dtype=bool)
        enc: List[bytes] = []
        meta = np.empty(m, dtype=LANE_DTYPE)
        expiry_by_unit: dict = {}
        lane_keys: List[str] = []
        expiries: List[int] = []
        # The commit's hits saturate at u32 on the card; the view counts
        # in unbounded Python ints.
        hits_u32 = min(hits_addend, 0xFFFFFFFF)

        # Pass 1, lock-free: packing work (encode, expiry math, meta
        # records) parallelizes across RPC threads.
        for j, i in enumerate(rows):
            rule = limits[i]
            unit = rule.limit.unit
            e = expiry_by_unit.get(unit)
            if e is None:
                e = expiry_by_unit[unit] = window_start(now, unit) + unit_to_divider(unit)
            if jitters is not None:
                e += jitters[j]
            k = keys[i].key
            limits_arr[j] = rule.limit.requests_per_unit
            shadow_arr[j] = rule.shadow_mode
            b = k.encode("utf-8")
            enc.append(b)
            lane_keys.append(k)
            expiries.append(e)
            meta[j] = (e, hits_u32, limits_arr[j], len(b), 0, 0, 0)

        # Pass 2, under the lock: ONLY the decision basis and the
        # pending update.  Duplicates inside the request see each
        # other's hits (pipeline order, like the sync path's prefixes).
        with self._view_lock:
            view = self._view
            for j, k in enumerate(lane_keys):
                entry = view.get(k)
                if entry is None:
                    entry = view[k] = [0, 0, expiries[j]]
                befores[j] = entry[0] + entry[1]
                entry[1] += hits_addend
            if len(view) > self._max_view_keys:
                self._shrink_view_locked(now)

        hits_arr = np.full(m, hits_addend, dtype=np.int64)
        d = decide_batch(
            limits=limits_arr,
            befores=befores,
            afters=befores + hits_arr,
            hits=hits_arr,
            near_ratio=self.engine.model.near_ratio,
            shadow_mask=shadow_arr,
            local_cache_mask=np.zeros(m, dtype=bool),
        )

        codes = d.codes.tolist()
        remaining = d.limit_remaining.tolist()
        over = d.over_limit.tolist()
        near = d.near_limit.tolist()
        within = d.within_limit.tolist()
        shadow_stat = d.shadow_mode.tolist()
        set_lc = d.set_local_cache.tolist()
        for j, i in enumerate(rows):
            rule = limits[i]
            stats = rule.stats
            if over[j]:
                stats.over_limit.add(over[j])
            if near[j]:
                stats.near_limit.add(near[j])
            if within[j]:
                stats.within_limit.add(within[j])
            if shadow_stat[j]:
                stats.shadow_mode.add(shadow_stat[j])
            if self.local_cache is not None and set_lc[j]:
                self.local_cache.set(keys[i].key, unit_to_divider(rule.limit.unit))
            statuses[i] = DescriptorStatus(
                code=_CODE_BY_VALUE[int(codes[j])],
                current_limit=rule.limit,
                limit_remaining=int(remaining[j]),
                duration_until_reset=self._reset_seconds(rule, now, reset_cache),
            )

        # Enqueue the device commit; nobody waits on it (the write-
        # behind point).  apply() reconciles the host view from the
        # card's authoritative afters.
        lane_hits = hits_addend

        def apply(decisions) -> None:
            self._reconcile(lane_keys, lane_hits, decisions)

        def on_error(exc: BaseException) -> None:
            # The commit never landed: drain its pending hits so the
            # view falls back to the device-confirmed values instead of
            # over-counting for the rest of the window.
            logging.getLogger("ratelimit.writebehind").warning(
                "device commit failed, draining %d lanes: %r",
                len(lane_keys),
                exc,
            )
            with self._view_lock:
                for k in lane_keys:
                    entry = self._view.get(k)
                    if entry is not None:
                        entry[1] = max(0, entry[1] - lane_hits)

        item = WorkItem(
            now=now,
            lanes=(),
            pack=LanePack(key_blob=b"".join(enc), meta=meta),
            apply=apply,
            on_error=on_error,
        )
        try:
            self._dispatcher.submit(item)
        except Exception as e:
            # The item never reached the queue, so on_error will never
            # fire for it: drain THIS call's pending hits here or the
            # view over-counts these keys until their window expires.
            on_error(e)
            from ..service import CacheError

            raise CacheError(f"counter engine failure: {e}") from e
        return statuses  # type: ignore[return-value]

    def _reconcile(self, lane_keys: List[str], lane_hits: int, decisions) -> None:
        """Dispatcher-completer callback: fold the card's afters back
        into the view and drain this batch's pending hits."""
        # One tolist() up front: the per-lane reads below become plain
        # list indexing instead of numpy scalar extraction.  The afters
        # are unsigned whatever the readback's width (a u16 readback
        # travels as int16 and the engine reads it back as uint16).
        afters = decisions.afters.tolist()
        now = self.time_source.unix_now()
        with self._view_lock:
            for j, k in enumerate(lane_keys):
                entry = self._view.get(k)
                if entry is None:
                    continue  # pruned (window rolled over mid-flight)
                entry[0] = int(afters[j])
                entry[1] = max(0, entry[1] - lane_hits)
            self._batches_reconciled += 1
            if self._batches_reconciled % _PRUNE_EVERY == 0:
                dead = [k for k, e in self._view.items() if e[2] <= now]
                for k in dead:
                    del self._view[k]

    def _shrink_view_locked(self, now: int) -> None:
        """Called under _view_lock when the view exceeds its cap: prune
        expired windows first; if still over, evict soonest-expiring
        entries down to 90% of the cap (the same forgiveness direction
        as the device slot table's evict-soonest policy)."""
        view = self._view
        dead = [k for k, e in view.items() if e[2] <= now]
        for k in dead:
            del view[k]
        if len(view) <= self._max_view_keys:
            return
        target = int(self._max_view_keys * 0.9)
        by_expiry = sorted(view.items(), key=lambda kv: kv[1][2])
        for k, _ in by_expiry[: len(view) - target]:
            del view[k]

    def on_restored(self) -> None:
        """Checkpoint-restore hook (CheckpointManager.restore): rebuild
        the view from the restored slot table and counters so restored
        limits enforce immediately (an empty view would over-admit a
        full limit's worth per key until the first reconcile).  The
        table and the slot table are copied on the dispatcher thread,
        on the engine's stream; the keys decode here."""
        grabbed = {}

        def grab():
            grabbed["counts"] = self.engine.export_counts()
            grabbed["entries"] = self.engine.slot_table.export_entries()

        self.run_exclusive(self.engine, grab)
        counts = grabbed["counts"]
        view = {
            key: [int(counts[slot]), 0, expiry]
            for key, slot, expiry in grabbed["entries"].entries()
        }
        with self._view_lock:
            self._view = view

    # -- lifecycle / parity surface -------------------------------------

    def flush(self) -> None:
        """Drain: everything enqueued before this call is committed to
        the card AND reconciled into the view (Flush analog,
        memcached/cache_impl.go:176-178)."""
        self._dispatcher.flush()

    def close(self) -> None:
        self._dispatcher.stop()

    def bind_health(self, health) -> None:
        """The dispatcher's death, or `unhealthy_after` consecutive
        failed commits, flip the service NOT_SERVING; a later commit
        that succeeds flips it back."""
        log = logging.getLogger("ratelimit.health")

        def on_state(healthy: bool, reason: str) -> None:
            if healthy:
                log.info("cuda backend healthy again: %s", reason)
                health.ok()
            else:
                log.error("cuda backend unhealthy: %s", reason)
                health.fail()

        self._dispatcher.on_state = on_state

    def register_stats(self, store, scope: str = "ratelimit.tpu") -> None:
        """The JAX package's gauges and counters under its names: the
        one bank's occupancy, evictions and dispatcher queue, and the
        host view's size."""
        base = scope + ".bank0"
        store.gauge_fn(base + ".live_keys", lambda: self.engine.stat_live_keys)
        store.counter_fn(base + ".evictions", lambda: self.engine.stat_evictions)
        store.counter_fn(
            base + ".window_rollovers", lambda: self.engine.stat_window_rollovers
        )
        store.gauge_fn(base + ".num_slots", lambda: self.engine.model.num_slots)
        store.gauge_fn(
            base + ".slot_fill_pct",
            lambda: (
                100 * self.engine.stat_live_keys // max(1, self.engine.model.num_slots)
            ),
        )
        store.gauge_fn(base + ".dispatch_queue", lambda: self._dispatcher.queue_depth())
        store.gauge_fn(
            base + ".dispatch_queue_hwm", lambda: self._dispatcher.queue_depth_hwm()
        )
        store.gauge_fn(scope + ".host_view_keys", lambda: len(self._view))

    def engines(self):
        return [self.engine]

    def run_exclusive(self, engine, fn) -> None:
        self._dispatcher.run_on_thread(fn)

    def warmup(self) -> None:
        """Run every (bucket, readback-dtype) shape of the one bank
        before serving: a kernel that fails to build or launch fails
        the boot."""
        warmup_engine(self.engine)

    @property
    def per_second_engine(self):  # checkpoint surface parity
        return None

    @staticmethod
    def _reset_seconds(rule: RateLimitRule, now: int, cache: dict) -> int:
        return reset_seconds_cached(rule.limit.unit, now, cache)
