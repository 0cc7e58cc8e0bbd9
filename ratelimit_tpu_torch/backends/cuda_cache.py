"""CudaRateLimitCache: the RateLimitCache implementation over the torch
counter engine.

Port of ratelimit_tpu/backends/tpu_cache.py (TpuRateLimitCache) for
one fixed-window lane plus the algorithm banks: one CounterEngine per
bank, one dispatcher per bank.  Rules carrying ``algorithm:
sliding_window`` or ``algorithm: gcra`` route to that algorithm's bank
-- as the ENFORCING bank, or with ``shadow: true`` as a CANDIDATE whose
would-be decision is compared with the fixed-window one that still
enforces (``ratelimit.tpu.shadow.<algo>.{agree,diverge}``).  Per-second
banks, several host lanes, the device fault domain, hot-key tracking
and the flight/launch recorders are not ported yet (ROADMAP.md); the
runner refuses the settings that select them.  The request path is the
reference's:

1. ``hits_addend = max(1, request.hits_addend)``;
2. window-aligned cache keys + TotalHits stats (through the
   descriptor-resolution cache on the fast path);
3. host over-limit cache short-circuit (shadow-aware);
4. engine-bound lanes run inline (batch_window_us=0) or through the
   micro-batching dispatcher (one device launch shared by concurrent
   RPCs);
5. statuses with duration-until-reset; first over-limit transitions
   populate the host cache with TTL = full window.

Backend failures surface as service.CacheError.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from ..api import Code, DescriptorStatus, RateLimitRequest
from ..config import RateLimitRule
from ..limiter.cache_key import CacheKeyGenerator, EMPTY_KEY
from ..limiter.local_cache import LocalCache
from ..limiter.resolution import ResolutionCache
from ..models.registry import ALGORITHMS
from ..utils.time import (
    TimeSource,
    RealTimeSource,
    reset_seconds_cached,
    unit_to_divider,
    window_start,
)
from .dispatcher import (
    LANE_DTYPE,
    BatchDispatcher,
    LanePack,
    WorkItem,
    run_items,
)
from .engine import CounterEngine, HostBatch, HostDecisions

# Device code -> api Code without an enum __call__ per lane.
_CODE_BY_VALUE = {c.value: c for c in Code}
_OVER_VALUE = int(Code.OVER_LIMIT)

_CAT_NONE = 0  # no matching rule: OK, no stats
_CAT_ENGINE = 1  # goes to the counter engine
_CAT_LOCAL = 2  # host cache says over-limit: short-circuit
_CAT_SKIP = 3  # shadow rule + cached over-limit: skip counter, OK

#: DEVICE_FAILURE_MODE values (the reference's fault_domain names).
#: Without the fault domain only the caller-deadline path reads it:
#: "deny" answers OVER_LIMIT, "allow" and "host" answer OK.
FAILURE_MODES = frozenset({"allow", "deny", "host"})


class _StaticAnswer:
    """allow/deny synthesizer for the caller-deadline path (the
    reference's host_engine.StaticFallbackEngine): a fixed code per
    lane, zero stat deltas, no state.  Shadow rules never enforce."""

    def __init__(self, allow: bool):
        self.allow = bool(allow)

    def submit_packed(self, now: int, key_blob, meta: np.ndarray):
        n = len(meta)
        z = np.zeros(n, dtype=np.int64)
        limits = meta["limits"].astype(np.int64)
        if self.allow:
            codes = np.full(n, int(Code.OK), dtype=np.int32)
            remaining = limits
        else:
            codes = np.where(
                meta["shadow"] != 0, int(Code.OK), int(Code.OVER_LIMIT)
            ).astype(np.int32)
            remaining = z
        return HostDecisions(
            codes, remaining, z, z, z, z, z, z, np.zeros(n, dtype=bool)
        )

    def step_complete(self, token):
        return token


_STATIC_ALLOW = _StaticAnswer(allow=True)
_STATIC_DENY = _StaticAnswer(allow=False)


def warmup_engine(engine) -> None:
    """Run every (bucket, readback-dtype) kernel shape once with inert
    batches -- distinct in-table slots, hits=0, fresh=False, which set
    each counter to its own value -- so the first real RPC pays no
    kernel build or first-launch cost.  Counter state and the slot
    table are untouched."""
    for bucket in engine.buckets:
        probe_slots = engine.warmup_probe_slots(bucket)
        width = len(probe_slots)
        for probe_limit in (100, 60_000, 3_000_000_000):
            engine.step(
                HostBatch(
                    slots=probe_slots,
                    hits=np.zeros(width, np.uint32),
                    limits=np.full(width, probe_limit, np.uint32),
                    fresh=np.zeros(width, bool),
                    shadow=np.zeros(width, bool),
                )
            )


def _engine_failure(exc):
    from ..service import CacheError

    return CacheError(f"counter engine failure: {exc}")


class CudaRateLimitCache:
    def __init__(
        self,
        engine: CounterEngine,
        time_source: Optional[TimeSource] = None,
        local_cache: Optional[LocalCache] = None,
        expiration_jitter_max_seconds: int = 0,
        cache_key_prefix: str = "",
        jitter_rand: Optional[random.Random] = None,
        batch_window_us: int = 0,
        batch_limit: int = 4096,
        dispatch_timeout_s: float = 120.0,
        pipeline_depth: int = 2,
        unhealthy_after: int = 3,
        resolution_cache_entries: int = 1 << 16,
        device_failure_mode: str = "host",
        algorithm_banks: Optional[dict] = None,
    ):
        """`algorithm_banks` maps a non-default algorithm name
        (models/registry.py) to the CounterEngine serving it; rules
        naming an algorithm with no bank fold back to fixed-window."""
        if device_failure_mode not in FAILURE_MODES:
            raise ValueError(
                f"DEVICE_FAILURE_MODE must be one of "
                f"{sorted(FAILURE_MODES)}, got {device_failure_mode!r}"
            )
        self.engine = engine
        self.algorithm_banks: dict = {
            name: eng for name, eng in (algorithm_banks or {}).items() if eng is not None
        }
        for name in self.algorithm_banks:
            if name not in ALGORITHMS:
                raise ValueError(f"unknown algorithm bank {name!r}")
        self._algo_order = sorted(self.algorithm_banks)
        # Shadow-rollout divergence tallies per algorithm: [agree,
        # diverge] plain ints bumped on the RPC thread (stats-only GIL
        # races accepted, like the resolver tallies).
        self._shadow_counts = {name: [0, 0] for name in self._algo_order}
        self.time_source = time_source or RealTimeSource()
        self.local_cache = local_cache
        self.key_generator = CacheKeyGenerator(cache_key_prefix)
        # Descriptor-resolution fast path (limiter/resolution.py): one
        # dict hit per descriptor; 0 disables it.
        self.resolver = (
            ResolutionCache(
                prefix=cache_key_prefix,
                n_lanes=1,
                lane_dtype=LANE_DTYPE,
                capacity=resolution_cache_entries,
                algorithms=frozenset(self.algorithm_banks),
            )
            if resolution_cache_entries > 0
            else None
        )
        self.device_failure_mode = device_failure_mode
        self.stat_deadline_answers = 0
        self.expiration_jitter_max_seconds = int(expiration_jitter_max_seconds)
        self.jitter_rand = jitter_rand or random.Random()
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._jitter_lock = threading.Lock()
        # Recycled WorkItem events; recycled ONLY after a successful
        # wait().  Take via _pool_event() (EAFP pop).
        self._event_pool: List[threading.Event] = []
        # Inline mode (batch_window_us=0) runs each engine step on the
        # RPC caller thread under that engine's lock; otherwise one
        # dispatcher thread pair per bank owns its engine exclusively.
        self._inline_locks = {id(e): threading.Lock() for e in self.engines()}
        self._dispatchers: dict = {}
        if batch_window_us > 0:
            for eng, name in zip(
                self.engines(),
                ["cuda-dispatcher"] + ["cuda-dispatcher-" + n for n in self._algo_order],
            ):
                self._dispatchers[id(eng)] = BatchDispatcher(
                    eng,
                    int(batch_window_us),
                    int(batch_limit),
                    name=name,
                    pipeline_depth=pipeline_depth,
                    unhealthy_after=unhealthy_after,
                )

    @property
    def dispatcher(self) -> Optional[BatchDispatcher]:
        """The fixed-window lane's dispatcher (None in inline mode)."""
        return self._dispatchers.get(id(self.engine))

    def engines(self) -> list:
        """Every bank: the fixed-window lane, then the algorithm banks
        in sorted-name order (the reference's bank order)."""
        return [self.engine] + [self.algorithm_banks[n] for n in self._algo_order]

    # -- RateLimitCache seam --------------------------------------------

    def _prepare(
        self,
        request: RateLimitRequest,
        limits: Sequence[Optional[RateLimitRule]],
    ):
        """The host-side front half of do_limit (key generation,
        local-cache check, lane packing) with no device work.  Returns
        (items, statuses, categories, hits_addend, now)."""
        n = len(request.descriptors)
        if n != len(limits):
            raise ValueError("one limit per descriptor expected")
        hits_addend = max(1, request.hits_addend)
        now = self.time_source.unix_now()
        categories = [_CAT_NONE] * n
        rows: List[int] = []
        local_cache = self.local_cache

        keys = []
        for desc, rule in zip(request.descriptors, limits):
            key = self.key_generator.generate(request.domain, desc, rule, now)
            keys.append(key)
            if rule is not None and not rule.unlimited:
                rule.stats.total_hits.add(hits_addend)

        for i, (key, rule) in enumerate(zip(keys, limits)):
            if key.key == "":
                continue
            if local_cache is not None and local_cache.contains(key.key):
                # Shadow rules skip the counter but never short-
                # circuit to OVER_LIMIT (fixed_cache_impl.go:57-67).
                categories[i] = _CAT_SKIP if rule.shadow_mode else _CAT_LOCAL
                continue
            categories[i] = _CAT_ENGINE
            rows.append(i)

        statuses: List[Optional[DescriptorStatus]] = [None] * n
        items = []
        if rows:
            items.append(
                (
                    self.engine,
                    self._make_item(rows, keys, limits, hits_addend, now, statuses),
                )
            )
        return items, statuses, categories, hits_addend, now

    def _prepare_resolved(self, request: RateLimitRequest, config):
        """The one-dict-hit front half (limiter/resolution.py): rule
        lookup, key, TotalHits, local-cache check, bank routing and
        per-bank pack assembly fused into a single pass over the
        descriptors.  Returns (items, statuses, categories, limits,
        is_unlimited, hits_addend, now, shadow_info); items are
        (engine, WorkItem) pairs."""
        resolver = self.resolver
        descriptors = request.descriptors
        domain = request.domain
        n = len(descriptors)
        hits_addend = max(1, request.hits_addend)
        hits_clamped = min(hits_addend, 0xFFFFFFFF)
        now = self.time_source.unix_now()

        limits: list = [None] * n
        is_unlimited = [False] * n
        keys: list = [EMPTY_KEY] * n
        categories = [_CAT_NONE] * n
        rows: List[int] = []
        enc: List[bytes] = []
        tparts: List[bytes] = []
        local_cache = self.local_cache
        entries_map = resolver._entries
        generation = config.generation
        resolution_hits = 0
        overrides: Optional[list] = None
        # Algorithm-bank routing state, allocated lazily: an
        # all-fixed-window request pays one int-truthiness branch per
        # descriptor and nothing else.
        algo_accs: Optional[dict] = None  # name -> (rows, enc, tpl)
        shadow_accs: Optional[dict] = None  # name -> (rows, enc, tpl)
        shadow_rows: Optional[list] = None  # (i, name)
        raw_over: Optional[list] = None  # enforced pre-shadow over-ness
        cand_over: Optional[list] = None  # candidate over-ness
        # TotalHits adds batched by rule identity.
        prev_rule = None
        prev_hits = 0
        for i, desc in enumerate(descriptors):
            if desc.limit is not None:
                # Request-supplied override: uncached leg below.
                if overrides is None:
                    overrides = []
                overrides.append(i)
                continue
            rd = entries_map.get((domain, desc.entries))
            if rd is not None and rd.generation == generation:
                resolution_hits += 1
            else:
                rd = resolver.resolve(config, domain, desc)
            rule = rd.rule
            if rule is None:
                continue  # no matching rule: CAT_NONE, empty key
            if rd.unlimited:
                is_unlimited[i] = True
                continue  # limits[i] stays None (service contract)
            limits[i] = rule
            if rule is prev_rule:
                prev_hits += hits_addend
            else:
                if prev_rule is not None:
                    prev_rule.stats.total_hits.add(prev_hits)
                prev_rule = rule
                prev_hits = hits_addend
            ws = rd._win
            if ws is None or ws.window != now - now % rd.divider:
                ws = rd.window_state(now)
            key = keys[i] = ws.cache_key
            algo_id = rd.algo_id
            if algo_id and not rd.algo_shadow:
                # The rule ENFORCES a non-default algorithm: route to its
                # bank.  The host over-limit cache is skipped -- these
                # kernels refill capacity continuously, so a full-window
                # OVER_LIMIT verdict has no valid TTL.
                categories[i] = _CAT_ENGINE
                if algo_accs is None:
                    algo_accs = {}
                acc = algo_accs.get(rd.algorithm)
                if acc is None:
                    acc = algo_accs[rd.algorithm] = ([], [], [])
                acc[0].append(i)
                acc[1].append(ws.algo_key_bytes)
                acc[2].append(ws.algo_template_bytes)
                continue
            if local_cache is not None and local_cache.contains(key.key):
                categories[i] = _CAT_SKIP if rule.shadow_mode else _CAT_LOCAL
                continue
            categories[i] = _CAT_ENGINE
            if algo_id:
                # Shadow rollout: the candidate kernel evaluates the same
                # descriptor on its bank while fixed-window enforces;
                # divergence is tallied after both complete.
                if shadow_accs is None:
                    shadow_accs = {}
                    shadow_rows = []
                    raw_over = [False] * n
                    cand_over = [None] * n
                sa = shadow_accs.get(rd.algorithm)
                if sa is None:
                    sa = shadow_accs[rd.algorithm] = ([], [], [])
                sa[0].append(i)
                sa[1].append(ws.algo_key_bytes)
                sa[2].append(ws.algo_template_bytes)
                shadow_rows.append((i, rd.algorithm))
            rows.append(i)
            enc.append(ws.key_bytes)
            tparts.append(ws.template_bytes)
        if prev_rule is not None:
            prev_rule.stats.total_hits.add(prev_hits)
        if resolution_hits:
            resolver.hits += resolution_hits

        if overrides is not None:
            self._route_overrides(
                overrides, request, config, limits, is_unlimited, keys,
                categories, rows, enc, tparts, hits_addend, hits_clamped,
                now,
            )

        statuses: List[Optional[DescriptorStatus]] = [None] * n
        items = []
        if rows:
            items.append(
                (
                    self.engine,
                    self._make_packed_item(
                        rows, keys, limits, hits_addend, now, statuses, enc,
                        tparts, raw_over,
                    ),
                )
            )
        if algo_accs is not None:
            # Enforcing banks: statuses and stats assemble exactly like
            # the lane's, from the generic engine's decisions.
            for name, (a_rows, a_enc, a_tparts) in algo_accs.items():
                items.append(
                    (
                        self.algorithm_banks[name],
                        self._make_packed_item(
                            a_rows, keys, limits, hits_addend, now, statuses,
                            a_enc, a_tparts,
                        ),
                    )
                )
        shadow_info = None
        if shadow_accs is not None:
            # Shadow candidates record the candidate kernel's would-be
            # outcome and touch nothing else.
            for name, (s_rows, s_enc, s_tparts) in shadow_accs.items():
                items.append(
                    (
                        self.algorithm_banks[name],
                        self._make_candidate_item(
                            s_rows, hits_addend, now, s_enc, s_tparts, cand_over
                        ),
                    )
                )
            shadow_info = (shadow_rows, raw_over, cand_over)
        return (
            items, statuses, categories, limits, is_unlimited, hits_addend,
            now, shadow_info,
        )

    def _route_overrides(
        self,
        overrides: List[int],
        request: RateLimitRequest,
        config,
        limits,
        is_unlimited,
        keys,
        categories,
        rows,
        enc,
        tparts,
        hits_addend: int,
        hits_clamped: int,
        now: int,
    ) -> None:
        """Uncached leg for request-supplied override descriptors: the
        get_limit + key-generator pipeline, appended to the same pack
        accumulators as the fast path."""
        local_cache = self.local_cache
        scratch = np.empty(1, dtype=LANE_DTYPE)
        expiry_by_unit: dict = {}
        for i in overrides:
            desc = request.descriptors[i]
            rule = config.get_limit(request.domain, desc)
            if rule is not None and rule.unlimited:
                is_unlimited[i] = True
                continue
            limits[i] = rule
            key = self.key_generator.generate(request.domain, desc, rule, now)
            keys[i] = key
            if key.key == "":
                continue
            rule.stats.total_hits.add(hits_addend)
            if local_cache is not None and local_cache.contains(key.key):
                categories[i] = _CAT_SKIP if rule.shadow_mode else _CAT_LOCAL
                continue
            categories[i] = _CAT_ENGINE
            b = key.key.encode("utf-8")
            unit = rule.limit.unit
            e = expiry_by_unit.get(unit)
            if e is None:
                e = expiry_by_unit[unit] = window_start(
                    now, unit
                ) + unit_to_divider(unit)
            scratch[0] = (
                e,
                hits_clamped,
                rule.limit.requests_per_unit,
                len(b),
                1 if rule.shadow_mode else 0,
                0,  # divider: overrides always enforce fixed-window
                0,  # algo: fixed_window
            )
            rows.append(i)
            enc.append(b)
            tparts.append(scratch.tobytes())

    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[Optional[RateLimitRule]],
    ) -> List[DescriptorStatus]:
        items, statuses, categories, hits_addend, now = self._prepare(
            request, limits
        )
        return self._execute(
            limits, items, statuses, categories, hits_addend, now,
            len(request.descriptors), deadline=request.deadline,
        )

    def do_limit_resolved(self, request: RateLimitRequest, config):
        """The descriptor-resolution fast path.  Returns (statuses,
        limits, is_unlimited), decision-identical to the service's
        get_limit + do_limit pair."""
        (
            items, statuses, categories, limits, is_unlimited, hits_addend,
            now, shadow_info,
        ) = self._prepare_resolved(request, config)
        statuses = self._execute(
            limits, items, statuses, categories, hits_addend, now,
            len(request.descriptors), deadline=request.deadline,
        )
        if shadow_info is not None:
            self._note_shadow_outcomes(*shadow_info)
        return statuses, limits, is_unlimited

    def _note_shadow_outcomes(self, shadow_rows, raw_over, cand_over) -> None:
        """Tally shadow-rollout divergence: for every shadowed
        descriptor that reached the engines, compare the candidate
        kernel's would-be over-ness with the enforced fixed-window one
        (both before shadow_mode, so a rule that also suppresses
        OVER_LIMIT still measures real divergence)."""
        counts = self._shadow_counts
        for i, name in shadow_rows:
            co = cand_over[i]
            if co is None:
                continue  # candidate never evaluated
            counts[name][0 if co == raw_over[i] else 1] += 1

    def _execute(
        self,
        limits,
        items: List[tuple],
        statuses,
        categories,
        hits_addend: int,
        now: int,
        n: int,
        deadline: Optional[float] = None,
    ) -> List[DescriptorStatus]:
        """The device half: submit, wait -- bounded by the dispatch
        timeout and the caller's remaining RPC deadline (`deadline`,
        absolute time.monotonic seconds) -- then fill the non-engine
        categories.  `items` are (engine, WorkItem) pairs; every bank's
        item is submitted before the first wait, so the banks' device
        steps overlap.  A wait cut short by the CALLER's deadline
        answers per DEVICE_FAILURE_MODE; device errors raise
        CacheError."""
        done: List[WorkItem] = []
        for engine, item in items:
            d = self._dispatchers.get(id(engine))
            if d is None:
                with self._inline_locks[id(engine)]:
                    run_items(engine, [item])
            else:
                try:
                    d.submit(item)
                except Exception as e:
                    raise _engine_failure(e) from e
        for _engine, item in items:
            timeout = self.dispatch_timeout_s
            caller_bound = False
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining < timeout:
                    timeout = max(0.0, remaining)
                    caller_bound = True
            try:
                item.wait(timeout)
            except TimeoutError as e:
                if caller_bound:
                    self._answer_failure_mode(item)
                    continue
                raise _engine_failure(e) from e
            except Exception as e:
                raise _engine_failure(e) from e
            done.append(item)
        pool = self._event_pool
        if len(pool) < 1024:
            for item in done:
                item.event.clear()
                pool.append(item.event)

        # Non-engine categories.
        reset_cache: dict = {}
        for i in range(n):
            if statuses[i] is not None:
                continue
            rule = limits[i]
            cat = categories[i]
            if cat == _CAT_NONE:
                statuses[i] = DescriptorStatus(code=Code.OK)
                continue
            duration = reset_seconds_cached(rule.limit.unit, now, reset_cache)
            if cat == _CAT_LOCAL:
                rule.stats.over_limit.add(hits_addend)
                rule.stats.over_limit_with_local_cache.add(hits_addend)
                statuses[i] = DescriptorStatus(
                    code=Code.OVER_LIMIT,
                    current_limit=rule.limit,
                    limit_remaining=0,
                    duration_until_reset=duration,
                )
            else:  # _CAT_SKIP: shadow + cached over-limit -> plain OK
                rule.stats.within_limit.add(hits_addend)
                statuses[i] = DescriptorStatus(
                    code=Code.OK,
                    current_limit=rule.limit,
                    limit_remaining=rule.limit.requests_per_unit,
                    duration_until_reset=duration,
                )
        return statuses  # type: ignore[return-value]

    def _answer_failure_mode(self, item: WorkItem) -> None:
        """Caller-deadline expiry on a healthy (just slow) device:
        answer per DEVICE_FAILURE_MODE with zero stat deltas, through
        a fresh twin of `item` (a late completer may still signal the
        original's event)."""
        clone = WorkItem(
            now=item.now, lanes=(), pack=item.get_pack(), apply=item.apply,
            defer_apply=True,
        )
        run_items(
            _STATIC_DENY if self.device_failure_mode == "deny" else _STATIC_ALLOW,
            [clone],
        )
        clone.wait(5.0)
        self.stat_deadline_answers += 1

    def bind_health(self, health) -> None:
        """Dispatcher death or N consecutive device-step failures flip
        grpc.health.v1 to NOT_SERVING; a later success flips back."""
        import logging

        log = logging.getLogger("ratelimit.health")
        # SERVING only while EVERY bank's dispatcher is healthy: one bank
        # recovering must not mask another still failing.
        states = {key: True for key in self._dispatchers}
        lock = threading.Lock()

        def make_on_state(key: int):
            def on_state(healthy: bool, reason: str) -> None:
                with lock:
                    states[key] = healthy
                    if healthy:
                        log.info("cuda backend healthy again: %s", reason)
                        if all(states.values()):
                            health.ok()
                    else:
                        log.error("cuda backend unhealthy: %s", reason)
                        health.fail()

            return on_state

        for key, d in self._dispatchers.items():
            d.on_state = make_on_state(key)

    def flush(self) -> None:
        """Drain the dispatcher queues (deterministic test hook; the
        graceful-drain leg of runner.stop)."""
        for d in list(self._dispatchers.values()):
            if d.dead is None:
                d.flush()

    def close(self) -> None:
        dispatchers, self._dispatchers = list(self._dispatchers.values()), {}
        for d in dispatchers:
            d.stop(timeout=0.5 if d.dead is not None else 10.0)

    # Batch-size histogram ladder: powers of two up to the default
    # batch limit (these histograms count lanes/items, not ms).
    _BATCH_BOUNDS = tuple(float(1 << i) for i in range(13))

    def register_stats(self, store, scope: str = "ratelimit.tpu") -> None:
        """Live gauges for each bank (slot-table occupancy/evictions,
        dispatcher queue depth, in-flight launches, batch-shape
        histograms), the resolution/stem cache counters and the
        shadow-rollout agree/diverge counters per algorithm bank, under
        the reference's metric names."""
        kg = self.key_generator
        store.counter_fn(scope + ".stem_cache_clears", lambda: kg.clears)
        store.gauge_fn(scope + ".stem_cache.entries", lambda: len(kg))
        res = self.resolver
        if res is not None:
            store.counter_fn(scope + ".resolution_cache.hits", lambda: res.hits)
            store.counter_fn(
                scope + ".resolution_cache.misses", lambda: res.misses
            )
            store.counter_fn(
                scope + ".resolution_cache.clears", lambda: res.clears
            )
            store.gauge_fn(scope + ".resolution_cache.entries", lambda: len(res))
        # One agree/diverge pair per algorithm bank: bounded by the
        # algorithm table, not by traffic.
        for name in self._algo_order:
            pair = self._shadow_counts[name]
            store.counter_fn(scope + ".shadow." + name + ".agree", lambda p=pair: p[0])
            store.counter_fn(
                scope + ".shadow." + name + ".diverge", lambda p=pair: p[1]
            )
        store.counter_fn(
            scope + ".fault.deadline_answers",
            lambda: self.stat_deadline_answers,
        )
        for idx, eng in enumerate(self.engines()):
            base = f"{scope}.bank{idx}"
            store.gauge_fn(base + ".live_keys", lambda e=eng: e.stat_live_keys)
            store.counter_fn(base + ".evictions", lambda e=eng: e.stat_evictions)
            store.counter_fn(
                base + ".window_rollovers", lambda e=eng: e.stat_window_rollovers
            )
            store.gauge_fn(base + ".num_slots", lambda e=eng: e.model.num_slots)
            store.gauge_fn(
                base + ".slot_fill_pct",
                lambda e=eng: 100 * e.stat_live_keys // max(1, e.model.num_slots),
            )
            d = self._dispatchers.get(id(eng))
            if d is not None:
                store.gauge_fn(base + ".dispatch_queue", d.queue_depth)
                store.gauge_fn(base + ".dispatch_queue_hwm", d.queue_depth_hwm)
                store.gauge_fn(base + ".inflight_launches", d.inflight)
                store.gauge_fn(base + ".inflight_hwm", d.inflight_hwm)
                d.batch_lanes_hist = store.histogram(
                    base + ".batch_lanes", self._BATCH_BOUNDS
                )
                d.batch_items_hist = store.histogram(
                    base + ".batch_items", self._BATCH_BOUNDS
                )

    def warmup(self) -> None:
        """Run every (bucket, readback-dtype) shape of every bank before
        serving."""
        for eng in self.engines():
            warmup_engine(eng)

    # -- internals -------------------------------------------------------

    def _make_item(
        self, rows, keys, limits, hits_addend, now, statuses
    ) -> WorkItem:
        """Pack this request's engine-bound lanes on the RPC thread
        (the legacy, non-resolved path)."""
        jitters = self._draw_jitters(rows)
        enc: List[bytes] = []
        hits_clamped = min(hits_addend, 0xFFFFFFFF)
        expiry_by_unit: dict = {}
        meta = np.empty(len(rows), dtype=LANE_DTYPE)
        for j, i in enumerate(rows):
            rule = limits[i]
            unit = rule.limit.unit
            e = expiry_by_unit.get(unit)
            if e is None:
                e = expiry_by_unit[unit] = window_start(
                    now, unit
                ) + unit_to_divider(unit)
            b = keys[i].key.encode("utf-8")
            enc.append(b)
            meta[j] = (
                e,
                0,  # hits stamped for all rows below
                rule.limit.requests_per_unit,
                len(b),
                1 if rule.shadow_mode else 0,
                0,  # divider: fixed-window only
                0,  # algo: fixed_window
            )
        meta["hits"] = hits_clamped
        if jitters is not None:
            meta["expiry"] += np.asarray(jitters, dtype=np.int64)
        pack = LanePack(key_blob=b"".join(enc), meta=meta)
        return self._finish_item(rows, keys, limits, hits_addend, now, statuses, pack)

    def _pool_event(self) -> threading.Event:
        try:
            return self._event_pool.pop()
        except IndexError:
            return threading.Event()

    def _make_packed_item(
        self, rows, keys, limits, hits_addend, now, statuses, enc, tparts,
        raw_over: Optional[list] = None,
    ) -> WorkItem:
        """Resolution-fast-path packer: the accumulators already hold
        the memoized key bytes and template records (hits=1
        pre-stamped), so the pack is two joins and two views."""
        pack = self._template_pack(hits_addend, enc, tparts)
        jitters = self._draw_jitters(rows)
        if jitters is not None:
            pack.meta["expiry"] += np.asarray(jitters, dtype=np.int64)
        return self._finish_item(
            rows, keys, limits, hits_addend, now, statuses, pack, raw_over
        )

    @staticmethod
    def _template_pack(hits_addend, enc, tparts) -> LanePack:
        """The LanePack of the memoized key bytes `enc` and template
        records `tparts` (hits=1 pre-stamped), with this request's hits."""
        buf = bytearray(b"".join(tparts))
        meta = np.frombuffer(buf, dtype=LANE_DTYPE)
        hits_clamped = min(hits_addend, 0xFFFFFFFF)
        if hits_clamped != 1:
            meta["hits"] = hits_clamped
        return LanePack(
            key_blob=b"".join(enc),
            meta=meta,
            meta_u8=np.frombuffer(buf, dtype=np.uint8),
        )

    def _make_candidate_item(
        self, rows, hits_addend, now, enc, tparts, cand_over: list
    ) -> WorkItem:
        """Shadow-candidate packer: the same template pack as
        _make_packed_item, but the apply records ONLY the candidate
        kernel's would-be over-ness (before shadow_mode) -- no
        statuses, no rule stats, no local cache, so a shadowed rule's
        responses stay byte-identical to plain fixed-window."""
        pack = self._template_pack(hits_addend, enc, tparts)

        def apply(decisions: HostDecisions) -> None:
            codes = decisions.codes.tolist()
            shadow = decisions.shadow_mode.tolist()
            for j, i in enumerate(rows):
                cand_over[i] = codes[j] == _OVER_VALUE or shadow[j] > 0

        return WorkItem(
            now=now,
            lanes=(),
            pack=pack,
            apply=apply,
            defer_apply=True,
            event=self._pool_event(),
        )

    def _draw_jitters(self, rows) -> Optional[List[int]]:
        if self.expiration_jitter_max_seconds <= 0:
            return None
        # Spread slot reclamation like the reference spreads Redis
        # TTLs; one lock acquisition per request, not per lane.
        with self._jitter_lock:
            return [
                self.jitter_rand.randrange(self.expiration_jitter_max_seconds)
                for _ in rows
            ]

    def _finish_item(
        self, rows, keys, limits, hits_addend, now, statuses, pack,
        raw_over: Optional[list] = None,
    ) -> WorkItem:
        def apply(decisions: HostDecisions) -> None:
            self._apply_decisions(
                rows, keys, limits, hits_addend, now, decisions, statuses,
                raw_over,
            )

        # defer_apply: status assembly runs on THIS RPC thread inside
        # item.wait(), not on the dispatcher's completer.
        return WorkItem(
            now=now,
            lanes=(),
            pack=pack,
            apply=apply,
            defer_apply=True,
            event=self._pool_event(),
        )

    def _apply_decisions(
        self, rows, keys, limits, hits_addend, now, decisions, statuses,
        raw_over: Optional[list] = None,
    ) -> None:
        reset_cache: dict = {}
        codes = decisions.codes.tolist()
        remaining = decisions.limit_remaining.tolist()
        over = decisions.over_limit.tolist()
        near = decisions.near_limit.tolist()
        within = decisions.within_limit.tolist()
        shadow = decisions.shadow_mode.tolist()
        set_lc = decisions.set_local_cache.tolist()
        local_cache = self.local_cache
        for j, i in enumerate(rows):
            rule = limits[i]
            stats = rule.stats
            if raw_over is not None:
                # Over-ness before shadow_mode, for the shadow-rollout
                # comparison (_note_shadow_outcomes).
                raw_over[i] = codes[j] == _OVER_VALUE or shadow[j] > 0
            v = over[j]
            if v:
                stats.over_limit.add(int(v))
            v = near[j]
            if v:
                stats.near_limit.add(int(v))
            v = within[j]
            if v:
                stats.within_limit.add(int(v))
            v = shadow[j]
            if v:
                stats.shadow_mode.add(int(v))
            if local_cache is not None and set_lc[j]:
                local_cache.set(keys[i].key, unit_to_divider(rule.limit.unit))
            statuses[i] = DescriptorStatus(
                code=_CODE_BY_VALUE[int(codes[j])],
                current_limit=rule.limit,
                limit_remaining=int(remaining[j]),
                duration_until_reset=reset_seconds_cached(
                    rule.limit.unit, now, reset_cache
                ),
            )
