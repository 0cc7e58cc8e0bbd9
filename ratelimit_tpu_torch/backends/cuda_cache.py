"""CudaRateLimitCache: the RateLimitCache implementation over the torch
counter engine.

Port of ratelimit_tpu/backends/tpu_cache.py (TpuRateLimitCache).  Its
banks, in the reference's order (engines()): N fixed-window host LANES,
each with its own engine, slot table, dispatcher pair and CUDA stream,
keys split across them by crc32 of the key stem; an optional PER-SECOND
bank for SECOND-unit rules; then one engine per algorithm bank.  Rules
carrying ``algorithm: sliding_window`` or ``algorithm: gcra`` route to
that algorithm's bank -- as the ENFORCING bank, or with ``shadow: true``
as a CANDIDATE whose would-be decision is compared with the
fixed-window one that still enforces
(``ratelimit.tpu.shadow.<algo>.{agree,diverge}``).  With
``kernel_deadline_s > 0`` and a dispatcher per bank, the device fault
domain (backends/fault_domain.py) watches every bank: a stalled or
failing bank is quarantined, answered per DEVICE_FAILURE_MODE and
restarted on its own.  The observability planes hook in as in the
reference: the hot-key sketch (``hotkeys_top_k``) fed on the resolution
fast path, the flight recorder's per-thread notes (decisive descriptor,
shadow candidate, fallback answer), the launch recorder on every bank
dispatcher (attach_launch_recorder) and the event journal, which the
runner hands to the fault domain.  The overload controller's promotion
set (``promotion``) answers a promoted stem OVER_LIMIT before it
reaches a bank, and ``handoff_log`` keeps the counter handoff's
bookkeeping (cluster/handoff.py).  The request path is the
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

Without a fault domain, backend failures surface as
service.CacheError.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence, Union
from zlib import crc32

import numpy as np

from ..api import Code, DescriptorStatus, RateLimitRequest
from ..config import RateLimitRule
from ..limiter.cache_key import CacheKeyGenerator, EMPTY_KEY
from ..limiter.local_cache import LocalCache
from ..limiter.resolution import ResolutionCache
from ..models.registry import ALGORITHMS
from ..observability import TRACER, HotKeySketch
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
from .engine import (
    CounterEngine,
    HostBatch,
    HostDecisions,
    stream_idle,
)
from .fault_domain import (
    FAILURE_MODES,
    FAULT_HANG,
    DeviceFaultDomain,
    classify_fault,
    kernel_defect,
)
from .host_engine import STATIC_ALLOW, STATIC_DENY

# Device code -> api Code without an enum __call__ per lane.
_CODE_BY_VALUE = {c.value: c for c in Code}
_OVER_VALUE = int(Code.OVER_LIMIT)

_CAT_NONE = 0  # no matching rule: OK, no stats
_CAT_ENGINE = 1  # goes to the counter engine
_CAT_LOCAL = 2  # host cache says over-limit: short-circuit
_CAT_SKIP = 3  # shadow rule + cached over-limit: skip counter, OK


def warmup_engine(engine) -> None:
    """Run every (bucket, readback-dtype) kernel shape once with inert
    batches -- distinct in-table slots, hits=0, fresh=False, which set
    each counter to its own value -- so the first real RPC pays no
    kernel build or first-launch cost.  Counter state and the slot
    table are untouched.  The fault domain's supervisor runs it on a
    restarted engine before re-admitting it."""
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
        engine: Union[CounterEngine, Sequence[CounterEngine]],
        time_source: Optional[TimeSource] = None,
        per_second_engine: Optional[CounterEngine] = None,
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
        kernel_deadline_s: float = 0.0,
        fault_clock=None,
        fault_restart_backoff_s: float = 2.0,
        fault_snapshot_interval_s: float = 30.0,
        fault_interval_s: Optional[float] = None,
        fault_probe_timeout_s: Optional[float] = None,
        engine_factory=None,
        hotkeys_top_k: int = 0,
    ):
        """`engine` may be a LIST of engines: N independent host lanes,
        each with its own slot table, dispatcher thread pair and CUDA
        stream; keys split across them by crc32 of the key stem, so the
        lanes' serial host legs can run side by side (the reference's
        docs/HOST_LANES.md).  `per_second_engine` serves SECOND-unit
        rules.  `algorithm_banks` maps a non-default algorithm name
        (models/registry.py) to the CounterEngine serving it; rules
        naming an algorithm with no bank fold back to fixed-window.
        `kernel_deadline_s` > 0 (with batch_window_us > 0) builds the
        device fault domain; the `fault_*` knobs and `engine_factory`
        are its own (backends/fault_domain.py DeviceFaultDomain), and
        `fault_clock` also stamps the dispatchers' liveness marks.
        `hotkeys_top_k` > 0 builds the hot-key sketch (it needs the
        resolution fast path)."""
        if device_failure_mode not in FAILURE_MODES:
            raise ValueError(
                f"DEVICE_FAILURE_MODE must be one of "
                f"{sorted(FAILURE_MODES)}, got {device_failure_mode!r}"
            )
        lanes = list(engine) if isinstance(engine, (list, tuple)) else [engine]
        if not lanes:
            raise ValueError("need at least one engine lane")
        self.lanes: List[CounterEngine] = lanes
        self.engine = lanes[0]  # lane 0
        self.per_second_engine = per_second_engine
        self.algorithm_banks: dict = {
            name: eng for name, eng in (algorithm_banks or {}).items() if eng is not None
        }
        for name in self.algorithm_banks:
            if name not in ALGORITHMS:
                raise ValueError(f"unknown algorithm bank {name!r}")
        self._algo_order = sorted(self.algorithm_banks)
        # Bank index of each algorithm bank (engines() order): after the
        # lanes and the per-second bank.
        self._n_base = len(lanes) + (per_second_engine is not None)
        self._algo_bank = {
            name: self._n_base + i for i, name in enumerate(self._algo_order)
        }
        # Trace label of each bank index, the JAX package's names for
        # the same banks.
        self._bank_labels = [f"lane{i}" for i in range(len(lanes))]
        if per_second_engine is not None:
            self._bank_labels.append("per_second")
        self._bank_labels += ["algo_" + n for n in self._algo_order]
        # Shadow-rollout divergence tallies per algorithm: [agree,
        # diverge] plain ints bumped on the RPC thread (stats-only GIL
        # races accepted, like the resolver tallies).
        self._shadow_counts = {name: [0, 0] for name in self._algo_order}
        self.time_source = time_source or RealTimeSource()
        self.local_cache = local_cache
        self.key_generator = CacheKeyGenerator(cache_key_prefix)
        # Cluster counter-handoff bookkeeping (cluster/handoff.py's
        # export_from_cache / import_into_cache write it; /debug/cluster
        # and the ratelimit.cluster.* family read it).
        from ..cluster.handoff import HandoffLog

        self.handoff_log = HandoffLog()
        # Descriptor-resolution fast path (limiter/resolution.py): one
        # dict hit per descriptor; 0 disables it.
        self.resolver = (
            ResolutionCache(
                prefix=cache_key_prefix,
                n_lanes=len(lanes),
                lane_dtype=LANE_DTYPE,
                capacity=resolution_cache_entries,
                algorithms=frozenset(self.algorithm_banks),
            )
            if resolution_cache_entries > 0
            else None
        )
        # Hot-key sketch (observability/hotkeys.py): Space-Saving top-K
        # over interned descriptor stems, fed by the resolution fast
        # path (one counter bump per descriptor on a pinned handle).
        # 0 disables; needs the resolver (the handle lives on its
        # entries).
        self.hotkeys = (
            HotKeySketch(hotkeys_top_k)
            if hotkeys_top_k > 0 and self.resolver is not None
            else None
        )
        # Near-limit threshold ratio for the sketch's outcome shares
        # (the engines' decide threshold).
        self._near_ratio = float(getattr(lanes[0].model, "near_ratio", 0.8))
        # Flight recorder (observability/flight.py), attached by the
        # runner when FLIGHT_RECORDER_SIZE > 0: the fast path deposits
        # the decisive descriptor's (stem hash, bank) into its
        # thread-local note, and the transport stamps the record.
        self.flight = None
        # Lifecycle event journal (observability/events.py), attached by
        # the runner when EVENT_JOURNAL_SIZE > 0; the runner hands it to
        # the fault domain as well.
        self.events = None
        # Launch flight recorder (observability/launches.py), attached
        # through attach_launch_recorder when LAUNCH_RECORDER_SIZE > 0.
        self.launches = None
        # Hot-key promotion cache (overload/controller.py), attached by
        # the runner when OVERLOAD_PROMOTE_ENABLED: stems the sketch
        # marked repeat offenders carry a short-TTL host-side OVER_LIMIT
        # decision checked in _prepare_resolved, so they skip the card.
        # None = disabled (one attribute load + branch per request).
        self.promotion = None
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
        # Dispatcher construction knobs, kept so a warm restart builds
        # the new dispatcher exactly like the first (_make_dispatcher).
        self._batch_window_us = int(batch_window_us)
        self._batch_limit = int(batch_limit)
        self._pipeline_depth = pipeline_depth
        self._unhealthy_after = unhealthy_after
        self._stamp_clock = fault_clock
        #: Every bank's current engine by bank index (engines() order);
        #: _swap_bank replaces an entry in place.
        self._bank_engines = self.engines()
        #: (engine, dispatcher) pairs that a restart replaced.  Each keeps
        #: its stream, which may still be stalled, until release_retired
        #: finds it done with; close() gives back the rest.
        self._retired: list = []
        self._dispatchers: dict = {}
        if batch_window_us > 0:
            names = (
                ["cuda-dispatcher"]
                if len(lanes) == 1
                else [f"cuda-dispatcher-lane{i}" for i in range(len(lanes))]
            )
            if per_second_engine is not None:
                names.append("cuda-dispatcher-persecond")
            names += ["cuda-dispatcher-" + n for n in self._algo_order]
            for eng, name in zip(self.engines(), names):
                self._dispatchers[id(eng)] = self._make_dispatcher(eng, name)
        self._health = None
        # Dispatchers (by id) whose last health report was unhealthy,
        # and whether the service was last reported NOT_SERVING.
        self._health_lock = threading.Lock()
        self._unhealthy: set = set()
        self._reported_down = False
        # Device-path fault domain: KERNEL_DEADLINE_S=0 (the library
        # default; the runner's default is 0.25) builds none, and the
        # serving path is then the one without the layer.
        self.fault_domain = None
        if kernel_deadline_s > 0 and self._dispatchers:
            self.fault_domain = DeviceFaultDomain(
                self,
                kernel_deadline_s,
                failure_mode=device_failure_mode,
                clock=fault_clock,
                restart_backoff_s=fault_restart_backoff_s,
                snapshot_interval_s=fault_snapshot_interval_s,
                interval_s=fault_interval_s,
                engine_factory=engine_factory,
                probe_timeout_s=fault_probe_timeout_s,
            )
            self.fault_domain.start()

    def _make_dispatcher(self, engine, name: str) -> BatchDispatcher:
        """One dispatcher with THE serving parameters: construction and
        warm restart (fault_domain._try_restart) must agree."""
        return BatchDispatcher(
            engine,
            self._batch_window_us,
            self._batch_limit,
            name=name,
            pipeline_depth=self._pipeline_depth,
            unhealthy_after=self._unhealthy_after,
            stamp_clock=self._stamp_clock,
        )

    def _swap_bank(self, bank: int, new_engine, new_dispatcher) -> None:
        """Install a warm-restarted engine and dispatcher at `bank`
        (called by the fault-domain supervisor with the bank's fallback
        lock held).  Bank indices are stable; the batch-shape
        histograms and the health binding carry over to the new
        dispatcher.  The new dispatcher is routable before the bank
        list names its engine; a lock-free resolve that still read the
        old engine finds its dead dispatcher or none, and either fails
        into a re-route (_route: the fault is stale and quarantines
        nothing)."""
        old = self._bank_engines[bank]
        old_d = self._dispatchers.get(id(old))
        if old_d is not None:
            new_dispatcher.batch_lanes_hist = old_d.batch_lanes_hist
            new_dispatcher.batch_items_hist = old_d.batch_items_hist
        if self._health is not None:
            new_dispatcher.on_state = self._dispatcher_health(new_dispatcher)
        if self.launches is not None:
            new_dispatcher.launches = self.launches
            new_dispatcher.launch_bank = bank
            new_dispatcher.launch_algo = self._bank_algo_id(bank)
        self._inline_locks[id(new_engine)] = threading.Lock()
        self._dispatchers[id(new_engine)] = new_dispatcher
        self._bank_engines[bank] = new_engine
        n_lanes = len(self.lanes)
        if bank < n_lanes:
            self.lanes[bank] = new_engine
            if bank == 0:
                self.engine = new_engine
        elif self.per_second_engine is not None and bank == n_lanes:
            self.per_second_engine = new_engine
        else:
            self.algorithm_banks[self._algo_order[bank - self._n_base]] = new_engine
        self._retired.append((old, old_d))
        self._dispatchers.pop(id(old), None)
        with self._health_lock:
            self._unhealthy.discard(id(old_d))

    def attach_launch_recorder(self, recorder) -> None:
        """Wire the launch flight recorder into every bank dispatcher
        and the fault domain's fallback path (runner.start; _swap_bank
        hands it to restarted dispatchers)."""
        self.launches = recorder
        if self.fault_domain is not None:
            self.fault_domain.launches = recorder
        for bank, eng in enumerate(self.engines()):
            d = self._dispatchers.get(id(eng))
            if d is not None:
                d.launch_bank = bank
                d.launch_algo = self._bank_algo_id(bank)
                d.launches = recorder

    def _bank_algo_id(self, bank: int) -> int:
        """models/registry algo_id serving at `bank` (engines() order):
        the lanes and the per-second bank run fixed-window models; the
        algorithm banks carry their registry id."""
        if bank < self._n_base:
            return 0
        return ALGORITHMS[self._algo_order[bank - self._n_base]].algo_id

    def release_retired(self) -> int:
        """Give back the stream of each engine a restart replaced once it
        is done with: its killed dispatcher's threads have returned and
        its stream holds no more work.  A stream still stalled stays
        held, so no new bank draws it (engine.claim_stream).  The fault
        domain calls this before each restart; returns how many streams
        went back."""
        kept = []
        for engine, d in self._retired:
            if (d is None or d.exited()) and stream_idle(engine):
                engine.give_back_stream()
            else:
                kept.append((engine, d))
        released = len(self._retired) - len(kept)
        self._retired = kept
        return released

    @property
    def dispatcher(self) -> Optional[BatchDispatcher]:
        """Lane 0's dispatcher (None in inline mode)."""
        return self._dispatchers.get(id(self.engine))

    def engines(self) -> list:
        """Every bank, in the reference's order: the lanes in lane
        order, the per-second bank, then the algorithm banks in
        sorted-name order.  Bank indices (checkpoint files, stats,
        the fault domain) follow it and are stable across restarts."""
        out = list(self.lanes)
        if self.per_second_engine is not None:
            out.append(self.per_second_engine)
        out.extend(self.algorithm_banks[n] for n in self._algo_order)
        return out

    def run_exclusive(self, engine, fn) -> None:
        """Run `fn()` with exclusive access to `engine`'s slot table and
        state: on its dispatcher thread when batching is on, under its
        inline lock otherwise."""
        d = self._dispatchers.get(id(engine))
        if d is not None:
            d.run_on_thread(fn)
        else:
            with self._inline_locks[id(engine)]:
                fn()

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

        n_lanes = len(self.lanes)
        # Rows per bank: one list per lane, then the per-second bank.
        rows_by_bank: List[List[int]] = [[] for _ in range(n_lanes + 1)]
        for i, (key, rule) in enumerate(zip(keys, limits)):
            if key.key == "":
                continue
            if local_cache is not None and local_cache.contains(key.key):
                # Shadow rules skip the counter but never short-
                # circuit to OVER_LIMIT (fixed_cache_impl.go:57-67).
                categories[i] = _CAT_SKIP if rule.shadow_mode else _CAT_LOCAL
                continue
            categories[i] = _CAT_ENGINE
            rows_by_bank[self._lane_of(key)].append(i)

        statuses: List[Optional[DescriptorStatus]] = [None] * n
        items = []
        for bank, (engine, rows) in enumerate(
            zip(self.lanes + [self.per_second_engine], rows_by_bank)
        ):
            if rows:
                items.append(
                    (
                        bank,
                        engine,
                        self._make_item(rows, keys, limits, hits_addend, now, statuses),
                    )
                )
        return items, statuses, categories, hits_addend, now

    def _lane_of(self, key) -> int:
        """The bank of a fixed-window cache key: the per-second bank
        (index len(lanes)) for a SECOND-unit key when there is one, else
        the lane of crc32 of the key's utf-8 stem, so a key keeps its
        lane across windows and agrees with the resolution cache."""
        n_lanes = len(self.lanes)
        if self.per_second_engine is not None and key.per_second:
            return n_lanes
        if n_lanes == 1:
            return 0
        b = key.key.encode("utf-8")
        return crc32(b[: key.stem_blen] if key.stem_blen else b) % n_lanes

    def _prepare_resolved(self, request: RateLimitRequest, config):
        """The one-dict-hit front half (limiter/resolution.py): rule
        lookup, key, TotalHits, local-cache check, bank routing and
        per-bank pack assembly fused into a single pass over the
        descriptors.  Returns (items, statuses, categories, limits,
        is_unlimited, hits_addend, now, hot, shadow_info); items are
        (bank, engine, WorkItem) triples, ``hot`` the per-row hot-key
        entries (None when the sketch is off)."""
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
        n_lanes = len(self.lanes)
        # Per-bank accumulators (row indices, key bytes, record bytes):
        # the lanes, then the per-second bank.  One lane and no
        # per-second bank route through bound appends with no bank
        # indirection.
        banks = [([], [], []) for _ in range(n_lanes)]
        ps_bank = ([], [], []) if self.per_second_engine is not None else None
        single_bank = n_lanes == 1 and ps_bank is None
        rows, enc, tparts = banks[0]
        local_cache = self.local_cache
        promotion = self.promotion
        # Promotion miss fast path: membership on the raw entries dict
        # (one dict probe per descriptor); only hits call contains()
        # (expiry check and counting).
        promo_entries = promotion.entries if promotion is not None else None
        entries_map = resolver._entries
        generation = config.generation
        resolver_lanes = resolver.n_lanes
        resolution_hits = 0
        overrides: Optional[list] = None
        # Algorithm-bank routing state, allocated lazily: an
        # all-fixed-window request pays one int-truthiness branch per
        # descriptor and nothing else.
        algo_accs: Optional[dict] = None  # name -> (rows, enc, tpl)
        shadow_accs: Optional[dict] = None  # name -> (rows, enc, tpl)
        shadow_rows: Optional[list] = None  # (i, name, algo_id)
        raw_over: Optional[list] = None  # enforced pre-shadow over-ness
        cand_over: Optional[list] = None  # candidate over-ness
        cand_code: Optional[list] = None  # candidate would-be code
        # Hot-key feed: one counter bump per limited descriptor on the
        # handle pinned to its ResolvedDescriptor; track() (locked) runs
        # only on first sight of a stem or after an eviction.  Overrides
        # bypass the resolver and are not tracked.
        hk = self.hotkeys
        hot: Optional[list] = [None] * n if hk is not None else None
        hk_observed = 0
        # Flight-recorder note: the FIRST limited descriptor is the
        # request's identity in the ring (stem hash + bank).
        fl = self.flight
        fl_pending = fl is not None
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
                if rd.n_lanes != resolver_lanes:
                    rd.rehash_lanes(resolver_lanes)
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
            if fl_pending:
                fl_pending = False
                if rd.algo_id and not rd.algo_shadow:
                    note_bank = self._algo_bank[rd.algorithm]
                elif ps_bank is not None and rd.per_second:
                    note_bank = n_lanes
                else:
                    note_bank = rd.lane
                fl.note(rd.stem_hash, note_bank)
            if hk is not None:
                e = rd.hot
                if e is None or e.key is None:
                    e = hk.track(rd.stem)
                    rd.hot = e
                e.hits += hits_addend
                hk_observed += hits_addend
                hot[i] = e
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
            if (
                promo_entries is not None
                and rd.stem in promo_entries
                and promotion.contains(rd.stem)
            ):
                # Hot-key promotion (overload/controller.py): the sketch
                # marked this stem a repeat offender; serve the short-TTL
                # host decision and skip the card.  Shadow rules stay
                # non-enforcing, as with the host over-limit cache below.
                categories[i] = _CAT_SKIP if rule.shadow_mode else _CAT_LOCAL
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
                    cand_code = [None] * n
                sa = shadow_accs.get(rd.algorithm)
                if sa is None:
                    sa = shadow_accs[rd.algorithm] = ([], [], [])
                sa[0].append(i)
                sa[1].append(ws.algo_key_bytes)
                sa[2].append(ws.algo_template_bytes)
                shadow_rows.append((i, rd.algorithm, algo_id))
            if single_bank:
                rows.append(i)
                enc.append(ws.key_bytes)
                tparts.append(ws.template_bytes)
                continue
            bank = ps_bank if ps_bank is not None and rd.per_second else banks[rd.lane]
            bank[0].append(i)
            bank[1].append(ws.key_bytes)
            bank[2].append(ws.template_bytes)
        if prev_rule is not None:
            prev_rule.stats.total_hits.add(prev_hits)
        if resolution_hits:
            resolver.hits += resolution_hits
        if hk_observed:
            hk.observed += hk_observed

        if overrides is not None:
            self._route_overrides(
                overrides, request, config, limits, is_unlimited, keys,
                categories, banks, ps_bank, hits_addend, hits_clamped, now,
            )

        statuses: List[Optional[DescriptorStatus]] = [None] * n
        items = []
        if ps_bank is not None:
            banks.append(ps_bank)
        for bank, (b_rows, b_enc, b_tparts) in enumerate(banks):
            if b_rows:
                items.append(
                    (
                        bank,
                        self._bank_engines[bank],
                        self._make_packed_item(
                            b_rows, keys, limits, hits_addend, now, statuses,
                            b_enc, b_tparts, raw_over,
                        ),
                    )
                )
        if algo_accs is not None:
            # Enforcing banks: statuses and stats assemble exactly like
            # the lane's, from the generic engine's decisions.
            for name, (a_rows, a_enc, a_tparts) in algo_accs.items():
                items.append(
                    (
                        self._algo_bank[name],
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
                        self._algo_bank[name],
                        self.algorithm_banks[name],
                        self._make_candidate_item(
                            s_rows, hits_addend, now, s_enc, s_tparts,
                            cand_over, cand_code,
                        ),
                    )
                )
            shadow_info = (shadow_rows, raw_over, cand_over, cand_code)
        return (
            items, statuses, categories, limits, is_unlimited, hits_addend,
            now, hot, shadow_info,
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
        banks,
        ps_bank,
        hits_addend: int,
        hits_clamped: int,
        now: int,
    ) -> None:
        """Uncached leg for request-supplied override descriptors: the
        get_limit + key-generator pipeline, routed into the same per-bank
        accumulators as the fast path (the same stem hash, so an
        override and its configured twin share a lane)."""
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
            lane = self._lane_of(key)
            bank = ps_bank if lane == len(self.lanes) else banks[lane]
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
            bank[0].append(i)
            bank[1].append(b)
            bank[2].append(scratch.tobytes())

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
            now, hot, shadow_info,
        ) = self._prepare_resolved(request, config)
        statuses = self._execute(
            limits, items, statuses, categories, hits_addend, now,
            len(request.descriptors), deadline=request.deadline,
        )
        if hot is not None:
            self._note_hotkey_outcomes(hot, statuses, hits_addend)
        if shadow_info is not None:
            self._note_shadow_outcomes(*shadow_info)
        return statuses, limits, is_unlimited

    def _note_shadow_outcomes(self, shadow_rows, raw_over, cand_over, cand_code) -> None:
        """Tally shadow-rollout divergence: for every shadowed
        descriptor that reached the engines, compare the candidate
        kernel's would-be over-ness with the enforced fixed-window one
        (both before shadow_mode, so a rule that also suppresses
        OVER_LIMIT still measures real divergence), and deposit the
        first candidate's (code, algo) into the flight-recorder note so
        the ring record carries both codes."""
        counts = self._shadow_counts
        fl = self.flight
        noted = fl is None
        for i, name, algo_id in shadow_rows:
            co = cand_over[i]
            if co is None:
                continue  # candidate never evaluated
            counts[name][0 if co == raw_over[i] else 1] += 1
            if not noted:
                noted = True
                fl.note_shadow(int(cand_code[i]), algo_id)

    def _note_hotkey_outcomes(self, hot, statuses, hits_addend: int) -> None:
        """Fold this request's decisions into its hot-key entries:
        over-limit hits by status code, near-limit hits by the decide
        threshold (after > limit * near_ratio, recovered from
        limit_remaining for OK statuses).  Request-granular, lock-free
        bumps; see observability/hotkeys.py."""
        ratio = self._near_ratio
        over = Code.OVER_LIMIT
        for i, e in enumerate(hot):
            if e is None:
                continue
            st = statuses[i]
            if st.code is over:
                e.over_limit += hits_addend
            else:
                lim = st.current_limit
                if lim is not None:
                    rpu = lim.requests_per_unit
                    if rpu - st.limit_remaining > rpu * ratio:
                        e.near_limit += hits_addend

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
        """The device half: submit every bank's WorkItem, wait -- bounded
        by KERNEL_DEADLINE_S once the bank has completed a launch, by
        the dispatch timeout before (a first launch may build the
        kernels with nvcc), and by the caller's remaining RPC deadline
        (`deadline`, absolute time.monotonic seconds) -- then fill the
        non-engine categories.  `items` are (bank, engine, WorkItem)
        triples; every bank's item is submitted before the first wait,
        so the banks' device steps overlap.

        Quarantined banks never reach the device: their items answer
        from the DEVICE_FAILURE_MODE fallback (_route).  A wait that
        trips the kernel deadline records a hang fault (quarantining the
        bank) and answers the same way; an exception is classified and
        answered likewise.  A wait cut short by the CALLER's deadline
        answers per the failure mode WITHOUT faulting the bank.  With no
        fault domain, device errors raise CacheError, and so does a
        kernel that fails to build, load or launch with a non-sticky
        error with one (fault_domain.kernel_defect).

        When this request's trace is recording, each item's dispatcher
        passage is stamped (submit here; launch and complete on the
        dispatcher threads, complete after the CUDA event wait) and the
        stamps become spans after the waits (_record_item_spans)."""
        fd = self.fault_domain
        span = TRACER.current()
        # One thread-local read per request: the launch recorder joins a
        # slow launch back to the request rings through the submitting
        # thread's sticky correlation id (0 when either ring is off).
        req_corr = (
            self.flight.current_corr()
            if self.launches is not None and self.flight is not None
            else 0
        )
        pending: List[tuple] = []  # (bank, engine, item) awaiting wait
        done: List[WorkItem] = []  # answered items (events recyclable)
        inline: List[tuple] = []
        for bank, engine, item in items:
            if req_corr:
                item.corr = req_corr
            if span is not None:
                item.trace = {
                    "bank": self._bank_labels[bank],
                    "submit": time.perf_counter(),
                }
            if fd is not None:
                self._route(bank, item, pending, done)
                continue
            d = self._dispatchers.get(id(engine))
            if d is None:
                inline.append((bank, engine, item))
                continue
            try:
                d.submit(item)
            except Exception as e:
                raise _engine_failure(e) from e
            pending.append((bank, engine, item))
        for bank, engine, item in inline:
            with self._inline_locks[id(engine)]:
                run_items(engine, [item])
            pending.append((bank, engine, item))
        kd = fd.kernel_deadline_s if fd is not None else None
        # _fault_fallback may append a re-routed clone to `pending`.
        i = 0
        while i < len(pending):
            bank, engine, item = pending[i]
            i += 1
            timeout = self.dispatch_timeout_s
            if kd is not None:
                d = self._dispatchers.get(id(engine))
                if d is not None and d.completed_launches > 0:
                    timeout = min(timeout, kd)
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
                    # The CALLER's deadline expired first: the bank may
                    # be healthy, just slower than this RPC can wait.
                    self._answer_failure_mode(item)
                    continue
                if fd is None:
                    raise _engine_failure(e) from e
                self._fault_fallback(bank, engine, FAULT_HANG, e, item, pending, done)
                continue
            except Exception as e:
                if fd is None:
                    raise _engine_failure(e) from e
                self._fault_fallback(bank, engine, classify_fault(e), e, item, pending, done)
                continue
            done.append(item)
        # Every item in `done` was answered and nothing touches its
        # event again, so the event may be recycled.  An item whose
        # wait failed keeps its event out of the pool: a completer
        # released from a stalled stream may still set it.
        pool = self._event_pool
        if len(pool) < 1024:
            for item in done:
                item.event.clear()
                pool.append(item.event)
        if span is not None:
            self._record_item_spans(span, [it for _, _, it in items])

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

    @staticmethod
    def _record_item_spans(span, items: List[WorkItem]) -> None:
        """Turn each item's (submit, launch, complete) perf_counter
        stamps into two child spans of `span` -- ``backend.dispatch``
        (intake queue, collect, batch assembly and the enqueue, on the
        host) and ``kernel.step`` (enqueue to the CUDA event's
        completion, readback and decide) -- on the waiting RPC thread,
        after the completion event's happens-before edge made the
        dispatcher threads' stamps visible.  An item answered by the
        fault domain's fallback, or a failed step, leaves stamps
        missing: record what exists."""
        for item in items:
            tr = item.trace
            if tr is None:
                continue
            launch = tr.get("launch")
            complete = tr.get("complete")
            attrs = {"bank": tr["bank"], "lanes": item.n_lanes}
            if launch is not None:
                TRACER.record_span(
                    "backend.dispatch", tr["submit"], launch, attrs=attrs, parent=span
                )
                if complete is not None:
                    TRACER.record_span(
                        "kernel.step", launch, complete, attrs=attrs, parent=span
                    )

    @staticmethod
    def _clone_item(item: WorkItem) -> WorkItem:
        """A fallback twin of `item`: same pack and apply closure, a
        FRESH event -- the original's may still be set later by a
        completer held on a stalled stream, and a recycled event that
        fires twice would corrupt a later request."""
        return WorkItem(
            now=item.now, lanes=(), pack=item.get_pack(), apply=item.apply,
            defer_apply=True, corr=item.corr,
        )

    def _route(self, bank: int, item: WorkItem, pending: list, done: list) -> None:
        """Send one bank-bound item where the fault domain routes its
        bank: the fallback while the bank is quarantined (into `done`),
        else the bank's current dispatcher (into `pending`)."""
        fd = self.fault_domain
        if fd.is_quarantined(bank) and fd.run_fallback(bank, item):
            self._note_fallback()
            done.append(item)
            return
        engine = fd.engine_at(bank)  # swap-safe resolve
        try:
            self._dispatchers[id(engine)].submit(item)
        except Exception as e:
            self._fault_fallback(bank, engine, classify_fault(e), e, item, pending, done)
            return
        pending.append((bank, engine, item))

    def _fault_fallback(
        self, bank: int, engine, kind: str, exc, item: WorkItem, pending: list, done: list
    ) -> None:
        """Record a `kind` fault of `engine` on `bank` (quarantining the
        bank; a no-op if it already is, or if a restart has replaced
        that engine) and route a clone of `item` again: to the
        fallback, or to the bank's new engine.  A kernel defect
        (fault_domain.kernel_defect) faults nothing and raises
        CacheError: it would fail every restart as well, and the
        mirror must not hide it."""
        if kernel_defect(exc):
            raise _engine_failure(exc) from exc
        self.fault_domain.record_fault(bank, kind, exc, engine=engine)
        self._route(bank, self._clone_item(item), pending, done)

    def _answer_failure_mode(self, item: WorkItem) -> None:
        """Caller-deadline expiry on a HEALTHY (just slow) bank: answer
        per DEVICE_FAILURE_MODE with zero stat deltas -- deny answers
        OVER_LIMIT, allow (and host, which has no mirror outside
        quarantine) answers OK -- through a clone of `item`."""
        clone = self._clone_item(item)
        run_items(
            STATIC_DENY if self.device_failure_mode == "deny" else STATIC_ALLOW,
            [clone],
        )
        clone.wait(5.0)
        self.stat_deadline_answers += 1
        self._note_fallback()

    def _note_fallback(self) -> None:
        """Mark this thread's in-flight request as answered by the
        failure-mode fallback: its flight-ring record stamps
        FLIGHT_CODE_FALLBACK."""
        fl = self.flight
        if fl is not None:
            fl.note_fallback()

    def bind_health(self, health) -> None:
        """Wire backend liveness into the health checker.  A bank's
        dispatcher death or N consecutive device-step failures flip
        grpc.health.v1 to NOT_SERVING, and SERVING comes back once every
        bank's dispatcher is healthy again: one bank recovering must not
        mask another still failing.  With a fault domain, a quarantined
        bank leaves that count: the service keeps SERVING through the
        fallback and reports DEGRADED while a bank is quarantined
        (HealthChecker.set_degraded).  A kernel defect quarantines no
        bank, so it goes NOT_SERVING as without the domain."""
        self._health = health
        for d in self._dispatchers.values():
            d.on_state = self._dispatcher_health(d)

    def _dispatcher_health(self, d: BatchDispatcher):
        """The on_state seam of dispatcher `d`: note its report, then
        recompute the service's health."""
        import logging

        log = logging.getLogger("ratelimit.health")

        def on_state(healthy: bool, reason: str) -> None:
            if healthy:
                log.info("cuda backend healthy again: %s", reason)
            else:
                log.error("cuda backend unhealthy: %s", reason)
            with self._health_lock:
                if healthy:
                    self._unhealthy.discard(id(d))
                else:
                    self._unhealthy.add(id(d))
            self._refresh_health()

        return on_state

    def _refresh_health(self) -> None:
        """NOT_SERVING while the dispatcher of a bank that is not
        quarantined reports unhealthy, SERVING again once none does
        (flipped back only after this backend flipped it down);
        DEGRADED while the fault domain holds a bank quarantined."""
        health = self._health
        if health is None:
            return
        fd = self.fault_domain
        with self._health_lock:
            down = False
            for bank, engine in enumerate(self._bank_engines):
                if fd is not None and fd.is_quarantined(bank):
                    continue
                d = self._dispatchers.get(id(engine))
                if d is not None and id(d) in self._unhealthy:
                    down = True
            if down != self._reported_down:
                self._reported_down = down
                if down:
                    health.fail()
                else:
                    health.ok()
            if fd is not None:
                n = fd.quarantined_count()
                health.set_degraded(
                    n > 0,
                    f"{n} device bank(s) quarantined, serving via "
                    f"{fd.failure_mode} fallback",
                )

    def queue_hwm_drain(self) -> int:
        """Deepest per-tick intake drain across every bank's
        dispatcher, reset on read: the queue-saturation detector's input
        (observability/detectors.py)."""
        return max(
            (d.queue_hwm_drain() for d in list(self._dispatchers.values())),
            default=0,
        )

    def flush(self) -> None:
        """Drain the dispatcher queues (deterministic test hook; the
        graceful-drain leg of runner.stop).  Dead (quarantined)
        dispatchers are skipped: their queues were already fast-failed
        into the fallback."""
        for d in list(self._dispatchers.values()):
            if d.dead is None:
                d.flush()

    def close(self) -> None:
        """Stop the fault domain's supervisor, then the dispatchers, and
        give every engine's stream back (engine.give_back_stream), those
        that restarts replaced too."""
        fd, self.fault_domain = self.fault_domain, None
        if fd is not None:
            fd.stop()
        dispatchers, self._dispatchers = list(self._dispatchers.values()), {}
        for d in dispatchers:
            # A dead dispatcher may have a thread held on a stalled
            # stream that cannot be joined; don't burn the full timeout.
            d.stop(timeout=0.5 if d.dead is not None else 10.0)
        for engine in self._bank_engines + [e for e, _ in self._retired]:
            engine.give_back_stream()

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
        if self.hotkeys is not None:
            self.hotkeys.register_stats(store, scope + ".hotkeys")
        # The cluster handoff family under its fixed cluster-tier scope.
        self.handoff_log.register_stats(store, "ratelimit.cluster")
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
        if self.fault_domain is not None:
            self.fault_domain.register_stats(store, scope + ".fault")
        for idx, eng in enumerate(self.engines()):
            base = f"{scope}.bank{idx}"
            # Closures resolve the engine BY INDEX per scrape: a warm
            # restart replaces the engine object, and the gauges follow.
            store.gauge_fn(
                base + ".live_keys", lambda i=idx: self._engine_at(i).stat_live_keys
            )
            store.counter_fn(
                base + ".evictions", lambda i=idx: self._engine_at(i).stat_evictions
            )
            store.counter_fn(
                base + ".window_rollovers",
                lambda i=idx: self._engine_at(i).stat_window_rollovers,
            )
            store.gauge_fn(
                base + ".num_slots", lambda i=idx: self._engine_at(i).model.num_slots
            )
            store.gauge_fn(
                base + ".slot_fill_pct",
                lambda i=idx: 100
                * self._engine_at(i).stat_live_keys
                // max(1, self._engine_at(i).model.num_slots),
            )
            d = self._dispatchers.get(id(eng))
            if d is not None:
                for gauge, method in (
                    ("dispatch_queue", "queue_depth"),
                    ("dispatch_queue_hwm", "queue_depth_hwm"),
                    ("inflight_launches", "inflight"),
                    ("inflight_hwm", "inflight_hwm"),
                ):
                    store.gauge_fn(
                        f"{base}.{gauge}",
                        lambda i=idx, m=method: self._disp_stat(i, m),
                    )
                d.batch_lanes_hist = store.histogram(
                    base + ".batch_lanes", self._BATCH_BOUNDS
                )
                d.batch_items_hist = store.histogram(
                    base + ".batch_items", self._BATCH_BOUNDS
                )

    def _engine_at(self, idx: int):
        """Swap-safe engine accessor for scrape closures."""
        return self.engines()[idx]

    def _disp_stat(self, idx: int, method: str) -> int:
        """Swap-safe dispatcher gauge read; 0 while a bank has no live
        dispatcher."""
        d = self._dispatchers.get(id(self.engines()[idx]))
        return 0 if d is None else getattr(d, method)()

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
        self, rows, hits_addend, now, enc, tparts, cand_over: list, cand_code: list
    ) -> WorkItem:
        """Shadow-candidate packer: the same template pack as
        _make_packed_item, but the apply records ONLY the candidate
        kernel's would-be outcome (over-ness before shadow_mode, and its
        code) -- no
        statuses, no rule stats, no local cache, so a shadowed rule's
        responses stay byte-identical to plain fixed-window."""
        pack = self._template_pack(hits_addend, enc, tparts)

        def apply(decisions: HostDecisions) -> None:
            codes = decisions.codes.tolist()
            shadow = decisions.shadow_mode.tolist()
            for j, i in enumerate(rows):
                c = int(codes[j])
                cand_code[i] = c
                cand_over[i] = c == _OVER_VALUE or shadow[j] > 0

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
