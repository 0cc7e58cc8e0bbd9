"""Adaptive overload control: the layer that ACTS on the telemetry.

Port of ratelimit_tpu/overload/controller.py, unchanged: it touches no
tensor.  A promoted or shed request therefore runs no torch op and
launches no kernel; the promotion check sits in
backends/cuda_cache.py's resolved front half, the admission hook in
service/ratelimit.py.

The service's sensing planes — per-phase histograms, the Space-Saving
hot-key sketch, the decision flight recorder, EWMA anomaly detectors,
the per-domain SLO engine — only *report*.  This module closes the loop with three controllers, each
consuming an existing telemetry source and each OBSERVABLE in its own
right (every control action is a counter family on /metrics, a flight-
record code, and a row in ``GET /debug/overload``):

- **SLO-burn-driven load shedding** (:meth:`OverloadController.admit`):
  when the error-budget burn rate of the traffic we are protecting
  crosses ``SHED_BURN_THRESHOLD``, the controller raises a priority
  *shed floor* one level per tick — domains whose configured
  ``priority:`` sits below the floor get an immediate OVER_LIMIT
  response with no backend work.  Unconfigured domains (and domains
  with ``priority: 0``) form the ``_other`` class and shed first; the
  highest configured priority level is never shed.  The burn signal is
  the PER-TICK budget burn (errors-or-slow fraction over the tick,
  divided by ``1 - SLO_TARGET``), EWMA-smoothed — the SLO engine's
  long reporting window would react minutes after the queue melted.
  Un-shedding is hysteretic: the floor steps back down only once the
  protected burn falls below ``threshold * clear_ratio``.

- **Hot-key promotion** (:class:`PromotionCache`): descriptor stems the
  hot-key sketch (observability/hotkeys.py) shows going over-limit at
  high per-tick share get a short-TTL entry in a host-side decision
  cache checked in ``cuda_cache.do_limit_resolved`` — repeat offenders
  skip the device entirely.  This generalizes the reference's
  freecache OVER_LIMIT cache (src/limiter/base_limiter.go:63-72):
  where the reference caches a key only after the backend said
  OVER_LIMIT, the sketch lets us promote on observed *share* with a
  TTL bounded by ``PROMOTE_TTL_S`` instead of the full window.

- **Detector-triggered backpressure**: queue-saturation and
  latency-spike trips (observability/detectors.py, wired through
  :meth:`on_detector_trip`) engage an admission gate — a semaphore of
  ``BACKPRESSURE_TOKENS`` permits in front of the backend.  Admission
  degrades gracefully: a request first waits a BOUNDED
  ``BACKPRESSURE_MAX_WAIT_S`` for a token and only then sheds, so the
  dispatcher queue stops growing without flat-refusing short bursts.
  Repeat trips while engaged RATCHET the gate (tokens halve per level,
  floor 1); the gate disengages ``BACKPRESSURE_HOLD_S`` after the last
  trip.

All three are OFF by default (Settings ``OVERLOAD_*``); with every
knob at its default the runner builds no controller and the serving
path is byte-identical to a build without this module (the parity
contract ``profile_host_path.py --overload`` measures).

Thread model: ``admit()``/``release`` run on RPC handler threads and
read plain attributes (one dict probe + compares — no locks on the hot
path).  ``tick()``, ``on_detector_trip()`` and ``set_priorities()``
mutate state under ``_lock`` (they run on the anomaly sampler thread /
reload path at human cadence).  The stat tallies are plain ints whose
rare lost increments under the GIL are the same accepted stats-only
race as the resolution-cache counters.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..observability.detectors import Ewma
from ..observability.flight import FLIGHT_CODE_SHED  # noqa: F401  (re-export)
from ..utils.time import MonotonicClock, REAL_MONOTONIC

#: Shed reasons — the bounded second half of the per-domain counter
#: family ``ratelimit.overload.shed.<domain>.<reason>``.
REASON_SLO_BURN = "slo_burn"
REASON_BACKPRESSURE = "backpressure"

#: Detectors whose trips engage backpressure (the queue-growth and
#: latency-collapse signals; OVER_LIMIT surges and error-rate spikes
#: are the service doing its job / a backend problem respectively —
#: neither is relieved by admitting less traffic slowly).
BACKPRESSURE_TRIGGERS = frozenset({"queue_saturation", "latency_spike"})

#: Priority assigned to configured domains that carry no ``priority:``
#: key — above the ``_other`` class (0) so plain configs shed stranger
#: traffic before their own.
DEFAULT_DOMAIN_PRIORITY = 1

#: The priority class of unconfigured-domain traffic (and of domains
#: that explicitly opt into shedding first with ``priority: 0``).
OTHER_PRIORITY = 0


class PromotionCache:
    """Short-TTL host-side OVER_LIMIT decisions for sketch-promoted
    stems (module docstring).  ``contains`` is the hot-path read (one
    dict probe on miss); ``promote``/``sweep`` run on the controller
    tick."""

    def __init__(
        self,
        ttl_s: float = 2.0,
        capacity: int = 1024,
        clock: Optional[MonotonicClock] = None,
    ):
        self.ttl_s = float(ttl_s)
        self.capacity = max(1, int(capacity))
        self.clock = clock or REAL_MONOTONIC
        # stem -> monotonic expiry.  PUBLIC on purpose: the backend's
        # resolved front half probes membership directly (`stem in
        # promo.entries`) so the common miss costs one dict op instead
        # of a method call — only hits route through contains() for
        # expiry handling and counting (backends/cuda_cache.py).
        self.entries: Dict[str, float] = {}
        self._lock = threading.Lock()
        # Stats-only tallies (register_stats on the owning controller):
        # promotions/expirations/evictions mutate under _lock; hits is
        # bumped lock-free on RPC threads (accepted stats-only race).
        self.promotions = 0
        self.hits = 0
        self.expirations = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.entries)

    # -- hot path ---------------------------------------------------------

    def contains(self, stem: str) -> bool:
        """True when ``stem`` holds a live promotion.  The common miss
        is one GIL-atomic dict probe; hits read the clock once and
        count themselves."""
        exp = self.entries.get(stem)
        if exp is None:
            return False
        now = self.clock.now()
        if exp <= now:
            # Lazy expiry under the lock (double-checked: a concurrent
            # re-promotion must not be deleted by a stale reader).
            with self._lock:
                cur = self.entries.get(stem)
                if cur is not None and cur <= now:
                    del self.entries[stem]
                    self.expirations += 1
            return False
        self.hits += 1  # tpu-lint: disable=shared-state -- stats-only tally; lost increments accepted (resolution-cache precedent)
        return True

    # -- tick path --------------------------------------------------------

    def promote(self, stem: str) -> None:
        """(Re)arm ``stem`` for ``ttl_s`` from now.  At capacity the
        entry closest to expiry is evicted — promotions are refreshed
        every tick while a stem stays hot, so near-expiry entries are
        the coldest."""
        now = self.clock.now()
        with self._lock:
            entries = self.entries
            if stem not in entries and len(entries) >= self.capacity:
                victim = min(entries, key=entries.get)
                del entries[victim]
                self.evictions += 1
            entries[stem] = now + self.ttl_s
            self.promotions += 1

    def sweep(self) -> None:
        """Drop expired entries (tick housekeeping, so /debug/overload
        and the live gauge reflect reality between hot-path touches)."""
        now = self.clock.now()
        with self._lock:
            dead = [k for k, exp in self.entries.items() if exp <= now]
            for k in dead:
                del self.entries[k]
            self.expirations += len(dead)

    def live(self) -> List[dict]:
        """The promotion set for ``GET /debug/overload``."""
        now = self.clock.now()
        with self._lock:
            items = sorted(self.entries.items(), key=lambda kv: -kv[1])
        return [
            {"key": k, "expires_in_s": round(exp - now, 3)}
            for k, exp in items
            if exp > now
        ]


class OverloadController:
    """Owner of the three control loops (module docstring)."""

    def __init__(
        self,
        slo=None,
        hotkeys=None,
        clock: Optional[MonotonicClock] = None,
        # -- shedding --
        shed_enabled: bool = False,
        shed_burn_threshold: float = 14.4,
        shed_clear_ratio: float = 0.5,
        shed_min_requests: int = 20,
        shed_ewma_alpha: float = 0.5,
        # -- promotion --
        promote_enabled: bool = False,
        promote_ttl_s: float = 2.0,
        promote_over_share: float = 0.5,
        promote_min_hits: int = 64,
        promote_capacity: int = 1024,
        # -- backpressure --
        backpressure_enabled: bool = False,
        backpressure_tokens: int = 64,
        backpressure_max_wait_s: float = 0.05,
        backpressure_hold_s: float = 30.0,
        backpressure_max_level: int = 6,
    ):
        self.slo = slo
        self.hotkeys = hotkeys
        self.clock = clock or REAL_MONOTONIC
        self.shed_enabled = bool(shed_enabled)
        self.shed_burn_threshold = float(shed_burn_threshold)
        self.shed_clear_ratio = float(shed_clear_ratio)
        self.shed_min_requests = int(shed_min_requests)
        self._shed_alpha = float(shed_ewma_alpha)
        self.promote_enabled = bool(promote_enabled)
        self.promote_over_share = float(promote_over_share)
        self.promote_min_hits = int(promote_min_hits)
        self.promotion: Optional[PromotionCache] = (
            PromotionCache(promote_ttl_s, promote_capacity, self.clock)
            if promote_enabled
            else None
        )
        self.backpressure_enabled = bool(backpressure_enabled)
        self._bp_tokens = max(1, int(backpressure_tokens))
        self._bp_max_wait = max(0.0, float(backpressure_max_wait_s))
        self._bp_hold = float(backpressure_hold_s)
        self._bp_max_level = max(1, int(backpressure_max_level))

        # Structural state below mutates ONLY under _lock (tick /
        # on_detector_trip / set_priorities); the hot path reads the
        # underscored attributes lock-free — each is rebound as a
        # whole object (dict / int / Semaphore-or-None), so readers
        # see a complete old or new value, never a mix.
        self._lock = threading.Lock()
        self._priorities: Dict[str, int] = {}
        self._levels: List[int] = [OTHER_PRIORITY]
        self._floor = 0  # index into _levels; 0 = shed nothing
        # Priority value below which traffic sheds; -1 disables the
        # hot-path compare entirely (every real priority is >= 0).
        self._shed_below = -1
        self._burn_last: Dict[str, Tuple[int, int, int]] = {}
        self._burn_ewma: Dict[str, Ewma] = {}
        self._last_burns: Dict[str, float] = {}
        self._promo_last: Dict[str, Tuple[int, int]] = {}
        self._bp_gate: Optional[threading.Semaphore] = None
        self._bp_gate_tokens = 0
        self._bp_level = 0
        self._bp_until = 0.0

        # Stats tallies (plain ints; register_stats exports them via
        # the counter_fn seam so statsd delta-tracks them like the SLO
        # rollups).  Per-(domain, reason) counts intern lazily into
        # _shed_counts, bounded by the configured domain set + _other.
        self.ticks = 0
        self.shed_total = 0
        self.shed_transitions = 0
        self.bp_trips = 0
        self._shed_counts: Dict[str, Dict[str, int]] = {}
        self._store = None
        # Lifecycle event journal (observability/events.py), wired by
        # the runner: shed-floor moves and backpressure engage/ratchet/
        # release transitions land on the fleet timeline.  Transition
        # paths only — admit() never emits.
        self.events = None

    # -- hot path ---------------------------------------------------------

    def admit(self, domain: str) -> Tuple[Optional[str], Optional[threading.Semaphore]]:
        """Admission control for one request (RPC handler thread).

        Returns ``(shed_reason, gate)``: a non-None reason means the
        request must be answered with a shed OVER_LIMIT response and
        no backend work; a non-None gate means the request was
        admitted through the backpressure gate and the caller MUST
        ``gate.release()`` when the backend work finishes (the gate
        object itself is returned so a ratchet rebuild mid-request
        can never release the wrong semaphore)."""
        shed_below = self._shed_below
        if shed_below >= 0 and self._priorities.get(domain, OTHER_PRIORITY) < shed_below:
            self._count_shed(domain, REASON_SLO_BURN)
            return REASON_SLO_BURN, None
        gate = self._bp_gate
        if gate is not None:
            if gate.acquire(timeout=self._bp_max_wait):
                return None, gate
            self._count_shed(domain, REASON_BACKPRESSURE)
            return REASON_BACKPRESSURE, None
        return None, None

    def _count_shed(self, domain: str, reason: str) -> None:
        counts = self._shed_counts.get(
            domain if domain in self._priorities else "_other"
        )
        if counts is None:
            counts = self._intern_counts(
                domain if domain in self._priorities else "_other"
            )
        counts[reason] += 1  # tpu-lint: disable=shared-state -- stats-only tally; lost increments accepted (resolution-cache precedent)
        self.shed_total += 1  # tpu-lint: disable=shared-state -- stats-only tally; lost increments accepted (resolution-cache precedent)

    def _intern_counts(self, domain: str) -> Dict[str, int]:
        """Cold path: mint the per-(domain, reason) tallies — and
        their /metrics families — once per domain.  Bounded by the
        CONFIGURED domain set (+ ``_other``): unconfigured traffic is
        folded before this is reached, so cardinality is a config
        review, not a traffic property."""
        with self._lock:
            counts = self._shed_counts.get(domain)
            if counts is not None:
                return counts
            counts = {REASON_SLO_BURN: 0, REASON_BACKPRESSURE: 0}
            self._shed_counts[domain] = counts
            store = self._store
            if store is not None:
                base = "ratelimit.overload.shed." + domain
                store.counter_fn(
                    base + "." + REASON_SLO_BURN,
                    lambda c=counts: c[REASON_SLO_BURN],
                )
                store.counter_fn(
                    base + "." + REASON_BACKPRESSURE,
                    lambda c=counts: c[REASON_BACKPRESSURE],
                )
            return counts

    # -- config seam ------------------------------------------------------

    def set_priorities(self, priorities: Dict[str, int]) -> None:
        """Adopt the configured domain -> priority map (service config
        reload; config/loader.py validates the values).  The level
        ladder always contains the ``_other`` class (0); a floor index
        surviving a reload is clamped into the new ladder."""
        with self._lock:
            pr = dict(priorities)
            self._priorities = pr
            levels = sorted(set(pr.values()) | {OTHER_PRIORITY})
            self._levels = levels
            if self._floor >= len(levels):
                self._floor = len(levels) - 1
            self._recompute_shed_locked()
            # Pre-intern the counter families so a domain's first shed
            # is a counter bump, not a /metrics name mint.
            for d in list(pr) + ["_other"]:
                if d not in self._shed_counts:
                    self._shed_counts[d] = {
                        REASON_SLO_BURN: 0,
                        REASON_BACKPRESSURE: 0,
                    }
                    store = self._store
                    if store is not None:
                        counts = self._shed_counts[d]
                        base = "ratelimit.overload.shed." + d
                        store.counter_fn(
                            base + "." + REASON_SLO_BURN,
                            lambda c=counts: c[REASON_SLO_BURN],
                        )
                        store.counter_fn(
                            base + "." + REASON_BACKPRESSURE,
                            lambda c=counts: c[REASON_BACKPRESSURE],
                        )

    def _recompute_shed_locked(self) -> None:
        self._shed_below = (
            self._levels[self._floor] if self._floor > 0 else -1
        )

    # -- detector seam ----------------------------------------------------

    def on_detector_trip(self, name: str, reason: str) -> None:
        """Called by the anomaly sampler for EVERY tripped detector
        evaluation (before incident cooldown gating — backpressure
        must keep extending while the condition persists even when no
        new incident is captured)."""
        if not self.backpressure_enabled or name not in BACKPRESSURE_TRIGGERS:
            return
        with self._lock:
            now = self.clock.now()
            self.bp_trips += 1
            self._bp_until = now + self._bp_hold
            engaged = self._bp_gate is None
            if engaged:
                self._bp_level = 1
            else:
                self._bp_level = min(self._bp_level + 1, self._bp_max_level)
            tokens = max(1, self._bp_tokens >> (self._bp_level - 1))
            changed = tokens != self._bp_gate_tokens or self._bp_gate is None
            if changed:
                # Rebuild at the new width; in-flight admissions hold
                # a reference to the OLD gate and release into it (see
                # admit's return contract), so no permit is lost.
                self._bp_gate_tokens = tokens
                self._bp_gate = threading.Semaphore(tokens)
            if self.events is not None and (engaged or changed):
                # Engage and every ratchet that actually narrowed the
                # gate are timeline entries; a trip that merely extends
                # the hold is counter noise, not a transition.
                self.events.emit(
                    "backpressure",
                    action="engage" if engaged else "ratchet",
                    level=self._bp_level,
                    tokens=tokens,
                    detector=name,
                    reason=reason,
                )

    # -- control tick -----------------------------------------------------

    def tick(self) -> None:
        """One control evaluation (anomaly sampler cadence, or driven
        directly by tests/benchmarks on a FakeMonotonicClock)."""
        with self._lock:
            self.ticks += 1
            now = self.clock.now()
            if self._bp_gate is not None and now >= self._bp_until:
                self._bp_gate = None
                self._bp_gate_tokens = 0
                self._bp_level = 0
                if self.events is not None:
                    self.events.emit("backpressure", action="release")
            if self.promotion is not None and self.hotkeys is not None:
                self._tick_promotion_locked()
            if self.shed_enabled and self.slo is not None:
                self._tick_shed_locked()

    def _tick_shed_locked(self) -> None:
        budget = 1.0 - self.slo.target
        burns: Dict[str, float] = {}
        for domain, s in self.slo.stats_by_domain().items():
            req, err, slow = s.requests, s.errors, s.slow
            last = self._burn_last.get(domain)
            self._burn_last[domain] = (req, err, slow)
            raw = 0.0
            if last is not None:
                d_req = req - last[0]
                if d_req >= self.shed_min_requests:
                    bad = max(err - last[1], slow - last[2])
                    raw = bad / d_req / budget
            e = self._burn_ewma.get(domain)
            if e is None:
                e = self._burn_ewma[domain] = Ewma(self._shed_alpha)
            burns[domain] = e.update(raw)
        self._last_burns = burns
        # The control signal is the burn of the traffic we are NOT
        # shedding at the current floor — the domains being protected.
        # Shed domains recovering (their requests now answer instantly)
        # must not vote to relax the floor while the protected tier is
        # still burning.
        shed_below = self._levels[self._floor] if self._floor > 0 else None
        protected = 0.0
        pr = self._priorities
        for domain, burn in burns.items():
            if (
                shed_below is not None
                and pr.get(domain, OTHER_PRIORITY) < shed_below
            ):
                continue
            if burn > protected:
                protected = burn
        max_floor = len(self._levels) - 1
        direction = None
        if protected > self.shed_burn_threshold and self._floor < max_floor:
            self._floor += 1  # tpu-lint: disable=lock-discipline -- _locked suffix contract: only called by tick() while holding self._lock
            self.shed_transitions += 1
            direction = "raise"
        elif (
            self._floor > 0
            and protected < self.shed_burn_threshold * self.shed_clear_ratio
        ):
            self._floor -= 1  # tpu-lint: disable=lock-discipline -- _locked suffix contract: only called by tick() while holding self._lock
            self.shed_transitions += 1
            direction = "lower"
        self._recompute_shed_locked()
        if direction is not None and self.events is not None:
            self.events.emit(
                "shed_floor",
                direction=direction,
                floor=self._floor,
                shed_below_priority=self._shed_below,
                protected_burn=round(protected, 4),
            )

    def _tick_promotion_locked(self) -> None:
        """Scan the hot-key sketch for promotion candidates: stems
        whose PER-TICK over-limit share (delta-tracked, so a key that
        was bad an hour ago and is fine now decays out) clears the
        bar.  A promoted stem is re-armed every tick it stays hot, so
        the short TTL bounds the decision-staleness window, not the
        promotion's lifetime."""
        promo = self.promotion
        seen = set()
        for e in self.hotkeys.snapshot():
            key = e["key"]
            seen.add(key)
            hits, over = int(e["hits"]), int(e["over_limit"])
            last = self._promo_last.get(key, (0, 0))
            self._promo_last[key] = (hits, over)
            d_hits = hits - last[0]
            if d_hits < self.promote_min_hits:
                continue
            if (over - last[1]) / d_hits >= self.promote_over_share:
                promo.promote(key)
        # Prune delta cursors for stems the sketch evicted (bounded by
        # sketch capacity either way; this keeps the dict tight).
        for k in [k for k in self._promo_last if k not in seen]:
            del self._promo_last[k]
        promo.sweep()

    # -- read surface -----------------------------------------------------

    @property
    def shedding(self) -> bool:
        return self._shed_below >= 0

    @property
    def shed_floor_priority(self) -> int:
        """The priority value below which traffic sheds (-1 = none)."""
        return self._shed_below

    def summary(self) -> dict:
        """The ``GET /debug/overload`` body."""
        with self._lock:
            gate = self._bp_gate
            now = self.clock.now()
            out = {
                "enabled": {
                    "shed": self.shed_enabled,
                    "promotion": self.promotion is not None,
                    "backpressure": self.backpressure_enabled,
                },
                "shed": {
                    "active": self._shed_below >= 0,
                    "floor_priority": self._shed_below,
                    "levels": list(self._levels),
                    "priorities": dict(self._priorities),
                    "burn_threshold": self.shed_burn_threshold,
                    "clear_threshold": (
                        self.shed_burn_threshold * self.shed_clear_ratio
                    ),
                    "burns": {
                        d: round(b, 4) for d, b in self._last_burns.items()
                    },
                    "transitions": self.shed_transitions,
                    "counts": {
                        d: dict(c) for d, c in self._shed_counts.items()
                    },
                },
                "backpressure": {
                    "active": gate is not None,
                    "level": self._bp_level,
                    "tokens": self._bp_gate_tokens,
                    "configured_tokens": self._bp_tokens,
                    "max_wait_s": self._bp_max_wait,
                    "hold_remaining_s": (
                        round(max(0.0, self._bp_until - now), 3)
                        if gate is not None
                        else 0.0
                    ),
                    "trips": self.bp_trips,
                },
            }
        promo = self.promotion
        out["promotion"] = (
            {
                "ttl_s": promo.ttl_s,
                "capacity": promo.capacity,
                "over_share_threshold": self.promote_over_share,
                "min_hits_per_tick": self.promote_min_hits,
                "live": promo.live(),
                "promoted": promo.promotions,
                "hits": promo.hits,
                "expired": promo.expirations,
                "evicted": promo.evictions,
            }
            if promo is not None
            else None
        )
        return out

    def register_stats(self, store, scope: str = "ratelimit.overload") -> None:
        """The bounded overload family.  Per-(domain, reason) shed
        counters intern via set_priorities/_intern_counts; everything
        here is a literal name."""
        self._store = store
        store.counter_fn(scope + ".ticks", lambda: self.ticks)
        store.counter_fn(scope + ".shed_total", lambda: self.shed_total)
        store.counter_fn(
            scope + ".shed_transitions", lambda: self.shed_transitions
        )
        store.gauge_fn(
            scope + ".shed_floor_priority", lambda: self._shed_below
        )
        store.gauge_fn(
            scope + ".shedding", lambda: 1 if self._shed_below >= 0 else 0
        )
        store.counter_fn(
            scope + ".backpressure.trips", lambda: self.bp_trips
        )
        store.gauge_fn(
            scope + ".backpressure.active",
            lambda: 1 if self._bp_gate is not None else 0,
        )
        store.gauge_fn(
            scope + ".backpressure.level", lambda: self._bp_level
        )
        store.gauge_fn(
            scope + ".backpressure.tokens", lambda: self._bp_gate_tokens
        )
        promo = self.promotion
        if promo is not None:
            base = scope + ".promotion"
            store.counter_fn(base + ".promoted", lambda: promo.promotions)
            store.counter_fn(base + ".hits", lambda: promo.hits)
            store.counter_fn(base + ".expired", lambda: promo.expirations)
            store.counter_fn(base + ".evicted", lambda: promo.evictions)
            store.gauge_fn(base + ".live", lambda: len(promo))
