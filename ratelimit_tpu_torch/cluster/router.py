"""Replica router: rendezvous-hash key ownership over service replicas.

Port of ratelimit_tpu/cluster/router.py, unchanged in behaviour: the
same failure-mode vocabulary, circuit breaker, same-owner retries with
jitter, forwarding window and merge, so a proxy of either package
routes every key to the same owner and merges the same bytes.
Ownership goes through this package's ``cluster/hashing.py``, the one
implementation of the rendezvous hash that the replica half (counter
handoff) evaluates too.  Host code only: the router imports the wire
protos and the standard library, never torch.

The reference scales horizontally with STATELESS replicas sharing one
Redis (reference README.md deployment; stateless `service` struct,
src/service/ratelimit.go:32-47) — any replica can serve any key
because the counters live elsewhere.  This framework's counters live
on each replica's card, so the multi-replica design inverts:
each replica OWNS a partition of the keyspace, and a thin router in
front sends every descriptor to its owning replica — the host-level
analog of Redis-cluster key-slot routing (driver_impl.go:108-126) and
of this package's own slot->bank routing inside one host
(parallel/sharded.py ShardedCounterEngine).

Ownership is rendezvous hashing (highest-random-weight): for each
descriptor, every replica id is scored by hash(replica_id | key) and
the max wins.  vs ``hash(key) % n``: adding/removing one replica moves
only ~1/n of the keys (and only those keys' windows reset — the same
amnesia envelope as a Redis node replacement), not a full reshuffle.

Routing granularity is the CACHE-KEY granularity: the reference builds
the counter key from the domain plus every (key, value) entry of the
descriptor (cache_key.go:62-74), so routing on (domain, entries) —
window excluded — pins every window of a given counter to one replica,
which keeps counting exact without any cross-replica traffic.

The router speaks the wire protos and is transport-agnostic: each
replica is a callable ``(RateLimitRequest, timeout_s=None) ->
RateLimitResponse`` (the Transport protocol below; a gRPC stub bound
by cluster/proxy.py, or an in-process fake in tests).  Descriptors
are split by owner, sub-requests fan out concurrently, and the
sub-responses merge back preserving descriptor order, the OR
overall-code rule, and the min-remaining header semantics of the
single service (service/ratelimit.go:165-209).  A caller-supplied
deadline is carried as an ABSOLUTE budget: each sub-call receives
only the time remaining when it actually starts, so pool queueing
can never stretch the total past the caller's deadline.
"""

from __future__ import annotations

import logging
import random
import threading
from concurrent.futures import ThreadPoolExecutor
import time
from typing import Dict, List, Optional, Protocol, Sequence
from zlib import crc32 as _crc32

from ..server import pb  # noqa: F401  (sys.path for generated protos)

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

# The hash identity lives in cluster/hashing.py (stdlib-only) so the
# replica backend can evaluate the same ownership predicate over its
# stored keys during counter handoff; re-exported here for the
# existing import surface.
from .hashing import owner_of, routing_key  # noqa: E402,F401

logger = logging.getLogger("ratelimit.cluster.router")


class DeadlineExceededError(RuntimeError):
    """The caller's deadline expired before (or while) fanning out —
    the proxy maps this to gRPC DEADLINE_EXCEEDED."""


class _ReplicaCallError(RuntimeError):
    """One replica sub-call failed with a REPLICA-health error (not an
    application status like INVALID_ARGUMENT, which propagates)."""

    def __init__(self, index: int, replica_id: str, cause: BaseException):
        super().__init__(f"replica {replica_id} failed: {cause!r}")
        self.index = index
        self.replica_id = replica_id
        self.cause = cause


# gRPC status names that indicate the REPLICA (or the path to it) is
# unreachable — these count toward ejection and trigger failover:
# UNAVAILABLE is a dead/refused connection; DEADLINE_EXCEEDED is a
# hang, but ONLY when the timeout that expired was a generous one (see
# _HANG_MIN_BUDGET_S below) — a tight CALLER deadline expiring against
# a merely-slow replica must not eject it.  Everything else is the
# replica ANSWERING — application statuses (UNKNOWN on an empty
# domain, INVALID_ARGUMENT, PERMISSION_DENIED, even a backend
# CacheError surfaced as UNKNOWN) propagate untouched, matching the
# reference, whose sentinel failover is driven by connection errors
# only (driver_impl.go:108-126), never by command errors.
_FAILURE_STATUS_NAMES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED"})

# A DEADLINE_EXCEEDED counts as a replica HANG (ejectable) only when
# the expired timeout was at least this long.  Below it, the caller's
# own tight budget is indistinguishable from a slow replica, and
# counting it would let short-deadline clients eject healthy replicas
# one by one until the proxy reports NOT_SERVING.
_HANG_MIN_BUDGET_S = 5.0


def _failure_status_name(exc: BaseException) -> Optional[str]:
    """The gRPC status name if `exc` carries one, else None."""
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            return code().name
        except Exception:
            return None
    return None


def _is_replica_failure(
    exc: BaseException,
    effective_timeout_s: float,
    hang_min_budget_s: float = _HANG_MIN_BUDGET_S,
) -> bool:
    """`effective_timeout_s` is the timeout that could actually have
    expired: min(caller budget, transport ceiling).
    `hang_min_budget_s` is the router's derived hang floor (see
    ReplicaRouter.__init__) so a deliberately-low transport ceiling
    still ejects hung replicas."""
    name = _failure_status_name(exc)
    if name is None:
        # A timeout from a non-gRPC transport (socket.timeout on one
        # enforcing the caller budget itself) is the DEADLINE_EXCEEDED
        # analog: hang-floor-gated, so tight caller budgets expiring
        # against slow-but-healthy replicas never eject.
        if isinstance(exc, TimeoutError):
            return effective_timeout_s >= hang_min_budget_s
        # Other CONNECTION-shaped exceptions (refused/reset, DNS,
        # socket errors — all OSError) count unconditionally.  A
        # proxy-side programming error (TypeError, AttributeError)
        # must propagate as the bug it is, not eject healthy replicas
        # one by one into a fake cluster outage.
        return isinstance(exc, OSError)
    if name == "DEADLINE_EXCEEDED":
        return effective_timeout_s >= hang_min_budget_s
    return name in _FAILURE_STATUS_NAMES


def _is_timeout_shaped(exc: BaseException) -> bool:
    """True for any expiry-shaped error, regardless of which timeout
    was binding (gRPC DEADLINE_EXCEEDED or a socket timeout)."""
    return (
        _failure_status_name(exc) == "DEADLINE_EXCEEDED"
        or isinstance(exc, TimeoutError)
    )


class _Circuit:
    """Per-replica circuit breaker (the sentinel-failover analog,
    reference src/redis/driver_impl.go:108-126: a dead node is ejected
    from the pool and traffic re-resolves to the survivors).

    closed  -> serving normally;
    open    -> ejected from the rendezvous set (keys re-own to the
               survivors; their windows restart — the documented
               amnesia envelope, docs/MULTI_REPLICA.md);
    half-open -> after ``readmit_after_s`` the replica re-enters the
               candidate set; the next real sub-call is the probe —
               success closes the circuit, failure re-arms it.
    """

    __slots__ = (
        "failures", "is_open", "retry_at", "probe_until", "opened_at"
    )

    def __init__(self):
        self.failures = 0
        self.is_open = False
        self.retry_at = 0.0
        # While now < probe_until, one request holds the half-open
        # probe claim; concurrent requests route around the replica.
        self.probe_until = 0.0
        # Monotonic stamp of the ejection that opened this circuit
        # (0.0 while closed) — /stats.json renders it as open_since_s
        # so an operator can tell a fresh trip from an hour-old outage.
        self.opened_at = 0.0


# Proto RateLimit.Unit -> seconds (the wire enum, not api.Unit): the
# TTL an OVER_LIMIT verdict stays trustworthy in the degraded-mode
# cache — at most the remainder of the window that produced it, upper-
# bounded by one full window.  Unknown units fall back to a minute.
_UNIT_TTL_S = {1: 1.0, 2: 60.0, 3: 3600.0, 4: 86400.0}


class OverLimitCache:
    """Degraded-mode local over-limit cache (the reference's freecache
    OVER_LIMIT cache, LocalCacheSize + failure semantics, applied at
    the proxy): remembers which routing stems were recently OVER_LIMIT
    on a HEALTHY pass, so when the owner is down the
    ``local-cache`` failure mode can keep denying known-hot keys while
    admitting everything else — strictly between fail-allow (admits
    hot keys too) and fail-deny (denies cold keys too).

    Bounded: past ``capacity`` the soonest-to-expire entry is evicted
    (the same closest-to-expiry policy as overload's PromotionCache).
    All access under one small lock; this path only runs on sub-call
    failure, never on the healthy hot path."""

    def __init__(self, capacity: int = 4096, clock=time.monotonic):
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._map: Dict[str, float] = {}  # routing stem -> expiry
        self.stat_hits = 0
        self.stat_inserts = 0

    def __len__(self) -> int:
        return len(self._map)

    def put(self, stem: str, ttl_s: float) -> None:
        now = self._clock()
        with self._lock:
            if stem not in self._map and len(self._map) >= self.capacity:
                victim = min(self._map, key=self._map.get)
                del self._map[victim]
            self._map[stem] = now + ttl_s
            self.stat_inserts += 1

    def hit(self, stem: str) -> bool:
        now = self._clock()
        with self._lock:
            exp = self._map.get(stem)
            if exp is None:
                return False
            if exp <= now:
                del self._map[stem]
                return False
            self.stat_hits += 1
            return True


class Transport(Protocol):
    """One replica endpoint.  `timeout_s` is the time REMAINING in
    the caller's budget when this call starts (None = no deadline);
    implementations should bound their wait by it."""

    def __call__(
        self,
        request: rls_pb2.RateLimitRequest,
        timeout_s: Optional[float] = None,
    ) -> rls_pb2.RateLimitResponse: ...

    # Transports MAY additionally accept a keyword-only
    # ``metadata=Sequence[Tuple[str, str]]`` (extra gRPC metadata for
    # this call: the proxy's traceparent + correlation id).  The
    # router only passes the keyword when the caller supplied
    # metadata, so minimal test fakes with the two-argument signature
    # above keep working unchanged.


class ReplicaRouter:
    """Fan descriptors out to their owning replicas; merge responses.

    `replicas` maps stable replica ids (addresses) to transports.  The
    id strings are the hash identity: keep them stable across restarts
    (use host:port, not list position).
    """

    # CLUSTER_FAILURE_MODE vocabulary (the reference's
    # FAILURE_MODE_DENY + local over-limit cache semantics):
    # "allow" admits descriptors no live replica could serve, "deny"
    # answers OVER_LIMIT, "local-cache" denies only stems recently
    # seen OVER_LIMIT on a healthy pass (OverLimitCache) and admits
    # the rest.  "open"/"closed" stay accepted as the historical
    # aliases of allow/deny.
    _FAILURE_ALIASES = {"open": "allow", "closed": "deny"}
    FAILURE_MODES = ("allow", "deny", "local-cache")

    def __init__(
        self,
        replica_ids: Sequence[str],
        transports: Sequence[Transport],
        max_workers: int = 8,
        eject_after: int = 3,
        readmit_after_s: float = 5.0,
        failure_policy: str = "open",
        transport_ceiling_s: float = 30.0,
        retry_max: int = 0,
        retry_base_s: float = 0.05,
        retry_cap_s: float = 2.0,
        rng: Optional[random.Random] = None,
        sleep=time.sleep,
        flight=None,
        events=None,
    ):
        """`eject_after`: consecutive replica-health failures before a
        replica's circuit opens and its keys re-own to the survivors
        (0 disables ejection).  `readmit_after_s`: how long an open
        circuit waits before the replica re-enters the candidate set
        as a half-open probe.  `failure_policy`: what a descriptor
        gets when NO replica could answer for it — see FAILURE_MODES.
        `transport_ceiling_s`: the transports' own timeout ceiling
        (proxy --max-subcall-seconds) — used to classify
        DEADLINE_EXCEEDED as hang vs tight-caller-budget.
        `retry_max`: transient sub-call failures are retried against
        the SAME owner up to this many times with exponential backoff
        + jitter (`retry_base_s` doubling per attempt, capped at
        `retry_cap_s`, x[0.5,1.5) jitter) BEFORE the failover pass
        re-owns the descriptors; a retry never sleeps past the
        caller's remaining absolute deadline.  0 keeps the historical
        fail-straight-to-failover behavior.  `rng`/`sleep` are test
        seams.  `flight` (an observability FlightRecorder) stamps
        degraded-mode and forwarded decisions when provided.
        `events` (an observability EventJournal) records ejection and
        readmission transitions on the fleet timeline."""
        if len(replica_ids) != len(transports):
            raise ValueError("replica_ids and transports length mismatch")
        if not replica_ids:
            raise ValueError("need at least one replica")
        if len(set(replica_ids)) != len(replica_ids):
            raise ValueError("replica ids must be unique")
        failure_policy = self._FAILURE_ALIASES.get(
            failure_policy, failure_policy
        )
        if failure_policy not in self.FAILURE_MODES:
            raise ValueError(
                "failure_policy must be one of "
                f"{self.FAILURE_MODES} (or the open/closed aliases): "
                f"{failure_policy!r}"
            )
        self.replica_ids = list(replica_ids)
        self.transports = list(transports)
        self._id_index = {rid: i for i, rid in enumerate(self.replica_ids)}
        self.eject_after = int(eject_after)
        self.readmit_after_s = float(readmit_after_s)
        self.failure_policy = failure_policy
        self.transport_ceiling_s = float(transport_ceiling_s)
        self.retry_max = int(retry_max)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self._rng = rng or random.Random()
        self._sleep = sleep
        self.flight = flight
        self.events = events
        self._fc_degraded = self._fc_forwarded = 0
        if flight is not None:
            from ..observability.flight import (
                FLIGHT_CODE_DEGRADED,
                FLIGHT_CODE_FORWARDED,
            )

            self._fc_degraded = FLIGHT_CODE_DEGRADED
            self._fc_forwarded = FLIGHT_CODE_FORWARDED
        self.over_limit_cache = (
            OverLimitCache() if failure_policy == "local-cache" else None
        )
        # Counter-handoff forwarding window (docs/MULTI_REPLICA.md):
        # while set, this is the PREVIOUS membership's id list — keys
        # whose owner changed keep routing to their OLD owner (when it
        # survives in the new set and its circuit is closed) so
        # admission stays exact until the handoff import lands.
        # Single-slot swap discipline: request threads read the
        # attribute once; begin/end assign whole lists/None.
        self._forward_old_ids: Optional[List[str]] = None
        # Hang classification floor: a DEADLINE_EXCEEDED ejects only
        # when the expired timeout was at least this long.  Derived
        # from the ceiling so a deliberately-low --max-subcall-seconds
        # (< _HANG_MIN_BUDGET_S) still ejects blackholed replicas —
        # at a low ceiling every expiry IS the ceiling expiring, not a
        # tight caller budget racing a merely-slow replica.
        self._hang_floor_s = min(_HANG_MIN_BUDGET_S, self.transport_ceiling_s)
        if self.transport_ceiling_s < _HANG_MIN_BUDGET_S:
            logger.warning(
                "transport ceiling %.2fs is below the %.1fs hang floor; "
                "DEADLINE_EXCEEDED at >=%.2fs now counts toward ejection",
                self.transport_ceiling_s,
                _HANG_MIN_BUDGET_S,
                self._hang_floor_s,
            )
        self._circuits = [_Circuit() for _ in replica_ids]
        self._health_lock = threading.Lock()
        # Failover observability (the redis pool-gauge analog,
        # driver_impl.go:17-29): plain ints, ALWAYS mutated under
        # _health_lock (bare += from concurrent request threads can
        # lose increments); read lock-free by stats()/log lines.
        self.stat_ejections = 0
        self.stat_readmissions = 0
        self.stat_failovers = 0  # sub-requests re-routed to a survivor
        self.stat_fallback_descriptors = 0  # answered by failure policy
        self.stat_retries = 0  # same-owner retries after backoff
        self.stat_forwarded = 0  # descriptors forwarded to old owners
        self.stat_degraded_denials = 0  # local-cache denials while degraded
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="replica-router"
        )

    def stats(self) -> dict:
        """Snapshot of the failover counters + live membership +
        per-replica circuit detail (the /debug/cluster and /stats.json
        surface)."""
        with self._health_lock:
            now = time.monotonic()
            states = [
                {
                    "id": rid,
                    "state": (
                        "open"
                        if c.is_open and now < c.retry_at
                        else ("half-open" if c.is_open else "closed")
                    ),
                    "consecutive_failures": c.failures,
                    # Age of the current outage; null while closed.
                    "open_since_s": (
                        round(now - c.opened_at, 3) if c.is_open else None
                    ),
                }
                for rid, c in zip(self.replica_ids, self._circuits)
            ]
        return {
            "replicas": len(self.replica_ids),
            "live_replicas": self.live_replica_count(),
            "ejections": self.stat_ejections,
            "readmissions": self.stat_readmissions,
            "failovers": self.stat_failovers,
            "fallback_descriptors": self.stat_fallback_descriptors,
            "retries": self.stat_retries,
            "forwarded": self.stat_forwarded,
            "degraded_denials": self.stat_degraded_denials,
            "failure_mode": self.failure_policy,
            "forwarding_active": self._forward_old_ids is not None,
            "replica_states": states,
        }

    # -- counter-handoff forwarding window ------------------------------

    def begin_forwarding(self, old_ids: Sequence[str]) -> None:
        """Route keys whose owner changed vs `old_ids` to their OLD
        owner until end_forwarding() — the dual-write/forwarding
        window of a membership change (cluster/handoff.py runs the
        export/import while this is active, so no counter resets)."""
        self._forward_old_ids = list(old_ids)  # tpu-lint: disable=shared-state -- single-slot swap: writers assign a whole fresh list (GIL-atomic); readers take one snapshot per request

    def end_forwarding(self) -> None:
        self._forward_old_ids = None  # tpu-lint: disable=shared-state -- single-slot swap (see begin_forwarding)

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def owner_for(self, domain: str, descriptor) -> int:
        return owner_of(routing_key(domain, descriptor), self.replica_ids)

    # -- replica health (sentinel-failover analog) -----------------------

    def live_replica_count(self) -> int:
        """Replicas whose circuit is not open (the proxy's health
        surface: all-open -> NOT_SERVING)."""
        with self._health_lock:
            return sum(1 for c in self._circuits if not c.is_open)

    def any_live(self) -> bool:
        return self.live_replica_count() > 0

    # How long one request may hold a half-open probe claim: matches
    # the transport's no-deadline backstop, so a probe hung on a
    # blackholed replica cannot block the next probe forever.
    _PROBE_CLAIM_S = 30.0

    # Zero-descriptor walk bounds: per-attempt probe timeout and the
    # whole-walk budget.  The EFFECTIVE probe timeout is
    # max(_EMPTY_PROBE_TIMEOUT_S, hang floor) — see _probe_timeout_s —
    # so a full-length probe expiry always classifies as a hang in
    # _checked_call; lowering this constant below the floor tightens
    # nothing and must not silently disable empty-walk ejection.
    _EMPTY_PROBE_TIMEOUT_S = 5.0
    _EMPTY_WALK_BUDGET_S = 10.0

    def _probe_timeout_s(self) -> float:
        return max(self._EMPTY_PROBE_TIMEOUT_S, self._hang_floor_s)

    def _candidates_claiming(self) -> tuple:
        """(candidate indices, claimed-probe indices): circuit closed,
        or open with the half-open probe due.  The probe is
        single-flight: the first caller to see it due CLAIMS it
        (probe_until), and while the claim is held concurrent requests
        route the replica's key partition to the survivors instead of
        piling multi-second stalls onto a possibly-still-dead node.  A
        claim is released (a) by the probe call itself succeeding or
        failing, (b) by the claiming request when it turns out to own
        none of the replica's keys, or (c) when the claiming call
        aborts before reaching the replica (caller-deadline expiry) —
        so neither skewed traffic nor tight deadlines can starve
        recovery.  NOTE: claiming MUTATES circuit state; this is not
        an inspection helper."""
        now = time.monotonic()
        out: List[int] = []
        claimed: List[int] = []
        with self._health_lock:
            for i, c in enumerate(self._circuits):
                if not c.is_open:
                    out.append(i)
                elif now >= c.retry_at and now >= c.probe_until:
                    c.probe_until = now + self._PROBE_CLAIM_S
                    out.append(i)
                    claimed.append(i)
        return out, claimed

    def _release_probes(self, idxs) -> None:
        if not idxs:
            return
        with self._health_lock:
            for i in idxs:
                self._circuits[i].probe_until = 0.0

    def _record_failure(self, idx: int, exc: BaseException) -> None:
        with self._health_lock:
            c = self._circuits[idx]
            c.failures += 1
            newly_open = (
                self.eject_after > 0
                and c.failures >= self.eject_after
                and not c.is_open
            )
            if newly_open:
                c.is_open = True
                c.opened_at = time.monotonic()
                self.stat_ejections += 1
            c.probe_until = 0.0  # the probe call itself just finished
            if c.is_open:
                # Each failure (first ejection or a failed half-open
                # probe) re-arms the probation timer.
                c.retry_at = time.monotonic() + self.readmit_after_s
        if newly_open:
            logger.error(
                "replica %s ejected after %d consecutive failures "
                "(last: %r); its keys re-own to the survivors",
                self.replica_ids[idx],
                self._circuits[idx].failures,
                exc,
            )
            if self.events is not None:
                self.events.emit(
                    "replica_eject",
                    replica=self.replica_ids[idx],
                    failures=self._circuits[idx].failures,
                    error=repr(exc),
                )

    def _record_success(self, idx: int) -> None:
        with self._health_lock:
            c = self._circuits[idx]
            was_open = c.is_open
            c.failures = 0
            c.is_open = False
            c.probe_until = 0.0
            c.opened_at = 0.0
            if was_open:
                self.stat_readmissions += 1
        if was_open:
            logger.warning(
                "replica %s recovered; re-admitted to the rendezvous set",
                self.replica_ids[idx],
            )
            if self.events is not None:
                self.events.emit(
                    "replica_readmit", replica=self.replica_ids[idx]
                )

    def _checked_call(self, idx: int, sub_request, remaining, md=None):
        """One transport call with circuit bookkeeping.  Replica-health
        errors raise _ReplicaCallError (drives failover); application
        statuses and caller-deadline expiry propagate unchanged.
        Every exit releases any probe claim on `idx` (success/failure
        release via the recorders; the propagate paths release
        explicitly) so an aborted probe can't block readmission.
        `md` is opaque per-call metadata (traceparent + correlation
        id); it is only passed to transports when non-None — see the
        Transport protocol note."""
        try:
            budget = remaining()
        except DeadlineExceededError:
            self._release_probes([idx])
            raise
        # The timeout that can actually expire is the SMALLER of the
        # caller's budget and the transport ceiling — hang
        # classification must use it, or a low ceiling would let slow
        # responses eject healthy replicas.
        effective = (
            self.transport_ceiling_s
            if budget is None
            else min(budget, self.transport_ceiling_s)
        )
        try:
            t = self.transports[idx]
            resp = (
                t(sub_request, timeout_s=budget)
                if md is None
                else t(sub_request, timeout_s=budget, metadata=md)
            )
        except DeadlineExceededError:
            self._release_probes([idx])
            raise
        except Exception as e:
            # Exception, not BaseException: KeyboardInterrupt /
            # SystemExit must propagate, never masquerade as a dead
            # replica.
            if not _is_replica_failure(e, effective, self._hang_floor_s):
                self._release_probes([idx])
                raise
            self._record_failure(idx, e)
            raise _ReplicaCallError(idx, self.replica_ids[idx], e) from e
        self._record_success(idx)
        return resp

    def _call_retrying(self, idx: int, sub_request, remaining, md=None):
        """_checked_call plus bounded same-owner retries on transient
        replica failures: exponential backoff with jitter, stopping
        early when the replica's circuit opened meanwhile (failover
        handles it) or when the caller's remaining absolute deadline
        cannot cover the backoff — a retry must NEVER stretch the
        total past the caller's budget (the deadline contract of
        should_rate_limit)."""
        attempt = 0
        while True:
            try:
                return self._checked_call(idx, sub_request, remaining, md)
            except _ReplicaCallError:
                if attempt >= self.retry_max:
                    raise
                with self._health_lock:
                    circuit_open = self._circuits[idx].is_open
                if circuit_open:
                    # Ejected mid-retry: hammering it again only burns
                    # the caller's budget; let failover re-own.
                    raise
                backoff = min(
                    self.retry_cap_s, self.retry_base_s * (2.0 ** attempt)
                ) * (0.5 + self._rng.random())
                try:
                    left = remaining()
                except DeadlineExceededError:
                    raise  # budget already gone: surface the expiry
                if left is not None and left <= backoff + self.retry_base_s:
                    # Not enough budget for the sleep plus a useful
                    # attempt: give the remaining time to failover.
                    raise
                self._sleep(backoff)
                with self._health_lock:
                    self.stat_retries += 1
                attempt += 1

    def _sub_request(self, request, rows: List[int]):
        sub = rls_pb2.RateLimitRequest(
            domain=request.domain, hits_addend=request.hits_addend
        )
        for i in rows:
            sub.descriptors.add().CopyFrom(request.descriptors[i])
        return sub

    def _route_and_call(
        self, request, rows, cand: List[int], claimed, remaining, md=None
    ):
        """Group descriptor indices `rows` by rendezvous owner over the
        candidate set, release probe claims this request routes nothing
        to, and fan the sub-calls out (first owner inline on the
        request thread — it would otherwise just block in result() —
        the rest on the pool).  Returns [(rows, resp|None, err|None)].
        Shared by the primary fan-out and the failover retry so the
        claim-release bookkeeping cannot diverge between them."""
        n = len(request.descriptors)
        cand_ids = [self.replica_ids[i] for i in cand]
        cand_set = set(cand)
        forward_ids = self._forward_old_ids  # one read: swap-safe
        by_owner: Dict[int, List[int]] = {}
        forwarded = 0
        for i in rows:
            key = routing_key(request.domain, request.descriptors[i])
            owner = cand[owner_of(key, cand_ids)]
            if forward_ids is not None:
                # Handoff forwarding window: a key whose owner changed
                # keeps hitting its OLD owner (if it survives in the
                # new set with a closed circuit) so its counter keeps
                # counting in one place until the import lands.
                old_id = forward_ids[owner_of(key, forward_ids)]
                if old_id != self.replica_ids[owner]:
                    j = self._id_index.get(old_id)
                    if j is not None and j in cand_set:
                        owner = j
                        forwarded += 1
            by_owner.setdefault(owner, []).append(i)
        if forwarded:
            with self._health_lock:
                self.stat_forwarded += forwarded
            if self.flight is not None:
                self.flight.record(
                    request.domain, self._fc_forwarded, forwarded, 0.0
                )
        # A claimed probe this request routes nothing to would starve
        # recovery if we kept holding it.
        self._release_probes([i for i in claimed if i not in by_owner])

        def sub_call(owner: int, sub_rows: List[int]):
            sub = (
                request
                if len(sub_rows) == n
                else self._sub_request(request, sub_rows)
            )
            try:
                return (
                    sub_rows,
                    self._call_retrying(owner, sub, remaining, md),
                    None,
                )
            except _ReplicaCallError as e:
                return sub_rows, None, e

        owners = list(by_owner.items())
        if self.flight is not None and owners:
            # Proxy-side flight note: the primary route decision for
            # this request — (crc32 of the chosen replica id, owner
            # index) land in the stem/lane fields of the record the
            # proxy handler stamps after the merge.  Deposited on the
            # request thread (owners[0] runs inline below), so the
            # thread-local note pairs with the right record.
            rid = self.replica_ids[owners[0][0]]
            self.flight.note(_crc32(rid.encode("utf-8")), owners[0][0])
        futures = []
        inline_extra = []
        for owner, sub_rows in owners[1:]:
            try:
                futures.append(self._pool.submit(sub_call, owner, sub_rows))
            except RuntimeError:
                # Pool already retired (a request can outlive its
                # router past the membership-swap grace): degrade to
                # sequential sub-calls instead of erroring the RPC.
                inline_extra.append((owner, sub_rows))
        results = [sub_call(*owners[0])]
        results.extend(sub_call(o, r) for o, r in inline_extra)
        results.extend(f.result() for f in futures)
        return results

    def _fallback_code(self, request, i: int) -> int:
        """Degraded-mode answer for ONE descriptor whose owner is
        unreachable, per CLUSTER_FAILURE_MODE: allow -> OK, deny ->
        OVER_LIMIT, local-cache -> OVER_LIMIT only when the stem was
        recently over limit on a healthy pass (the reference's
        freecache over-limit cache under FAILURE_MODE_DENY=false)."""
        OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
        OK = rls_pb2.RateLimitResponse.OK
        if self.failure_policy == "deny":
            return OVER
        if self.failure_policy == "local-cache":
            stem = routing_key(request.domain, request.descriptors[i])
            if self.over_limit_cache.hit(stem):
                with self._health_lock:
                    self.stat_degraded_denials += 1
                return OVER
        return OK

    def _note_degraded(self, request, n: int) -> None:
        with self._health_lock:
            self.stat_fallback_descriptors += n
        if self.flight is not None and n:
            self.flight.record(request.domain, self._fc_degraded, n, 0.0)

    def _fallback_response(self, request) -> rls_pb2.RateLimitResponse:
        """Every-replica-unreachable answer per the failure policy."""
        n = len(request.descriptors)
        self._note_degraded(request, n)
        OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
        OK = rls_pb2.RateLimitResponse.OK
        out = rls_pb2.RateLimitResponse(overall_code=OK)
        for i in range(n):
            code = self._fallback_code(request, i)
            out.statuses.add().code = code
            if code == OVER:
                out.overall_code = OVER
        return out

    def _feed_over_limit_cache(self, request, rows, sub_resp) -> None:
        """Remember healthy OVER_LIMIT verdicts (with a TTL of one
        window of the limit that produced them) for degraded-mode
        denials later.  Only wired when failure_policy=local-cache."""
        OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
        for j, i in enumerate(rows):
            st = sub_resp.statuses[j]
            if st.code != OVER:
                continue
            ttl = _UNIT_TTL_S.get(st.current_limit.unit, 60.0)
            self.over_limit_cache.put(
                routing_key(request.domain, request.descriptors[i]), ttl
            )

    def should_rate_limit(
        self,
        request: rls_pb2.RateLimitRequest,
        timeout_s: Optional[float] = None,
        metadata=None,
    ) -> rls_pb2.RateLimitResponse:
        # Absolute deadline: every sub-call gets the budget REMAINING
        # when it starts (pool queueing eats from the same budget).
        deadline = None if timeout_s is None else time.monotonic() + timeout_s

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                raise DeadlineExceededError(
                    "caller deadline expired before the replica call"
                )
            return left

        n = len(request.descriptors)
        cand, claimed = self._candidates_claiming()
        if not cand:
            # Every circuit open and no probe due: the failure policy
            # answers (the proxy's health is NOT_SERVING here too).
            logger.error(
                "no live replicas (all %d ejected); failure policy %r "
                "answers", len(self.replica_ids), self.failure_policy,
            )
            return self._fallback_response(request)

        if n == 0:
            # A replica answers the empty/error case so the wire
            # behavior (INVALID_ARGUMENT on empty domain etc.) is the
            # service's own, not a router invention; walk the live set
            # on replica failure.  The walk is TIME-bounded, not
            # count-bounded: fast failures (connection refused) still
            # reach a healthy later candidate, but the request carries
            # no counter state, so hung-but-not-yet-ejected replicas
            # get a short per-attempt probe timeout and the whole walk
            # stops at _EMPTY_WALK_BUDGET_S — without this, each hung
            # candidate would burn the full transport ceiling (30s
            # default) and one empty request could pin a worker
            # thread for minutes.
            walk_deadline = time.monotonic() + self._EMPTY_WALK_BUDGET_S
            probe_timeout = self._probe_timeout_s()

            def probe_remaining() -> Optional[float]:
                left = remaining()  # caller-deadline expiry propagates
                # Floored: the loop's walk_deadline check races this
                # by a hair; a zero/negative timeout would surface a
                # spurious DEADLINE_EXCEEDED to a deadline-less caller.
                cap = max(
                    0.05,
                    min(
                        probe_timeout,
                        walk_deadline - time.monotonic(),
                    ),
                )
                return cap if left is None else min(left, cap)

            untouched = set(claimed)
            try:
                for idx in cand:
                    # The cap THIS attempt will get: failure
                    # accounting below depends on whether it was the
                    # full probe timeout or a walk-deadline clamp.
                    cap_now = min(
                        probe_timeout,
                        walk_deadline - time.monotonic(),
                    )
                    if cap_now <= 0:
                        break
                    untouched.discard(idx)
                    try:
                        return self._checked_call(
                            idx, request, probe_remaining, metadata
                        )
                    except _ReplicaCallError:
                        continue
                    except DeadlineExceededError:
                        raise  # the CALLER's budget expired pre-call
                    except Exception as e:
                        # A timeout-shaped error _checked_call did NOT
                        # classify as a hang (it records those itself:
                        # a full-length probe's effective timeout is
                        # min(probe, ceiling) >= the hang floor, so
                        # genuine hangs arrive as _ReplicaCallError
                        # above).  What lands here is ambiguous — a
                        # clamped near-zero probe cap, or a tight
                        # budget racing a merely-slow replica — and
                        # proves nothing about replica health: walk on
                        # without failure accounting.  remaining()
                        # raising means the CALLER's budget was the
                        # binding timeout: that propagates as the
                        # deadline error it is.
                        if not _is_timeout_shaped(e):
                            raise
                        remaining()
                        continue
                return self._fallback_response(request)
            finally:
                self._release_probes(untouched)

        outcome = self._route_and_call(
            request, range(n), cand, claimed, remaining, metadata
        )

        # Failover pass (sentinel analog): descriptors whose owner
        # failed re-own ONCE over the remaining live set (their
        # windows restart on the new owner — the amnesia envelope);
        # if that also fails, the failure policy answers for them.
        failed = [(rows, err) for rows, _resp, err in outcome if err is not None]
        results = [(rows, resp) for rows, resp, err in outcome if err is None]
        fallback_rows: List[int] = []
        if failed:
            failed_rows = [i for rows, _err in failed for i in rows]
            failed_idx = {err.index for _rows, err in failed}
            retry_cand, retry_claimed = self._candidates_claiming()
            retry_set = [i for i in retry_cand if i not in failed_idx]
            # Claims on replicas excluded from the retry set (the
            # just-failed owner) release immediately.
            self._release_probes(
                [i for i in retry_claimed if i not in retry_set]
            )
            retry_claimed = [i for i in retry_claimed if i in retry_set]
            if not retry_set:
                fallback_rows.extend(failed_rows)
            else:
                retries = self._route_and_call(
                    request,
                    failed_rows,
                    retry_set,
                    retry_claimed,
                    remaining,
                    metadata,
                )
                ok_retries = 0
                for rows, resp, err in retries:
                    if err is None:
                        ok_retries += 1
                        results.append((rows, resp))
                    else:
                        fallback_rows.extend(rows)
                if ok_retries:
                    with self._health_lock:
                        self.stat_failovers += ok_retries
            if fallback_rows:
                self._note_degraded(request, len(fallback_rows))

        # Merge: statuses back to request order; overall code is the
        # logical OR (service/ratelimit.go:185-190); headers follow
        # the sub-response holding the globally-min-remaining limited
        # descriptor (each service already computed min over its own
        # subset — the global min is the min over replicas,
        # ratelimit.go:165-201).  An OVER_LIMIT sub-response wins
        # min-remaining ties: the single service forces the over-limit
        # descriptor to be the header minimum (service/ratelimit.py
        # sets min_remaining=0 on OVER_LIMIT before any comparison).
        OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
        out = rls_pb2.RateLimitResponse(
            overall_code=rls_pb2.RateLimitResponse.OK
        )
        statuses = [None] * n
        best_hdr = None  # ((remaining, not_over), sub_response)
        for rows, sub_resp in results:
            if self.over_limit_cache is not None:
                self._feed_over_limit_cache(request, rows, sub_resp)
            if sub_resp.overall_code == OVER:
                out.overall_code = OVER
            for j, i in enumerate(rows):
                statuses[i] = sub_resp.statuses[j]
            if sub_resp.response_headers_to_add:
                sub_min = min(
                    (
                        s.limit_remaining
                        for s in sub_resp.statuses
                        if s.HasField("current_limit")
                    ),
                    default=None,
                )
                if sub_min is not None:
                    rank = (sub_min, sub_resp.overall_code != OVER)
                    if best_hdr is None or rank < best_hdr[0]:
                        best_hdr = (rank, sub_resp)
        if fallback_rows:
            # Policy answer for descriptors no live replica could
            # serve: "allow" admits them (plain OK, no limit attached —
            # the same shape as a no-matching-rule descriptor), "deny"
            # denies and forces the overall code, "local-cache" denies
            # only the stems recently seen over limit.
            for i in fallback_rows:
                code = self._fallback_code(request, i)
                if code == OVER:
                    out.overall_code = OVER
                st = rls_pb2.RateLimitResponse.DescriptorStatus()
                st.code = code
                statuses[i] = st
        for s in statuses:
            out.statuses.add().CopyFrom(s)
        if best_hdr is not None:
            for h in best_hdr[1].response_headers_to_add:
                out.response_headers_to_add.add().CopyFrom(h)
        return out
