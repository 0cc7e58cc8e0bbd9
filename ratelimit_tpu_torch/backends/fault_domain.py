"""Device-path fault domain: watchdog, bank quarantine with host
fallback, and supervised warm restart.

Port of ratelimit_tpu/backends/fault_domain.py onto CUDA's failure
shapes.  Without it a kernel stalled on the card holds every RPC of its
bank for the dispatch timeout (120 s by default), a bank whose engine
raised stays dead until a process restart, and a restart forgives every
open window.  With it:

- **Watchdog + deadlines.**  A supervisor thread (injectable
  MonotonicClock, deterministic ``tick()`` seam) scans every bank's
  dispatcher: a device call stuck past ``KERNEL_DEADLINE_S`` (the
  dispatcher's liveness stamps; a stalled kernel holds the completer in
  its event wait, and a periodic snapshot's copy queued behind it holds
  the collector, stamped as a device call -- the supervisor's wait for
  that snapshot gives up at the deadline, where the JAX domain waits
  unseen until the stall ends), a dead dispatcher thread, or a failed step classify
  into ``hang`` / ``exception`` / ``device_lost`` faults
  (``ratelimit.tpu.fault.*`` counters).  RPC waits are bounded by the
  same deadline (cuda_cache ``_execute``), so the FIRST request to hit
  a stall reports it.  An engine whose banks lie in several groups
  (parallel.ShardedCounterEngine) is ONE bank here: its completer waits
  for every group's event under the one stamp, so a stall on any group
  quarantines the engine as a stalled single table does.

- **Quarantine + host fallback.**  A faulted bank's dispatcher is
  killed (its queue fast-fails) and its lanes re-route per
  ``DEVICE_FAILURE_MODE``: ``host`` (default) serves them from a numpy
  mirror (backends/host_engine.py) seeded with the bank's last periodic
  snapshot -- the same algorithm, counting continues; ``allow``/``deny``
  answer statically with zero stat deltas.  A fallback answers only
  after a recorded fault.

- **Supervised warm restart.**  After a backoff the supervisor builds a
  fresh engine and dispatcher for the bank -- the engine on its own
  CUDA stream, since a stalled stream cannot be cancelled -- probes it
  with synthetic traffic (half-open), imports the host mirror's
  counters (export_keys/import_keys) and swaps it in.  The restart
  waits for the quarantined engine's stream to drain: a new engine's
  first pinned-memory allocation blocks until a stalled kernel ends,
  and meanwhile holds every other bank's launches, so a restart inside
  a stall quarantined healthy banks that had traffic (measured on the
  H100: chip_smoke.py phase 13b).  A kernel that never ends keeps its
  bank on the mirror: the journal's ``bank_restart_failed`` with stage
  ``stream_busy`` and /debug/faults' ``restart_waits_for_stream`` say
  why.  A stream whose query raises is not waited for.  The old
  dispatcher's completer, released when the stall ends, finishes only
  items whose clones were already answered and touches nothing the new
  engine owns.

CUDA's sticky errors (an illegal address, a device-side assert, a
launch failure, an uncorrectable ECC error) poison the process's
context: every later CUDA call fails, so the restart factory fails, the
bank stays on the mirror (DEGRADED) and the backoff caps at 60 s.
Nothing here resets the device, which would take down every other bank.

A kernel that fails to build, load or launch with an error that leaves
the context usable (a ``KernelError`` with no sticky code) is a defect
of the port, not of the device: no restart repairs it and no mirror may
hide it.  The domain quarantines no bank for it; the cache raises it as
CacheError and the service goes NOT_SERVING, as without the domain.

Health: a quarantined bank that is still served is DEGRADED, not down
(cuda_cache ``_refresh_health``, through ``HealthChecker.set_degraded``).

Observability, as in the reference: the event journal
(observability/events.py) gets ``bank_quarantine``, the first
``bank_fallback`` of an episode, ``bank_half_open``, ``bank_restart``
and ``bank_restart_failed``; the launch flight recorder
(observability/launches.py) gets one ``OUTCOME_FALLBACK`` record per
fallback answer.  Health is published before the journal hears of a
transition: ``bank_quarantine`` comes out after DEGRADED and before any
fallback answer of the episode (the bank's fallback lock holds them
back), ``bank_restart`` after SERVING and before the restart count
moves.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..observability.launches import OUTCOME_FALLBACK
from ..utils.time import REAL_MONOTONIC, MonotonicClock
from .engine import stream_idle
from .host_engine import STATIC_ALLOW, STATIC_DENY, HostEngine

logger = logging.getLogger("ratelimit.faults")

FAULT_HANG = "hang"
FAULT_EXCEPTION = "exception"
FAULT_DEVICE_LOST = "device_lost"
FAULT_KINDS = (FAULT_HANG, FAULT_EXCEPTION, FAULT_DEVICE_LOST)

MODE_ALLOW = "allow"
MODE_DENY = "deny"
MODE_HOST = "host"
FAILURE_MODES = frozenset({MODE_ALLOW, MODE_DENY, MODE_HOST})

#: Substrings (lowercased) of the CUDA errors that poison the context,
#: as torch and the CUDA runtime word them: after one of these every later
#: CUDA call of the process fails.
_DEVICE_LOST_MARKERS = (
    "illegal memory access",
    "illegal address",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "uncorrectable ecc",
    "fallen off the bus",
    "illegal instruction",
    "launch timed out",
    "hardware stack error",
    "invalid program counter",
    "uncorrectable nvlink",
)

#: cudaError_t codes of those sticky errors, as a launch returns them
#: through kernels.check (a sticky error of an earlier kernel is
#: returned by the next launch): ECC uncorrectable, NVLink
#: uncorrectable, illegal address, launch timeout, assert, hardware
#: stack error, illegal instruction, misaligned address, invalid
#: address space, invalid PC, launch failure.
STICKY_CUDA_ERRORS = frozenset(
    {214, 220, 700, 702, 710, 714, 715, 716, 717, 718, 719}
)

#: The restart backoff doubles from DEVICE_RESTART_BACKOFF_S up to this.
MAX_RESTART_BACKOFF_S = 60.0
#: Synthetic requests a restarted bank must answer OK before it serves.
PROBE_COUNT = 3


def _device_lost(exc: BaseException) -> bool:
    if getattr(exc, "code", None) in STICKY_CUDA_ERRORS:
        from ..kernels import KernelError

        if isinstance(exc, KernelError):
            return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _DEVICE_LOST_MARKERS)


def kernel_defect(exc: BaseException) -> bool:
    """True for a kernel that failed to build, load or launch with an
    error that leaves the context usable: a ``KernelError`` (or a
    dispatcher death it caused) whose code is not a sticky one.  Such a
    failure repeats on every launch and on every restart, so the cache
    raises it instead of quarantining the bank."""
    from ..kernels import KernelError

    return any(
        isinstance(e, KernelError) and e.code not in STICKY_CUDA_ERRORS
        for e in (exc, exc.__cause__)
    )


def classify_fault(exc: BaseException) -> str:
    """Map an exception from the device path onto the fault taxonomy:
    hang (timeouts), device_lost (a sticky CUDA error: the context is
    gone for this process), or exception (everything else -- a refused
    launch, a build error, a bug or bad input in a step).  The
    exception's cause is read too (a dead dispatcher chains the error
    that killed it)."""
    if isinstance(exc, TimeoutError):
        return FAULT_HANG
    if _device_lost(exc) or (
        exc.__cause__ is not None and _device_lost(exc.__cause__)
    ):
        return FAULT_DEVICE_LOST
    return FAULT_EXCEPTION


def default_engine_factory(bank: int, old_engine):
    """Rebuild a bank's engine from its predecessor's shape: same
    algorithm model (fresh state), same slot budget and buckets, on the
    old engine's device -- as the reference's factory, a bank-sharded
    engine comes back as one table of the same slot count, on the home
    device (its first group's) where its banks lay in groups.  The new
    engine draws a stream that no live engine holds
    (engine.claim_stream): not the old one's, which may be stalled, and
    not another bank's."""
    from ..models.registry import get_algorithm
    from .engine import CounterEngine

    spec = get_algorithm(getattr(old_engine, "algorithm", "fixed_window"))
    device = old_engine.device
    model = spec.make_model(
        old_engine.model.num_slots, old_engine.model.near_ratio, device=device
    )
    return CounterEngine(model=model, buckets=tuple(old_engine.buckets), device=device)


class BankRecord:
    """Per-bank fault-domain state.  ``state`` transitions
    closed -> quarantined -> half_open -> closed; the hot path reads it
    lock-free (string identity check), all transitions happen under the
    domain lock."""

    __slots__ = (
        "bank",
        "role",
        "state",
        "lock",
        "fallback",
        "snapshot",
        "snapshot_seq",
        "next_snapshot",
        "fault_kind",
        "fault_error",
        "quarantined_at",
        "next_restart",
        "backoff_s",
        "restarts",
        "fallback_decisions",
        "fallback_evented",
        "restart_deferred",
    )

    def __init__(self, bank: int, role: str):
        self.bank = bank
        self.role = role
        self.state = "closed"
        # Serializes the host mirror (fallback decisions, snapshot
        # seeding, the final export before re-admission).
        self.lock = threading.Lock()
        self.fallback: Optional[HostEngine] = None
        self.snapshot: Optional[tuple] = None  # (state dict, entries)
        # Order of the copy behind `snapshot` on the dispatcher thread:
        # a snapshot copied earlier never replaces one copied later.
        self.snapshot_seq = 0
        self.next_snapshot = 0.0
        self.fault_kind: Optional[str] = None
        self.fault_error: Optional[str] = None
        self.quarantined_at: Optional[float] = None
        self.next_restart = 0.0
        self.backoff_s = 0.0
        self.restarts = 0
        self.fallback_decisions = 0
        # Whether this quarantine episode's bank_fallback event is out.
        self.fallback_evented = False
        # Whether this episode's restart waits for a busy stream.
        self.restart_deferred = False


class DeviceFaultDomain:
    """The fault domain around one CudaRateLimitCache's device banks."""

    def __init__(
        self,
        cache,
        kernel_deadline_s: float,
        failure_mode: str = MODE_HOST,
        clock: Optional[MonotonicClock] = None,
        restart_backoff_s: float = 2.0,
        snapshot_interval_s: float = 30.0,
        interval_s: Optional[float] = None,
        engine_factory: Optional[Callable] = None,
        probe_timeout_s: Optional[float] = None,
    ):
        if failure_mode not in FAILURE_MODES:
            raise ValueError(
                f"DEVICE_FAILURE_MODE must be one of "
                f"{sorted(FAILURE_MODES)}, got {failure_mode!r}"
            )
        if kernel_deadline_s <= 0:
            raise ValueError("kernel_deadline_s must be positive")
        self.cache = cache
        self.kernel_deadline_s = float(kernel_deadline_s)
        self.failure_mode = failure_mode
        self._clock = clock or REAL_MONOTONIC
        self.restart_backoff_s = float(restart_backoff_s)
        self.snapshot_interval_s = float(snapshot_interval_s)
        # Watchdog cadence: at least twice per deadline so "quarantined
        # within one watchdog deadline" holds even with no traffic.
        self.interval_s = (
            float(interval_s)
            if interval_s is not None
            else min(max(self.kernel_deadline_s / 2.0, 0.05), 1.0)
        )
        self.engine_factory = engine_factory or default_engine_factory
        self.probe_timeout_s = (
            float(probe_timeout_s)
            if probe_timeout_s is not None
            else max(5.0, 20.0 * self.kernel_deadline_s)
        )
        from .checkpoint import bank_roles

        roles = bank_roles(cache)
        #: bank index -> CURRENT engine: the cache's own list, which
        #: cache._swap_bank keeps in sync across restarts, so the hot
        #: path resolves swap-safely without rebuilding cache.engines()
        #: per request.
        self._engines: List = cache._bank_engines
        self._records: List[BankRecord] = [
            BankRecord(i, roles[i]) for i in range(len(self._engines))
        ]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Counters (plain ints bumped under the GIL, scraped as
        # counter_fns).
        self.stat_faults = {k: 0 for k in FAULT_KINDS}
        self.stat_fallback_decisions = 0
        self.stat_restarts = 0
        self.stat_probe_failures = 0
        self.stat_snapshots = 0
        self._snapshot_seq = itertools.count(1)
        # Lifecycle event journal (observability/events.py), wired by
        # the runner when EVENT_JOURNAL_SIZE > 0; transitions only,
        # never per request.
        self.events = None
        # Launch flight recorder (observability/launches.py), wired by
        # cache.attach_launch_recorder: each fallback answer is a
        # one-item host-side "launch" stamped OUTCOME_FALLBACK, so the
        # /debug/launches timeline shows a quarantined bank's traffic.
        self.launches = None

    # -- hot-path surface (cuda_cache._execute) --------------------------

    def is_quarantined(self, bank: int) -> bool:
        return self._records[bank].state != "closed"

    def engine_at(self, bank: int):
        """Swap-safe engine resolve for `bank` (one list index)."""
        return self._engines[bank]

    def run_fallback(self, bank: int, item) -> bool:
        """Answer one bank-bound WorkItem from the failure-mode
        fallback: the host mirror (mode ``host``) or a static allow/deny
        synthesizer, under the bank's fallback lock.  Returns False,
        answering nothing, when the bank has closed meanwhile (a restart
        swapped a fresh engine in while this caller waited for the
        lock): the caller then sends the item to that engine.  The item
        must carry an UNTOUCHED event (the cache clones items whose
        original event may still be set by a stuck completer)."""
        from .dispatcher import run_items

        rec = self._records[bank]
        mode = self.failure_mode
        lr = self.launches
        t0 = time.monotonic_ns() if lr is not None else 0
        with rec.lock:
            # Read under the lock that the restart's swap holds: a
            # closed bank has no mirror left to answer from.
            if rec.state == "closed":
                return False
            if mode == MODE_DENY:
                run_items(STATIC_DENY, [item])
            elif mode == MODE_ALLOW:
                run_items(STATIC_ALLOW, [item])
            else:
                run_items(rec.fallback, [item])
        if lr is not None:
            # One OUTCOME_FALLBACK record per fallback answer: a
            # one-item host-side "launch" with its whole duration in
            # complete_ns (there is no device submit leg).
            try:
                lr.record(
                    bank, 0, item.n_lanes, 1, 0, 0, 0,
                    time.monotonic_ns() - t0, OUTCOME_FALLBACK, item.corr,
                )
            except Exception:
                logger.exception("bank %d: launch record dropped", bank)
        # The event is already set; wait() applies the deferred slices
        # on THIS thread exactly like a healthy dispatcher completion.
        item.wait(5.0)
        rec.fallback_decisions += 1
        self.stat_fallback_decisions += 1  # tpu-lint: disable=shared-state -- GIL-atomic stats counter, scrape-only reader
        if not rec.fallback_evented:
            # First fallback answer of THIS quarantine episode: one
            # timeline entry (per-answer volume stays in the counters).
            # A racing second emitter is benign: two entries, not a
            # wrong timeline.
            rec.fallback_evented = True
            self._emit("bank_fallback", bank=bank, mode=self.failure_mode)
        return True

    def _emit(self, etype: str, **detail) -> None:
        """One journal event, when a journal is wired; a journal that
        raises loses the event, never the transition it reports."""
        if self.events is None:
            return
        try:
            self.events.emit(etype, **detail)
        except Exception:
            logger.exception("event %s dropped", etype)

    # -- fault intake ----------------------------------------------------

    def record_fault(
        self,
        bank: int,
        kind: str,
        exc: Optional[BaseException] = None,
        engine=None,
    ) -> None:
        """Quarantine `bank` (idempotent): count the fault, seed the
        host mirror from the last snapshot, kill the bank's dispatcher
        so queued RPCs fast-fail into the fallback, and schedule the
        supervised restart.  `engine` is the engine the fault was seen
        on; a fault of an engine that a restart has already replaced is
        stale and quarantines nothing."""
        rec = self._records[bank]
        # The bank's fallback lock (taken before the domain lock, as the
        # restart takes them) holds this episode's fallback answers back
        # until DEGRADED and the bank_quarantine event are out.
        with rec.lock:
            if not self._quarantine(bank, rec, kind, exc, engine):
                return
            # Health before the journal and the kill: an RPC that the
            # kill sends to the fallback reads DEGRADED once it has its
            # answer, and the journal reports a state already published.
            self._report_health()
            self._emit(
                "bank_quarantine",
                bank=bank,
                role=rec.role,
                kind=kind,
                error=rec.fault_error,
                failure_mode=self.failure_mode,
            )
        engine = self._engines[bank]
        d = self.cache._dispatchers.get(id(engine))
        if d is not None and d.dead is None:
            d.kill(RuntimeError(f"bank {bank} ({rec.role}) quarantined: {kind} fault"))
        logger.error(
            "device bank %d (%s) quarantined: %s fault (%s); failure "
            "mode %s, restart in %.1fs",
            bank,
            rec.role,
            kind,
            rec.fault_error,
            self.failure_mode,
            rec.backoff_s,
        )

    def _quarantine(self, bank: int, rec: BankRecord, kind: str, exc, engine) -> bool:
        """The state flip of record_fault, under the domain lock:
        False (nothing done) when the bank is not closed or `engine` is
        no longer its engine."""
        with self._lock:
            if rec.state != "closed":
                return False
            if engine is not None and engine is not self._engines[bank]:
                return False
            engine = self._engines[bank]
            self.stat_faults[kind] = self.stat_faults.get(kind, 0) + 1
            now = self._clock.now()
            if self.failure_mode == MODE_HOST:
                host = HostEngine(
                    num_slots=engine.model.num_slots,
                    near_ratio=engine.model.near_ratio,
                    algorithm=getattr(engine, "algorithm", "fixed_window"),
                )
                if rec.snapshot is not None:
                    try:
                        host.import_snapshot(*rec.snapshot)
                    except Exception:
                        logger.exception(
                            "bank %d: seeding host mirror from snapshot "
                            "failed; mirror starts fresh",
                            bank,
                        )
                rec.fallback = host
            rec.fault_kind = kind
            rec.fault_error = repr(exc) if exc is not None else None
            rec.quarantined_at = now
            rec.backoff_s = self.restart_backoff_s
            rec.next_restart = now + rec.backoff_s
            rec.fallback_evented = False  # new episode, new timeline entry
            rec.restart_deferred = False
            rec.state = "quarantined"
        return True

    def quarantined_count(self) -> int:
        return sum(1 for r in self._records if r.state != "closed")

    def mirror_snapshot(self, bank: int):
        """A consistent (state, entries) copy of a quarantined bank's
        host mirror, or None when the failure mode keeps no mirror: the
        checkpoint files' source while the bank is down
        (checkpoint.CheckpointManager.checkpoint).  As checkpoint.
        copy_engine, the mirror lock, which the bank's answers wait on,
        is held only for the copy; the caller decodes it after."""
        rec = self._records[bank]
        with rec.lock:
            if rec.fallback is None:
                return None
            return (
                rec.fallback.export_state(),
                rec.fallback.slot_table.export_entries(),
            )

    def _report_health(self) -> None:
        self.cache._refresh_health()

    # -- watchdog / supervisor ------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """One watchdog+supervisor pass: detect hung or dead
        dispatchers, take due snapshots, attempt due restarts.
        Deterministic seam for tests (drive it with a
        FakeMonotonicClock); the background thread calls it every
        ``interval_s``."""
        if now is None:
            now = self._clock.now()
        for bank, rec in enumerate(self._records):
            if rec.state == "closed":
                self._watch_bank(bank, rec, now)
            elif rec.state == "quarantined" and now >= rec.next_restart:
                self._try_restart(bank, rec, now)

    def _watch_bank(self, bank: int, rec: BankRecord, now: float) -> None:
        engine = self._engines[bank]
        d = self.cache._dispatchers.get(id(engine))
        if d is None:
            return
        if d.dead is not None:
            # A dispatcher killed by a kernel defect stays dead and the
            # service NOT_SERVING (cuda_cache._refresh_health).
            if not kernel_defect(d.dead):
                self.record_fault(bank, classify_fault(d.dead), d.dead)
            return
        if self._hung(bank, d, now):
            return
        if self.snapshot_interval_s > 0 and now >= rec.next_snapshot:
            self._snapshot_bank(bank, rec, d, now)

    def _hung(self, bank: int, d, now: float) -> bool:
        """Record a hang fault when `d` has been in one device call past
        the kernel deadline; returns whether it did."""
        if d.completed_launches > 0 and d.stuck_age(now) > self.kernel_deadline_s:
            self.record_fault(
                bank,
                FAULT_HANG,
                TimeoutError(
                    f"device call stuck {d.stuck_age(now):.3f}s "
                    f"(> kernel deadline {self.kernel_deadline_s:.3f}s)"
                ),
            )
            return True
        return False

    def snapshot_now(self, bank: Optional[int] = None) -> int:
        """Force an immediate snapshot of one bank (or all closed
        banks); returns how many were taken."""
        taken = 0
        now = self._clock.now()
        for i, rec in enumerate(self._records):
            if bank is not None and i != bank:
                continue
            if rec.state != "closed":
                continue
            d = self.cache._dispatchers.get(id(self._engines[i]))
            if d is None:
                continue
            # Count this call's own snapshots: the supervisor thread may
            # snapshot another bank (or this one) meanwhile, and that
            # also bumps stat_snapshots.
            taken += self._snapshot_bank(i, rec, d, now)
        return taken

    def _snapshot_bank(self, bank: int, rec: BankRecord, d, now: float) -> bool:
        """Periodic snapshot: a copy of the state and the slot table on
        the dispatcher thread, the engine's owner, and the keys decoded
        here after it -- the seed of the host mirror, bounding restart
        loss to one interval.  A timeout here is NOT a fault (a deep but
        moving queue can delay the token); the stuck-stamp check catches
        real stalls.  The copy waits on the bank's stream, so it runs as
        a device call: a copy queued behind a stalled kernel makes the
        dispatcher stuck, and this wait gives up at the deadline and
        records the hang instead of holding the watchdog (whose thread
        this is) for the whole stall.  Returns whether this call took a
        snapshot."""
        from .checkpoint import copy_engine

        engine = self._engines[bank]
        grabbed = {}

        def grab():
            grabbed["copy"] = copy_engine(engine)
            grabbed["seq"] = next(self._snapshot_seq)

        def stuck():
            return d.stuck_age(self._clock.now()) > self.kernel_deadline_s

        try:
            d.run_on_thread(
                grab, timeout=max(1.0, 4.0 * self.kernel_deadline_s), device_call=True, abandon=stuck
            )
        except TimeoutError:
            rec.next_snapshot = now + self.snapshot_interval_s
            if self._hung(bank, d, self._clock.now()):
                return False
            logger.warning(
                "bank %d: snapshot token not served in time (queue "
                "backlog?); retrying next interval",
                bank,
            )
            return False
        except Exception as e:
            self.record_fault(bank, classify_fault(e), e)
            return False
        if "copy" not in grabbed:
            return False
        state, copied = grabbed["copy"]
        snap = (state, copied.entries())
        with rec.lock:
            if grabbed["seq"] > rec.snapshot_seq:
                rec.snapshot = snap
                rec.snapshot_seq = grabbed["seq"]
        rec.next_snapshot = now + self.snapshot_interval_s
        self.stat_snapshots += 1  # tpu-lint: disable=shared-state -- GIL-atomic stats counter, single supervisor writer
        return True

    def _try_restart(self, bank: int, rec: BankRecord, now: float) -> None:
        """One supervised warm-restart attempt: fresh engine + probe
        (half-open) -> import the host mirror's counters -> swap.  No
        attempt while the quarantined engine's stream answers that it
        still has work (module docstring): the next tick looks again, and
        the episode's first deferral goes to the journal.  A stream whose
        query raises (a lost context) does not defer: the factory runs
        and reports the fault."""
        engine = self._engines[bank]
        if not stream_idle(engine, lost=True):
            rec.next_restart = now + self.interval_s
            if not rec.restart_deferred:
                rec.restart_deferred = True
                self._emit(
                    "bank_restart_failed",
                    bank=bank,
                    stage="stream_busy",
                    error="the quarantined engine's stream still has work",
                    next_attempt_in_s=round(self.interval_s, 3),
                )
            return
        # Streams of engines that earlier restarts replaced go back once
        # those are done with; a stalled one stays held.
        self.cache.release_retired()
        try:
            new_engine = self.engine_factory(bank, engine)
            # Run the serving shapes OFF the serving path, on the new
            # engine's own stream: the new bank's first served launches
            # then pay no first-use cost against the armed deadline.
            from .cuda_cache import warmup_engine

            warmup_engine(new_engine)
        except Exception as factory_exc:
            logger.exception(
                "bank %d: engine factory failed; staying quarantined", bank
            )
            self._backoff(rec, now)
            self._emit(
                "bank_restart_failed",
                bank=bank,
                stage="factory",
                error=repr(factory_exc),
                next_attempt_in_s=round(rec.backoff_s, 3),
            )
            return
        new_disp = self.cache._make_dispatcher(
            new_engine, name=f"cuda-dispatcher-restart{bank}-{rec.restarts}"
        )
        rec.state = "half_open"
        self._emit("bank_half_open", bank=bank, attempt=rec.restarts + 1)
        ok = False
        try:
            ok = self._probe(bank, rec, new_engine, new_disp)
        except Exception:
            logger.exception("bank %d: restart probe crashed", bank)
        if not ok:
            self._abort_restart(bank, rec, new_disp, now, "probe")
            return
        # Probe passed: merge the mirror's counters and re-admit.  The
        # bank's fallback lock closes the window between export and
        # swap so no fallback decision is lost.  The mirror keeps its
        # keys until the swap: a merge that fails leaves the bank on an
        # intact mirror, and never re-admits it on an engine that has
        # forgotten the open windows.
        with rec.lock:
            if rec.fallback is not None:
                state, entries = rec.fallback.export_keys(lambda _k: True, drop=False)
                wall_now = self.cache.time_source.unix_now()

                def merge():
                    new_engine.import_keys(state, entries, wall_now)

                try:
                    new_disp.run_on_thread(merge, timeout=30.0)
                except Exception:
                    logger.exception("bank %d: importing mirror counters failed", bank)
                    self._abort_restart(bank, rec, new_disp, now, "merge")
                    return
            with self._lock:
                self.cache._swap_bank(bank, new_engine, new_disp)
                rec.fallback = None
                rec.snapshot = None
                rec.next_snapshot = now  # re-seed on the next tick
                rec.fault_kind = None
                rec.fault_error = None
                rec.quarantined_at = None
                rec.backoff_s = 0.0
                rec.state = "closed"
                # Health, then the journal, then the count: whoever sees
                # the restart count move reads the bank's health as
                # re-admitted and finds bank_restart in the journal.
                self._report_health()
                self._emit("bank_restart", bank=bank, restarts=rec.restarts + 1)
                rec.restarts += 1
        self.stat_restarts += 1  # tpu-lint: disable=shared-state -- GIL-atomic stats counter, single supervisor writer
        logger.warning(
            "device bank %d (%s) re-admitted after supervised warm "
            "restart (restart #%d)",
            bank,
            rec.role,
            rec.restarts,
        )

    def _abort_restart(self, bank: int, rec: BankRecord, new_disp, now: float, stage: str):
        """A restart attempt failed its probe or its merge: the bank
        stays quarantined on its mirror and the backoff grows."""
        self.stat_probe_failures += 1  # tpu-lint: disable=shared-state -- GIL-atomic stats counter, single supervisor writer
        rec.state = "quarantined"
        self._backoff(rec, now)
        new_disp.kill(RuntimeError(f"restart {stage} failed"))
        logger.error(
            "bank %d: restart %s failed; next attempt in %.1fs",
            bank,
            stage,
            rec.backoff_s,
        )
        self._emit(
            "bank_restart_failed",
            bank=bank,
            stage=stage,
            next_attempt_in_s=round(rec.backoff_s, 3),
        )

    def _backoff(self, rec: BankRecord, now: float) -> None:
        rec.backoff_s = min(
            max(rec.backoff_s * 2.0, self.restart_backoff_s),
            MAX_RESTART_BACKOFF_S,
        )
        rec.next_restart = now + rec.backoff_s

    def _probe(self, bank: int, rec: BankRecord, engine, disp) -> bool:
        """Half-open probe: synthetic traffic through the NEW dispatcher
        must complete within the probe timeout and answer OK.  Probe
        keys live in a reserved namespace with a huge limit so they can
        never collide with (or deny) real traffic."""
        from ..models.registry import get_algorithm
        from .dispatcher import LANE_DTYPE, LanePack, WorkItem

        spec = get_algorithm(getattr(engine, "algorithm", "fixed_window"))
        generic = spec.name != "fixed_window"
        wall_now = self.cache.time_source.unix_now()
        for i in range(PROBE_COUNT):
            key = f"__fault_probe__/{bank}/{rec.restarts}/{i}"
            kb = key.encode("utf-8")
            meta = np.zeros(1, dtype=LANE_DTYPE)
            meta[0] = (
                wall_now + 120,  # expiry
                1,  # hits
                1_000_000,  # limit: the probe must never deny itself
                len(kb),
                0,  # shadow
                60 if generic else 0,  # divider
                spec.algo_id,
            )
            got = {}

            def apply(decisions, got=got):
                got["codes"] = np.asarray(decisions.codes).tolist()

            item = WorkItem(
                now=wall_now,
                lanes=(),
                pack=LanePack(key_blob=kb, meta=meta),
                apply=apply,
                defer_apply=True,
            )
            try:
                disp.submit(item)
                item.wait(self.probe_timeout_s)
            except Exception as e:
                logger.warning("bank %d: probe %d failed: %r", bank, i, e)
                return False
            if got.get("codes") != [1]:  # api.Code.OK
                logger.warning(
                    "bank %d: probe %d answered %s, not OK",
                    bank,
                    i,
                    got.get("codes"),
                )
                return False
        return True

    # -- lifecycle / observability --------------------------------------

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._loop, name="device-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("device-supervisor tick failed")

    def register_stats(self, store, scope: str = "ratelimit.tpu.fault"):
        """The bounded fault family: per-kind fault counters, fallback
        decisions, restarts / probe failures / snapshots, and the
        quarantined-bank gauge."""
        for kind in FAULT_KINDS:
            store.counter_fn(scope + "." + kind, lambda k=kind: self.stat_faults[k])
        store.counter_fn(
            scope + ".fallback_decisions", lambda: self.stat_fallback_decisions
        )
        store.counter_fn(scope + ".restarts", lambda: self.stat_restarts)
        store.counter_fn(scope + ".probe_failures", lambda: self.stat_probe_failures)
        store.counter_fn(scope + ".snapshots", lambda: self.stat_snapshots)
        store.gauge_fn(scope + ".quarantined_banks", lambda: self.quarantined_count())

    def summary(self) -> dict:
        """The fault domain's state as one JSON-ready dict (the
        reference's /debug/faults body)."""
        now = self._clock.now()
        banks = []
        for rec in self._records:
            b = {
                "bank": rec.bank,
                "role": rec.role,
                "state": rec.state,
                "restarts": rec.restarts,
                "fallback_decisions": rec.fallback_decisions,
                "has_snapshot": rec.snapshot is not None,
            }
            if rec.state != "closed":
                b["fault_kind"] = rec.fault_kind
                b["fault_error"] = rec.fault_error
                if rec.quarantined_at is not None:
                    b["quarantined_for_s"] = round(now - rec.quarantined_at, 3)
                b["next_restart_in_s"] = round(max(0.0, rec.next_restart - now), 3)
                if rec.restart_deferred:
                    b["restart_waits_for_stream"] = True
                if rec.fallback is not None:
                    b["mirror_live_keys"] = rec.fallback.stat_live_keys
            banks.append(b)
        return {
            "kernel_deadline_s": self.kernel_deadline_s,
            "failure_mode": self.failure_mode,
            "snapshot_interval_s": self.snapshot_interval_s,
            "faults": dict(self.stat_faults),
            "fallback_decisions": self.stat_fallback_decisions,
            "restarts": self.stat_restarts,
            "probe_failures": self.stat_probe_failures,
            "snapshots": self.stat_snapshots,
            "quarantined_banks": self.quarantined_count(),
            "banks": banks,
        }
