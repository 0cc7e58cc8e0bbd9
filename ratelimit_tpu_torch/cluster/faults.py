"""Fault injection for the cluster tier.

Port of ratelimit_tpu/cluster/faults.py, unchanged: the transport
injector for a replica router, and the device-seam injector that
scripts/torch_chaos_smoke.py drives against the port's fault domain.
The engine proxy keeps one identity for the cache's life (dispatchers,
inline locks and the stream claim are all keyed or checked by the
proxy), and a supervised restart builds a plain engine in its place,
as in the JAX package.

The membership-churn claims are proven under injected faults, not
asserted: this module wraps replica transports so a test or a smoke
can kill/hang/delay/partition a replica MID-STREAM and watch the
router eject, degrade, fail over and hand counters off.

Transport-level on purpose: from the proxy's point of view a replica
that SIGKILLed, a blackholed NIC and a partitioned rack are all "the
sub-call raised UNAVAILABLE / hung past the deadline" — injecting at
the transport seam exercises the exact classification path
(`router._is_replica_failure`) production errors take, and works for
in-process replicas that have no process to kill.  The e2e scenario
05 already covers the real-SIGKILL flavor; this harness adds the
modes a process kill cannot express (hangs, delays, asymmetric
partitions) deterministically.

Stdlib-only; the injected errors are duck-typed gRPC status carriers
(``.code().name``), the same shape the router's unit tests use.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class FaultStatusError(Exception):
    """Duck-typed gRPC-status-shaped error (``.code().name`` /
    ``.details()``), so the router classifies injected faults exactly
    like real transport errors."""

    def __init__(self, status_name: str, details: str = "injected fault"):
        super().__init__(f"{status_name}: {details}")
        self._status_name = status_name
        self._details = details

    def code(self):
        class _Code:
            name = self._status_name

        return _Code()

    def details(self) -> str:
        return self._details


class FaultInjector:
    """Per-replica fault switchboard shared by every wrapped transport.

    Modes (per replica id; ``heal`` clears):
      kill       -> every call raises UNAVAILABLE immediately (a dead
                    or refused process);
      hang       -> every call blocks for min(hang_s, caller timeout)
                    then raises DEADLINE_EXCEEDED (a blackholed host);
      delay      -> every call sleeps ``delay_s`` then passes through
                    (a slow-but-healthy replica — must NOT eject);
      partition  -> like kill, but expressed as a SET of unreachable
                    ids so a test reads as the topology event it is.
    """

    def __init__(self, sleep: Callable[[float], None] = time.sleep):
        self._lock = threading.Lock()
        self._mode: Dict[str, tuple] = {}  # id -> (mode, param)
        self._sleep = sleep
        self.stat_injected = 0

    # -- control surface ------------------------------------------------

    def kill(self, replica_id: str) -> None:
        with self._lock:
            self._mode[replica_id] = ("kill", 0.0)

    def hang(self, replica_id: str, hang_s: float = 3600.0) -> None:
        with self._lock:
            self._mode[replica_id] = ("hang", float(hang_s))

    def delay(self, replica_id: str, delay_s: float) -> None:
        with self._lock:
            self._mode[replica_id] = ("delay", float(delay_s))

    def partition(self, *replica_ids: str) -> None:
        with self._lock:
            for rid in replica_ids:
                self._mode[rid] = ("kill", 0.0)

    def heal(self, *replica_ids: str) -> None:
        """Clear faults on the given ids (all of them when empty)."""
        with self._lock:
            if not replica_ids:
                self._mode.clear()
            else:
                for rid in replica_ids:
                    self._mode.pop(rid, None)

    def mode_of(self, replica_id: str) -> Optional[str]:
        with self._lock:
            m = self._mode.get(replica_id)
            return m[0] if m else None

    # -- transport seam -------------------------------------------------

    def wrap(self, replica_id: str, transport):
        """Wrap one replica's transport; the returned callable keeps
        the Transport protocol (request, timeout_s=None)."""

        def call(request, timeout_s=None):
            with self._lock:
                m = self._mode.get(replica_id)
                if m is not None:
                    self.stat_injected += 1
            if m is None:
                return transport(request, timeout_s=timeout_s)
            mode, param = m
            if mode == "kill":
                raise FaultStatusError(
                    "UNAVAILABLE", f"replica {replica_id} killed"
                )
            if mode == "hang":
                # Block for as long as the caller's timeout allows (a
                # real blackhole pins the call until the deadline).
                wait = param if timeout_s is None else min(param, timeout_s)
                self._sleep(wait)
                raise FaultStatusError(
                    "DEADLINE_EXCEEDED", f"replica {replica_id} hung {wait}s"
                )
            # delay: slow but healthy.
            self._sleep(param)
            return transport(request, timeout_s=timeout_s)

        return call


# ---------------------------------------------------------------------------
# device-seam injection (backends/fault_domain.py's proof harness)
# ---------------------------------------------------------------------------


class DeviceLostError(RuntimeError):
    """An injected 'the device went away' failure; the message carries
    a sticky CUDA error's wording so fault_domain.classify_fault
    buckets it exactly like a real loss of the CUDA context."""

    def __init__(self, label: str):
        super().__init__(f"device lost (unspecified launch failure): injected on bank {label}")


class DeviceFaultInjector:
    """Per-bank fault switchboard at the ENGINE seam — the dispatcher's
    submit/launch boundary (engine.submit_packed) and the readback wait
    (engine.step_complete).

    The intra-replica mirror of :class:`FaultInjector`: from the
    dispatcher's point of view a wedged kernel launch, a lost context
    and a crashed device all look like "the engine call hung or
    raised" — injecting there exercises the exact watchdog-stamp /
    wait-deadline / classification path real device faults take
    (backends/fault_domain.py), deterministically and without
    hardware.  Modes (per bank label; ``heal`` clears):

      hang         -> the next engine call blocks until healed (a hung
                      kernel launch / blackholed tunnel);
      raise        -> every call raises RuntimeError (a bug or bad
                      input in the step);
      device_lost  -> every call raises :class:`DeviceLostError`.

    ``at`` chooses the seam: "submit" (the collector's launch leg,
    trips the launch stamp) or "complete" (the completer's readback
    wait).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._mode: Dict[str, tuple] = {}  # label -> (mode, at)
        # hang mode parks engine calls on this event so `heal` can
        # release them (a plain sleep could not be interrupted and
        # would leak the collector for the whole test run).
        self._release = threading.Event()
        self.stat_injected = 0

    def hang(self, label: str, at: str = "submit") -> None:
        with self._lock:
            self._release.clear()
            self._mode[label] = ("hang", at)

    def raise_error(self, label: str, at: str = "submit") -> None:
        with self._lock:
            self._mode[label] = ("raise", at)

    def device_lost(self, label: str, at: str = "submit") -> None:
        with self._lock:
            self._mode[label] = ("device_lost", at)

    def heal(self, *labels: str) -> None:
        """Clear faults (all when empty) and release hung calls."""
        with self._lock:
            if not labels:
                self._mode.clear()
            else:
                for lb in labels:
                    self._mode.pop(lb, None)
            self._release.set()

    def mode_of(self, label: str):
        with self._lock:
            m = self._mode.get(label)
            return m[0] if m else None

    def _maybe_inject(self, label: str, seam: str) -> None:
        with self._lock:
            m = self._mode.get(label)
        if m is None:
            return
        mode, at = m
        if at != seam:
            return
        self.stat_injected += 1  # tpu-lint: disable=shared-state -- GIL-atomic test-harness tally
        if mode == "hang":
            # Block until healed: the dispatcher thread is now stuck
            # exactly like a wedged device call; the watchdog's stamp
            # check must quarantine the bank around it.
            self._release.wait()
            raise DeviceLostError(label)
        if mode == "device_lost":
            raise DeviceLostError(label)
        raise RuntimeError(f"injected device-step failure on bank {label}")

    def wrap_engine(self, label: str, engine):
        """Wrap one bank's engine; the proxy keeps the full engine
        surface (checkpoint, handoff, stats) via delegation and
        intercepts only the two dispatcher-facing calls."""
        return _FaultyEngine(self, label, engine)


class _FaultyEngine:
    """Engine proxy injecting at the submit/complete seams; everything
    else (model, slot_table, export/import, gc, stats) delegates."""

    def __init__(self, injector: DeviceFaultInjector, label: str, engine):
        self._injector = injector
        self._label = label
        self._engine = engine

    def submit_packed(self, now, key_blob, meta):
        self._injector._maybe_inject(self._label, "submit")
        return self._engine.submit_packed(now, key_blob, meta)

    def step_submit(self, batch, now=0):
        self._injector._maybe_inject(self._label, "submit")
        return self._engine.step_submit(batch, now)

    def step_complete(self, token):
        self._injector._maybe_inject(self._label, "complete")
        return self._engine.step_complete(token)

    def __getattr__(self, name):
        return getattr(self._engine, name)
