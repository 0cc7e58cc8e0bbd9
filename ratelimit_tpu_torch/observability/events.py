"""Lifecycle event journal: the ordered timeline behind an incident.

Port of ratelimit_tpu/observability/events.py, unchanged.  In the port
the fault domain (``bank_*``), the service (``config_reload``), the
anomaly detectors (``incident``), the overload controller
(``shed_floor``, ``backpressure``) and the replica's handoff
(``handoff_export``, ``handoff_import``) emit; the proxy's handoff and
membership types stay in the family for the front tier still to port.

Counters say *how many* quarantines, handoffs, shed-floor moves and
membership changes happened; they cannot say *in what order* — and the
order is the incident narrative ("bank 0 quarantined, fallback served,
shed floor rose, then the warm restart landed").  The journal is a
bounded ring of typed, monotonically-stamped events emitted from the
existing lifecycle seams:

- ``bank_quarantine`` / ``bank_fallback`` / ``bank_half_open`` /
  ``bank_restart`` / ``bank_restart_failed`` — DeviceFaultDomain
  (backends/fault_domain.py);
- ``handoff_begin`` / ``handoff_partition`` / ``handoff_end`` —
  the proxy's RouterHolder driving HandoffCoordinator, plus
  ``handoff_export`` / ``handoff_import`` on the replicas
  (cluster/handoff.py);
- ``shed_floor`` / ``backpressure`` — OverloadController transitions
  (overload/controller.py);
- ``membership_change`` / ``replica_eject`` / ``replica_readmit`` —
  the proxy's ReplicaRouter / RouterHolder (cluster/{router,proxy}.py);
- ``config_reload`` — RateLimitService adopting a new config
  generation (service/ratelimit.py);
- ``incident`` — AnomalyDetectors captures (observability/detectors.py).

Emission is COLD-path by construction: every seam above is a state
*transition* (quarantine entry, floor move, circuit open), never a
per-request action, so the journal adds zero per-request cost.  The
ring itself follows the flight recorder's discipline — a preallocated
list, an ``itertools.count`` slot claim, and one GIL-atomic list-item
store per event, so emitters never serialize on a lock.  The per-type
tallies (scraped as ``ratelimit.events.*`` counters on the statsd
delta path) take a small lock; that is fine on transitions.

Readers (``GET /debug/events``, incident JSON, the proxy's
``/fleet.json`` merge) get ``snapshot(since=seq)``: a time-ordered
window of the retained events with a resumable cursor — the same
seq-window validity rule as the flight ring (an event is live iff its
seq is in ``(hwm - size, hwm]``).
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Dict, List, Optional

from ..utils.time import REAL_MONOTONIC

__all__ = [
    "EVENT_TYPES",
    "EventJournal",
    "make_event_journal",
]

# The bounded event-type family: /metrics and statsd names mint from
# THIS tuple at register_stats time, never from traffic, so journal
# cardinality is a code review, not a runtime property.  emit() accepts
# only these types (a typo'd type is a programming error worth raising
# on — emitters are all in-tree seams, never request data).
EVENT_TYPES = (
    "bank_quarantine",
    "bank_fallback",
    "bank_half_open",
    "bank_restart",
    "bank_restart_failed",
    "handoff_begin",
    "handoff_partition",
    "handoff_end",
    "handoff_export",
    "handoff_import",
    "shed_floor",
    "backpressure",
    "membership_change",
    "replica_eject",
    "replica_readmit",
    "config_reload",
    "incident",
)

_KNOWN = frozenset(EVENT_TYPES)


class EventJournal:
    """Bounded ring of lifecycle events + per-type tallies.

    ``emit()`` is safe from any thread (supervisor, detector sampler,
    gRPC handler hitting a circuit transition, reload callback) and
    never blocks on readers.  ``snapshot()`` is safe against
    concurrent emitters: rows whose seq falls outside the live window
    are dropped, exactly like FlightRecorder.snapshot.
    """

    def __init__(
        self,
        size: int = 1024,
        clock=None,
        wall=None,
        jsonl_path: str = "",
    ):
        if size <= 0:
            raise ValueError("EventJournal size must be positive")
        self.size = int(size)
        self._clock = clock or REAL_MONOTONIC
        # Wall-clock seam for tests; monotonic stamps order the
        # timeline, the unix stamp is for humans and cross-replica
        # merge display only.
        import time as _time

        self._wall = wall or _time.time
        self._ring: List[Optional[tuple]] = [None] * self.size
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {t: 0 for t in EVENT_TYPES}
        self._jsonl_path = jsonl_path
        self._jsonl = None
        if jsonl_path:
            self._jsonl = open(jsonl_path, "a", encoding="utf-8")

    # -- emit -------------------------------------------------------------

    def emit(self, etype: str, **detail) -> int:
        """Append one event; returns its seq (1-based, monotonic).

        ``detail`` values must be JSON-serializable scalars/lists —
        they render verbatim in /debug/events, incident JSON and the
        JSONL export.
        """
        if etype not in _KNOWN:
            raise ValueError(f"unknown event type {etype!r}")
        i = next(self._counter)  # GIL-atomic slot claim
        seq = i + 1
        row = (
            seq,
            self._clock.now_ns(),
            self._wall(),
            etype,
            detail,
        )
        self._ring[i % self.size] = row
        with self._lock:
            self._counts[etype] += 1
            sink = self._jsonl
            if sink is not None:
                try:
                    sink.write(json.dumps(self._row_dict(row)) + "\n")
                    sink.flush()
                except OSError:
                    self._jsonl = None  # disk went away; keep serving
        return seq

    # -- read -------------------------------------------------------------

    @staticmethod
    def _row_dict(row: tuple) -> dict:
        seq, mono_ns, unix, etype, detail = row
        d = {
            "seq": seq,
            "ts_mono_ns": mono_ns,
            "ts_unix": round(unix, 6),
            "type": etype,
        }
        if detail:
            d.update(detail)
        return d

    def snapshot(
        self, since: int = 0, limit: Optional[int] = None
    ) -> List[dict]:
        """Time-ordered live events with ``seq > since``.

        The cursor contract for pollers: pass the max seq you saw last
        time; you only ever miss events that aged out of the ring
        between polls (detectable as a seq gap).
        """
        rows = list(self._ring)  # one copy pass under the GIL
        # itertools.count exposes no peek; derive the high-water mark
        # from the copied rows (max seq seen bounds the live window).
        hwm = 0
        live = []
        for row in rows:
            if row is not None and row[0] > hwm:
                hwm = row[0]
        floor = max(int(since), hwm - self.size)
        for row in rows:
            if row is not None and row[0] > floor:
                live.append(row)
        live.sort(key=lambda r: r[0])
        if limit is not None and len(live) > limit:
            live = live[-limit:]
        return [self._row_dict(r) for r in live]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def emitted(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    # -- stats / lifecycle ------------------------------------------------

    def register_stats(self, store, scope: str = "ratelimit.events") -> None:
        """Per-type counters + total on the fn-backed counter seam —
        the statsd exporter delta-tracks them like every other
        family."""
        for etype in EVENT_TYPES:
            store.counter_fn(
                scope + "." + etype,
                lambda t=etype: self._counts[t],
            )
        store.counter_fn(scope + ".emitted", lambda: self.emitted)
        store.gauge_fn(
            scope + ".retained",
            lambda: sum(1 for r in self._ring if r is not None),
        )

    def close(self) -> None:
        with self._lock:
            sink, self._jsonl = self._jsonl, None
        if sink is not None:
            try:
                sink.close()
            except OSError:
                pass


def make_event_journal(
    size: int, jsonl_path: str = "", clock=None, wall=None
) -> Optional[EventJournal]:
    """Settings seam: EVENT_JOURNAL_SIZE <= 0 disables the journal
    entirely (every emitter holds ``events=None`` and skips)."""
    if size <= 0:
        return None
    return EventJournal(size, clock=clock, wall=wall, jsonl_path=jsonl_path)
