"""Launch flight recorder: a preallocated lock-free ring of
per-LAUNCH device-batch records.

Port of ratelimit_tpu/observability/launches.py, unchanged.  In the
port a launch is one submission to a bank's CUDA stream: ``launch_ns``
runs from submit_items entry until the kernel is enqueued on the
stream, ``complete_ns`` from the start of the CUDA event wait through
decide and scatter, and the record is stamped after the event has
completed (backends/dispatcher.py).

The aggregate histograms (batch_lanes / batch_items, per-phase
latency) say how launches are shaped on average; they cannot answer
"what did launch N look like, and was the time spent waiting in the
intake queue, in the host submit leg, or on the device?"  This module
is the per-launch analog of the per-request flight ring
(observability/flight.py): one record per device batch, stamped at the
dispatcher's existing submit/complete seams (backends/dispatcher.py),
so the fused-dispatch work ROADMAP item 2 plans is judged against an
inspectable timeline instead of a mean.

One record per launch: monotonic timestamp, bank index + algorithm id,
lane/item/dedup-group counts (the coalescing story), and the three
phase durations —

- ``queue_wait_ns``  oldest item's submit -> collector launch start
  (intake queue + batch window);
- ``launch_ns``      submit_items entry -> device step in flight
  (host-side assign/dedup/transfer);
- ``complete_ns``    readback wait + decide + scatter
  (complete_items duration on the completer thread);

plus the outcome (ok / fault / fallback) and the correlation id of the
SLOWEST (longest-queued) item, so one grep joins a slow launch to the
request rings and trace spans that rode it.

Hot-path contract
-----------------

Identical to flight.py, because the constraint is identical: writers
stamp a whole row in ONE GIL-holding C call (``struct.pack_into`` on a
memoryview of a preallocated all-int64 structured ring), the slot
claim is ``next(itertools.count())`` (GIL-atomic), and validity is a
seq-window check at read time — a slot is live iff its seq lies in
``(hwm - size, hwm]``.  Stamping runs on the dispatcher's collector /
completer threads (never the RPC threads) at most once per LAUNCH, so
the per-request amortized cost is launch-cost / items-per-batch.

``LAUNCH_RECORDER_SIZE=0`` disables recording entirely: the runner
builds no recorder, dispatchers keep ``launches=None``, and the
dispatch path pays one attribute load + branch per launch.

Phase records (the port's own)
------------------------------

A companion ring of the same recorder holds one phase record
(``observability/phases.py``, ``PHASE_DTYPE``)
per ``CounterEngine.submit_packed`` / ``step_complete`` pair of an
engine the recorder is attached to (``CounterEngine.
attach_launch_recorder``; ``CudaRateLimitCache.attach_launch_recorder``
with ``phases=True`` attaches it to every served bank's engine, which the
runner's recorder does not ask for).  It splits the engine's two calls
into their host phases, each a duration on the recorder's clock
(monotonic ns):

- ``submit_ns`` from ``submit_t0_ns``: the whole ``submit_packed``, whose
  contiguous children are ``assign_ns`` (lane fields unpacked, slot
  assign + dedup, native or Python table), ``stage_ns`` (bucket and
  readback width picked, pinned staging rows filled) and ``enqueue_ns``
  (the step wrapper's launch and the event records on the stream);
- ``complete_ns`` from ``complete_t0_ns``: the whole ``step_complete``,
  whose contiguous children are ``wait_ns`` (blocked on the
  submission's event) and ``decide_ns`` (readback copy and host decide);
- ``device_ns``: the chunk's device work from a pair of CUDA timing
  events around its launch, run back to back behind a gate on the
  stream; 0 (unknown) off CUDA, where the gate cannot hold the stream,
  and where a chunk of the submission went untimed.  It reads the
  kernel plus the pair's own cost on the card, about 4 us above the
  profiler's kernel time on an H100 (PERF.md).

Each root's self time is its duration less its children's.  A
submission of several chunks sums each child, and ``device_ns``, over
its chunks.  ``launch`` joins the record to the dispatcher's launch
record it rode (that record's ``seq``); it is 0 for an engine driven
directly.  The phase ring keeps the launch ring's discipline (one
``struct.pack_into`` a record, seq-window validity, ``since`` cursor);
``LAUNCH_DTYPE`` and the launch ring's views are the JAX package's,
unchanged: only ``snapshot_dicts(phases=True)`` (``GET
/debug/launches?phases=1``) shows a launch's phases.
"""

from __future__ import annotations

import itertools
import struct
from typing import List, Optional

import numpy as np

from ..models.registry import ALGO_ID_TO_NAME as _ALGO_NAMES
from ..utils.time import MonotonicClock, REAL_MONOTONIC, RealMonotonicClock
from .phases import PHASE_DTYPE as _PHASE_DTYPE

__all__ = [
    "LAUNCH_DTYPE",
    "OUTCOME_OK",
    "OUTCOME_FAULT",
    "OUTCOME_FALLBACK",
    "LaunchRecorder",
    "make_launch_recorder",
]

#: All fields int64 on purpose (flight.py's discipline): uniform dtype
#: lets struct.pack_into stamp a whole row through one flat byte view.
LAUNCH_DTYPE = np.dtype(
    [
        ("seq", np.int64),  # 1-based stamp counter; 0 = never written
        ("ts_ns", np.int64),  # monotonic ns at record time
        ("bank", np.int64),  # engine bank index (cuda_cache.engines())
        ("algo", np.int64),  # models/registry.py algo_id of the bank
        ("lanes", np.int64),  # total engine lanes in the batch
        ("items", np.int64),  # work items (requests) coalesced into it
        ("dedup_groups", np.int64),  # unique slots after dedup
        ("queue_wait_ns", np.int64),  # oldest submit -> launch start
        ("launch_ns", np.int64),  # submit_items entry -> device in flight
        ("complete_ns", np.int64),  # readback wait + decide + scatter
        ("outcome", np.int64),  # OUTCOME_OK / _FAULT / _FALLBACK
        ("corr", np.int64),  # corr id of the longest-queued item
    ]
)

#: Launch outcomes.  FAULT covers submit and complete failures (the
#: fault domain's taxonomy has the details; the ring answers "when");
#: FALLBACK marks a quarantined bank's request answered by the
#: failure-mode fallback instead of the device (one record per
#: fallback answer — those are single-item, host-side "launches").
OUTCOME_OK = 0
OUTCOME_FAULT = 1
OUTCOME_FALLBACK = 2

_OUTCOME_NAMES = {
    OUTCOME_OK: "ok",
    OUTCOME_FAULT: "fault",
    OUTCOME_FALLBACK: "fallback",
}


class LaunchRecorder:
    """The ring.  Construct via :func:`make_launch_recorder` (which
    maps size 0 to None so the disabled path costs one branch per
    launch)."""

    def __init__(self, size: int, clock: Optional[MonotonicClock] = None):
        if size <= 0:
            raise ValueError("LaunchRecorder size must be positive")
        self.size = int(size)
        self._clock = clock or REAL_MONOTONIC
        self._ring = np.zeros(self.size, LAUNCH_DTYPE)
        self._ring_mv = memoryview(self._ring).cast("B")
        self._counter = itertools.count()
        # Per-algorithm item tallies (plain ints, GIL-atomic bumps on
        # the collector thread, scrape-only readers): the bounded
        # family behind per-algo decisions/s in the time-series store.
        # Keys are minted from the algorithm registry at construction,
        # never from traffic.
        self._items_by_algo = {aid: 0 for aid in _ALGO_NAMES}
        self.record = self._make_record()
        # The phase ring: same size, its own seq counter.
        self._phases = np.zeros(self.size, _PHASE_DTYPE)
        self._phase_counter = itertools.count()
        self.record_phase = self._make_record_phase()

    # -- hot path (once per LAUNCH, on dispatcher threads) ---------------

    def _make_record(self):
        """Build ``record`` as a closure over hoisted locals, exactly
        like FlightRecorder._make_record: the per-call ``self.``
        lookups and the clock indirection are paid once here."""
        mv = self._ring_mv
        itemsize = LAUNCH_DTYPE.itemsize
        pack_row = struct.Struct(
            "<%dq" % len(LAUNCH_DTYPE.names)
        ).pack_into
        size = self.size
        counter = self._counter
        items_by_algo = self._items_by_algo
        clock = self._clock
        import time as _time

        now_ns = (
            _time.monotonic_ns
            if type(clock) is RealMonotonicClock
            else clock.now_ns
        )

        def record(
            bank: int,
            algo: int,
            lanes: int,
            items: int,
            dedup_groups: int,
            queue_wait_ns: int,
            launch_ns: int,
            complete_ns: int,
            outcome: int,
            corr: int = 0,
        ) -> int:
            """Stamp one launch (collector / completer thread); returns
            its seq, the key a phase record joins it by."""
            i = next(counter)
            pack_row(
                mv,
                (i % size) * itemsize,
                i + 1,
                now_ns(),
                bank,
                algo,
                lanes,
                items,
                dedup_groups,
                queue_wait_ns,
                launch_ns,
                complete_ns,
                outcome,
                corr,
            )
            if algo in items_by_algo:
                items_by_algo[algo] += items
            return i + 1

        return record

    def _make_record_phase(self):
        """``record_phase(launch, bank, algo, lanes, groups, fresh,
        submit_t0_ns, submit_ns, assign_ns, stage_ns, enqueue_ns,
        complete_t0_ns, complete_ns, wait_ns, decide_ns, device_ns)``:
        stamp one phase record in one C call (PHASE_DTYPE's fields after
        ``seq``, in order); returns its seq.  Runs on the thread that
        completes the submission."""
        mv = memoryview(self._phases).cast("B")
        itemsize = _PHASE_DTYPE.itemsize
        pack_row = struct.Struct("<%dq" % len(_PHASE_DTYPE.names)).pack_into
        size = self.size
        counter = self._phase_counter

        def record_phase(*fields) -> int:
            i = next(counter)
            pack_row(mv, (i % size) * itemsize, i + 1, *fields)
            return i + 1

        return record_phase

    # -- read surface -----------------------------------------------------

    def stamped(self) -> int:
        """Total launches ever stamped (the seq high-water mark; its
        statsd/tsdb delta IS the launch rate)."""
        return int(self._ring["seq"].max())

    def items_by_algo(self) -> dict:
        """Per-algorithm item tallies, keyed by registry name — the
        bounded per-algo decisions/s source (observability/
        timeseries.py)."""
        return {
            _ALGO_NAMES[aid]: n for aid, n in self._items_by_algo.items()
        }

    def snapshot(self, since: int = 0) -> np.ndarray:
        """A consistent copy of the live records with ``seq > since``,
        oldest first — one C-level copy under the GIL, then the same
        seq-window validity check as FlightRecorder.snapshot."""
        return self._live(self._ring, since)

    def _live(self, ring: np.ndarray, since: int) -> np.ndarray:
        ring = ring.copy()
        seq = ring["seq"]
        hwm = int(seq.max())
        if hwm == 0:
            return ring[:0]
        live = ring[seq > max(int(since), 0, hwm - self.size)]
        return live[np.argsort(live["seq"], kind="stable")]

    def snapshot_phases(self, since: int = 0) -> np.ndarray:
        """The live phase records with ``seq > since``, oldest first
        (snapshot's discipline, on the phase ring)."""
        return self._live(self._phases, since)

    def phases_stamped(self) -> int:
        """Total phase records ever stamped."""
        return int(self._phases["seq"].max())

    def phase_dicts(self, since: int = 0, limit: Optional[int] = None) -> List[dict]:
        """JSON view of the phase ring, oldest first, with the ``since``
        cursor of snapshot_dicts."""
        live = self.snapshot_phases(since)
        if limit is not None and len(live) > limit:
            live = live[-limit:]
        return [_phase_view(rec) for rec in live]

    def snapshot_dicts(
        self, since: int = 0, limit: Optional[int] = None, phases: bool = False
    ) -> List[dict]:
        """The JSON-facing view (``GET /debug/launches``): time-ordered
        oldest first with a resumable ``since=`` seq cursor — the
        /debug/events contract, so pollers reuse the same loop.  With
        `phases`, a launch whose engine stamped a phase record carries
        it under ``phases`` (_phase_view); the others are as the JAX
        package shows them."""
        live = self.snapshot(since)
        if limit is not None and len(live) > limit:
            live = live[-limit:]
        # Phase records joined to their launch (by its seq); nothing is
        # added to a launch that has none.
        joined = {}
        if phases and len(live) and self._phases["seq"].any():
            rides = self.snapshot_phases()
            rides = rides[np.isin(rides["launch"], live["seq"])]
            joined = {int(rec["launch"]): _phase_view(rec) for rec in rides}
        out = []
        for rec in live.tolist():
            (
                seq, ts_ns, bank, algo, lanes, items, dedup, queue_wait,
                launch, complete, outcome, corr,
            ) = rec
            d = {
                "seq": seq,
                "ts_ns": ts_ns,
                "bank": bank,
                "algorithm": _ALGO_NAMES.get(algo, str(algo)),
                "lanes": lanes,
                "items": items,
                "dedup_groups": dedup,
                "queue_wait_us": round(queue_wait / 1e3, 1),
                "launch_us": round(launch / 1e3, 1),
                "complete_us": round(complete / 1e3, 1),
                "outcome": _OUTCOME_NAMES.get(outcome, str(outcome)),
            }
            if corr:
                # Longest-queued item's cross-hop id, hex16 like the
                # flight ring and trace spans render it.
                d["corr"] = f"{corr & 0xFFFFFFFFFFFFFFFF:016x}"
            if seq in joined:
                d["phases"] = joined[seq]
            out.append(d)
        return out

    # -- derived metric families ------------------------------------------

    def p99_launch_ns(self) -> int:
        """p99 of launch_ns over the live ring (completed launches
        only) — the derived gauge dashboards alert on.  Ring-bounded
        cost, scrape-time only."""
        live = self.snapshot()
        if len(live) == 0:
            return 0
        ok = live[live["outcome"] == OUTCOME_OK]
        if len(ok) == 0:
            return 0
        return int(np.percentile(ok["launch_ns"], 99))

    def coalesce_ratio(self) -> float:
        """Mean items per launch over the live ring: how much the
        batch window is actually aggregating (1.0 = no coalescing)."""
        live = self.snapshot()
        if len(live) == 0:
            return 0.0
        return round(float(live["items"].mean()), 3)

    def register_stats(self, store, scope: str = "ratelimit.tpu.launch") -> None:
        """The derived ``ratelimit.tpu.launch.*`` family: ``rate`` is a
        counter (its statsd delta is launches/s), the rest are
        ring-derived gauges."""
        store.gauge_fn(scope + ".capacity", lambda: self.size)
        store.counter_fn(scope + ".rate", self.stamped)
        store.gauge_fn(scope + ".p99_launch_ns", self.p99_launch_ns)
        store.float_gauge_fn(scope + ".coalesce_ratio", self.coalesce_ratio)


def _phase_view(rec) -> dict:
    """One phase record as JSON: the counts, the two start times (ns on
    the recorder's clock) and every duration in microseconds."""
    r = dict(zip(_PHASE_DTYPE.names, (int(v) for v in rec.tolist())))
    out = {k: r[k] for k in ("seq", "launch", "bank", "lanes", "groups", "fresh",
                             "submit_t0_ns", "complete_t0_ns")}
    out["algorithm"] = _ALGO_NAMES.get(r["algo"], str(r["algo"]))
    for k in ("submit", "assign", "stage", "enqueue", "complete", "wait", "decide", "device"):
        out[k + "_us"] = round(r[k + "_ns"] / 1e3, 1)
    return out


def make_launch_recorder(
    size: int, clock: Optional[MonotonicClock] = None
) -> Optional[LaunchRecorder]:
    """Size 0 (LAUNCH_RECORDER_SIZE=0) disables: callers keep None and
    the dispatch path pays one attribute load + branch per launch."""
    if size <= 0:
        return None
    return LaunchRecorder(size, clock)
