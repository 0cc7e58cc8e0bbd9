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
"""

from __future__ import annotations

import itertools
import struct
from typing import List, Optional

import numpy as np

from ..models.registry import ALGO_ID_TO_NAME as _ALGO_NAMES
from ..utils.time import MonotonicClock, REAL_MONOTONIC, RealMonotonicClock

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
        ) -> None:
            """Stamp one launch (collector / completer thread)."""
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

        return record

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
        ring = self._ring.copy()
        seq = ring["seq"]
        hwm = int(seq.max())
        if hwm == 0:
            return ring[:0]
        live = ring[seq > max(int(since), 0, hwm - self.size)]
        return live[np.argsort(live["seq"], kind="stable")]

    def snapshot_dicts(
        self, since: int = 0, limit: Optional[int] = None
    ) -> List[dict]:
        """The JSON-facing view (``GET /debug/launches``): time-ordered
        oldest first with a resumable ``since=`` seq cursor — the
        /debug/events contract, so pollers reuse the same loop."""
        live = self.snapshot(since)
        if limit is not None and len(live) > limit:
            live = live[-limit:]
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


def make_launch_recorder(
    size: int, clock: Optional[MonotonicClock] = None
) -> Optional[LaunchRecorder]:
    """Size 0 (LAUNCH_RECORDER_SIZE=0) disables: callers keep None and
    the dispatch path pays one attribute load + branch per launch."""
    if size <= 0:
        return None
    return LaunchRecorder(size, clock)
