"""The launch recorder's phase records on a device trace's clock.

A phase record (``PHASE_DTYPE``, below; the launch recorder's phase ring in
observability/launches.py) stamps an
engine submission's host phases on the monotonic clock.  torch.profiler
stamps device activities on the wall clock (``time.time_ns``'s
CLOCK_REALTIME, as ``kineto_results.events()[i].start_ns()`` gives them).
This module puts both on one clock and says what the host was doing
while the device sat idle:

- :func:`clock_offset` reads the wall-clock minus monotonic offset from
  paired reads, keeping the pair read with the least skew
  (:func:`offset_from_reads` does the choice on given reads);
- :func:`phase_intervals` rebuilds each record's contiguous child
  intervals (assign, stage, enqueue; wait, decide), on the monotonic
  clock;
- :func:`idle_gaps` takes the gaps between device activities, and
  :func:`name_gaps` names each by the phase that covers most of it, or
  ``outside_engine`` where no phase does (the caller's own loop);
  :func:`idle_by_phase` splits the whole idle time the same way.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Sequence, Tuple

import numpy as np

#: One engine submission's host phases, a record of the launch
#: recorder's phase ring (observability/launches.py): all int64, as the
#: launch ring's, for one-call stamping; durations and times in ns on
#: the recorder's clock.
PHASE_DTYPE = np.dtype(
    [
        ("seq", np.int64),  # 1-based phase stamp counter; 0 = never written
        ("launch", np.int64),  # seq of the launch record it rode; 0 = none
        ("bank", np.int64),  # engine bank index, as the launch ring's
        ("algo", np.int64),  # models/registry.py algo_id of the bank
        ("lanes", np.int64),  # lanes submitted
        ("groups", np.int64),  # distinct slots after dedup
        ("fresh", np.int64),  # fresh groups (keys new to their window)
        ("submit_t0_ns", np.int64),  # submit_packed entry
        ("submit_ns", np.int64),  # submit_packed duration
        ("assign_ns", np.int64),  # assign + dedup (first child)
        ("stage_ns", np.int64),  # staging fill (second child)
        ("enqueue_ns", np.int64),  # launch + event records (third child)
        ("complete_t0_ns", np.int64),  # step_complete entry
        ("complete_ns", np.int64),  # step_complete duration
        ("wait_ns", np.int64),  # blocked on the event (first child)
        ("decide_ns", np.int64),  # readback copy + decide (second child)
        ("device_ns", np.int64),  # CUDA-event time of the device work
    ]
)

#: Phase names, in the order a submission runs them.
ASSIGN = "engine.assign_dedup"
STAGE = "engine.stage"
ENQUEUE = "engine.enqueue"
WAIT = "engine.wait"
DECIDE = "engine.decide"
OUTSIDE = "outside_engine"
PHASES = (ASSIGN, STAGE, ENQUEUE, WAIT, DECIDE)


def offset_from_reads(reads: Iterable[Tuple[int, int, int]]) -> Tuple[int, int]:
    """(offset_ns, skew_ns) from (monotonic before, wall, monotonic
    after) reads: the read whose two monotonic stamps lie closest
    together, its wall time less their midpoint.  Add the offset to a
    monotonic time to get the wall time; skew bounds the error."""
    best = min(reads, key=lambda r: r[2] - r[0])
    m0, wall, m1 = best
    return wall - (m0 + m1) // 2, m1 - m0


def clock_offset(samples: int = 64) -> Tuple[int, int]:
    """Wall-clock minus monotonic offset of this host now, in ns, and
    the skew of the read it came from (offset_from_reads over
    `samples` reads)."""
    mono, wall = time.monotonic_ns, time.time_ns
    reads = []
    for _ in range(samples):
        m0 = mono()
        w = wall()
        reads.append((m0, w, mono()))
    return offset_from_reads(reads)


def phase_intervals(records, offset_ns: int = 0) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, phase name) of every child interval of the
    phase records (a PHASE_DTYPE array or its rows as dicts), plus
    `offset_ns` (clock_offset's, to reach the wall clock).  Children
    are contiguous from their root's start: assign, stage, enqueue from
    ``submit_t0_ns``; wait, decide from ``complete_t0_ns``."""
    out = []
    for r in records:
        t = int(r["submit_t0_ns"]) + offset_ns
        for name, key in ((ASSIGN, "assign_ns"), (STAGE, "stage_ns"), (ENQUEUE, "enqueue_ns")):
            d = int(r[key])
            out.append((t, t + d, name))
            t += d
        t = int(r["complete_t0_ns"]) + offset_ns
        for name, key in ((WAIT, "wait_ns"), (DECIDE, "decide_ns")):
            d = int(r[key])
            out.append((t, t + d, name))
            t += d
    out.sort()
    return out


def idle_gaps(activities: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of each stretch between device activities,
    given as (start_ns, duration_ns) on one clock: the complement of
    their union inside the first start and the last end."""
    gaps, end = [], None
    for start, dur in sorted(activities):
        if end is not None and start > end:
            gaps.append((end, start))
        if end is None or start + dur > end:
            end = start + dur
    return gaps


def _cover(gap: Tuple[int, int], intervals: Sequence[Tuple[int, int, str]]) -> dict:
    """ns of `gap` each phase covers; the rest under OUTSIDE."""
    g0, g1 = gap
    out = {}
    for s, e, name in intervals:
        if s >= g1:
            break
        lap = min(e, g1) - max(s, g0)
        if lap > 0:
            out[name] = out.get(name, 0) + lap
    out[OUTSIDE] = max(0, (g1 - g0) - sum(out.values()))
    return out


def name_gaps(gaps, intervals, top: int = 10) -> List[list]:
    """The `top` longest gaps as [name, seconds], longest first, each
    named by the phase interval (phase_intervals) that covers most of
    it, or OUTSIDE where the time outside every phase is the most."""
    named = []
    for gap in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        cover = _cover(gap, intervals)
        named.append([max(cover, key=cover.get), (gap[1] - gap[0]) / 1e9])
    return named


def idle_by_phase(gaps, intervals) -> dict:
    """Seconds of all the idle time that each phase covers, and OUTSIDE
    the rest."""
    total = {}
    for gap in gaps:
        for name, ns in _cover(gap, intervals).items():
            total[name] = total.get(name, 0) + ns
    return {name: ns / 1e9 for name, ns in total.items()}
