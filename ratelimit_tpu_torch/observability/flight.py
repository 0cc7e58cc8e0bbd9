"""Decision flight recorder: a preallocated lock-free ring of
per-request decision records.

Port of ratelimit_tpu/observability/flight.py, unchanged: the same
ring layout, codes and correlation ids, so a record means the same in
both packages.  In the port the gRPC handler and the /json bridge stamp,
and cuda_cache notes the decisive descriptor, the shadow candidate and
the fault domain's fallback answers.

Dashboards answer "how is the service doing"; an incident
needs "what exactly was it deciding in the seconds around the spike".
Following Dapper's always-on philosophy [Sigelman et al. 2010], this
module keeps the last ``FLIGHT_RECORDER_SIZE`` decisions in memory at
~sub-microsecond cost per request, so the anomaly detectors
(observability/detectors.py) can snapshot the black box the moment a
trigger trips — no reproduction, no raised sample rate after the fact.

One record per served request: monotonic timestamp, interned domain
id, key-stem hash + lane/bank of the decisive (first engine-routed)
descriptor, response code, hits addend, and the total-latency bucket
on the same power-of-two ladder as the /metrics histograms
(stats/manager.py ``_log_bounds``), so a ring record and a histogram
bucket line up 1:1.

Hot-path contract
-----------------

``record()`` runs on the RPC handler thread next to the per-phase
histogram sink (server/grpc_server.py) and must stay ~1us:

- the ring is a preallocated numpy STRUCTURED array (all-int64
  fields); writers stamp a whole row in ONE C call via
  ``struct.pack_into`` on a memoryview of the ring's buffer —
  measured ~0.5us/record, vs ~0.9us for a numpy row assignment and
  ~1.4us for per-field scalar writes (numpy's per-call overhead, not
  the memory traffic, is the cost);
- a whole-row write holds the GIL for its duration, so records are
  never torn: concurrent stampers and ``snapshot()`` (one C-level
  ``copy()``) see complete rows only;
- slot claim is ``next(itertools.count())`` (GIL-atomic) modulo the
  ring size — no lock, no CAS loop;
- the per-slot ``seq`` (1-based, stamped with the row) makes validity
  a window check at read time: a slot is live iff its seq lies in
  ``(hwm - size, hwm]``.  Zero-filled slots (seq 0) are never valid.

The key-stem hash and lane cannot be known at the transport layer, so
the backend's resolution fast path deposits them in a thread-local
"note" (:meth:`note`) while assembling the request
(backends/cuda_cache.py), and ``record()`` consumes the note on the
same thread.  Backends without the fast path simply never note;
records then carry stem 0 / lane -1.

``FLIGHT_RECORDER_SIZE=0`` disables recording entirely: the runner
builds no recorder and the handler's stamp is one attribute load and
a branch.
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from bisect import bisect_right
from typing import List, Optional

import numpy as np

from ..models.registry import ALGO_ID_TO_NAME as _ALGO_NAMES
from ..stats.manager import Histogram
from ..utils.time import MonotonicClock, REAL_MONOTONIC, RealMonotonicClock

#: All fields int64 on purpose: uniform dtype lets the writer's flat
#: (size, 8) view alias the structured ring byte-for-byte.
FLIGHT_DTYPE = np.dtype(
    [
        ("seq", np.int64),  # 1-based stamp counter; 0 = never written
        ("ts_ns", np.int64),  # monotonic ns (NOT wall: duration-safe)
        ("domain", np.int64),  # interned domain id (see domain_names)
        ("stem", np.int64),  # crc32 of the decisive descriptor's stem
        ("lane", np.int64),  # engine bank index; -1 = not engine-routed
        ("code", np.int64),  # api.Code value of the overall decision
        ("hits", np.int64),  # request hits_addend (clamped >= 1)
        ("lat_bucket", np.int64),  # index into LATENCY_BOUNDS_MS
        # Shadow-mode algorithm rollout (docs/ALGORITHMS.md): when the
        # request hit a rule shadowing a candidate limiter kernel,
        # BOTH codes land in the record — `code` is the enforced
        # (fixed-window) decision, `code2` the candidate's would-be
        # code (-1 when no shadow evaluation ran) and `algo` the
        # candidate's models/registry.py algo_id (0 otherwise).
        ("code2", np.int64),
        ("algo", np.int64),
        # Cross-hop correlation id (cluster/proxy.py mints one 63-bit
        # id per proxied request and carries it in gRPC metadata): the
        # SAME value lands in the proxy's ring, the owner replica's
        # ring and the replica's trace spans, so one grep joins the
        # hop-by-hop story.  0 = no correlation (standalone replica or
        # the feature is off).
        ("corr", np.int64),
    ]
)

#: Total-latency bucket ladder — the same fixed power-of-two bounds the
#: /metrics histograms use, so ring records and histogram buckets align.
LATENCY_BOUNDS_MS = Histogram.DEFAULT_BOUNDS

#: Domain-intern cap: a request storm over unseen domains must not grow
#: the id map unboundedly; overflow domains share id 0 ("_other").
MAX_DOMAINS = 256

#: Flight-record ``code`` for a decision the OVERLOAD CONTROLLER shed
#: (overload/controller.py): the wire response is a plain OVER_LIMIT
#: (the Envoy protocol has no richer vocabulary), but the ring must
#: distinguish "the limiter counted you out" from "the service refused
#: to do the work" — replay and incident forensics depend on it.
#: Outside the api.Code range (0..2) on purpose.
FLIGHT_CODE_SHED = 8

#: Cluster-tier sentinels (cluster/router.py stamps them when built
#: with a recorder): DEGRADED marks descriptors answered by the
#: CLUSTER_FAILURE_MODE policy because no live replica could serve
#: them (``hits`` carries how many); FORWARDED marks descriptors
#: routed to their OLD owner during a membership-change forwarding
#: window (cluster/handoff.py).  Same outside-the-protocol rationale
#: as FLIGHT_CODE_SHED.
FLIGHT_CODE_DEGRADED = 9
FLIGHT_CODE_FORWARDED = 10

#: Device-path fault-domain sentinel (backends/fault_domain.py): the
#: request was answered by the DEVICE_FAILURE_MODE fallback — the
#: quarantined bank's host mirror engine, a static allow/deny, or the
#: caller-deadline answer — instead of the device.  The wire response
#: stays within the protocol; the ring must separate "the device
#: decided" from "the fault domain answered" so incident forensics and
#: the chaos harness can count fallback admissions.  Same
#: outside-the-protocol rationale as FLIGHT_CODE_SHED.
FLIGHT_CODE_FALLBACK = 11

#: gRPC metadata key the proxy uses to carry the per-request
#: correlation id to the owner replica (cluster/proxy.py mints it,
#: server/grpc_server.py adopts it).  Rendered hex16, like a W3C
#: parent-id, so log greps work across rings, spans and metadata.
CORR_HEADER = "x-ratelimit-corr"

_CORR_MASK = 0x7FFFFFFFFFFFFFFF  # keep the int64 ring field positive


def mint_corr() -> int:
    """One non-zero 63-bit correlation id (proxy request intake)."""
    import os

    while True:
        corr = int.from_bytes(os.urandom(8), "big") & _CORR_MASK
        if corr:
            return corr


def format_corr(corr: int) -> str:
    return f"{corr & 0xFFFFFFFFFFFFFFFF:016x}"


def parse_corr(value: str) -> int:
    """Metadata intake: malformed values degrade to 0 (no
    correlation), never to an error — observability must not fail a
    request."""
    try:
        corr = int(value, 16)
    except (TypeError, ValueError):
        return 0
    return corr & _CORR_MASK


class _Note(threading.local):
    """Per-thread (stem_hash, lane) deposit from the backend's request
    assembly, consumed by the same thread's ``record()`` call.
    ``shadow`` carries the candidate-algorithm (code2, algo_id) pair
    deposited after a shadow comparison (backends/cuda_cache.py);
    ``fallback`` marks the request as answered by the device-path
    fault domain's failure-mode fallback."""

    value: tuple = (0, -1)
    shadow: tuple = (-1, 0)
    fallback: bool = False
    # Correlation id is STICKY, not consumed: the transport handler
    # overwrites it at request INTAKE (including to 0 when the hop
    # carried no id), so every record a request stamps — handler
    # stamp, router forwarded/degraded sentinels — shares the id, and
    # a thread can never inherit a previous request's id.
    corr: int = 0


class FlightRecorder:
    """The ring.  Construct via :func:`make_flight_recorder` (which
    maps size 0 to None so the disabled path costs one branch)."""

    def __init__(self, size: int, clock: Optional[MonotonicClock] = None):
        if size <= 0:
            raise ValueError("FlightRecorder size must be positive")
        self.size = int(size)
        self._clock = clock or REAL_MONOTONIC
        self._ring = np.zeros(self.size, FLIGHT_DTYPE)
        # Writer-side alias of the SAME memory: struct.pack_into on
        # this memoryview stamps a whole row in one GIL-holding C call
        # (atomic w.r.t. other threads; no torn records).
        self._ring_mv = memoryview(self._ring).cast("B")
        self._counter = itertools.count()
        self._note = _Note()
        self._bounds = LATENCY_BOUNDS_MS
        # Domain interning: the hot path is one GIL-atomic dict get;
        # MISSES intern under a lock.  The previous lock-free intern
        # raced: two RPC threads interning DIFFERENT domains could
        # interleave append and len(), leaving one id pointing at the
        # other thread's name — every later record for that domain
        # rendered under the wrong label (the reference's
        # tests and tests/test_torch_flight.py pin the
        # id<->name agreement under concurrent intern).
        self._intern_lock = threading.Lock()
        self._domain_ids: dict = {"_other": 0}
        self._domain_names: List[str] = ["_other"]
        self.record = self._make_record()

    # -- hot path ---------------------------------------------------------

    def note(self, stem_hash: int, lane: int) -> None:
        """Deposit the decisive descriptor's identity for this thread's
        in-flight request (called from the backend's request-assembly
        pass); consumed by the next ``record()`` on this thread."""
        self._note.value = (stem_hash, lane)

    def note_shadow(self, code2: int, algo_id: int) -> None:
        """Deposit the shadow-candidate outcome for this thread's
        in-flight request (the candidate kernel's would-be code and
        its algorithm id — backends/cuda_cache.py deposits after the
        divergence comparison); consumed by the next ``record()``."""
        self._note.shadow = (code2, algo_id)

    def note_corr(self, corr: int) -> None:
        """Adopt the request's correlation id for this thread (set at
        request intake by the transport handler — proxy or replica —
        BEFORE any record for the request can be stamped).  Sticky
        until the next intake on this thread; see _Note.corr."""
        self._note.corr = corr

    def current_corr(self) -> int:
        """This RPC thread's sticky correlation id (0 = none) — read
        at WorkItem build time so the launch recorder can point a slow
        launch back at the request rings (observability/launches.py)."""
        return self._note.corr

    def note_fallback(self) -> None:
        """Mark this thread's in-flight request as answered by the
        device-path failure-mode fallback (backends/fault_domain.py);
        its ring record stamps FLIGHT_CODE_FALLBACK.  Consumed by the
        next ``record()`` on this thread."""
        self._note.fallback = True

    def _make_record(self):
        """Build ``record`` as a closure over locals: every per-call
        ``self.`` lookup and the clock indirection is paid once here
        instead of per request (~300ns of the ~1us budget)."""
        mv = self._ring_mv
        itemsize = FLIGHT_DTYPE.itemsize
        pack_row = struct.Struct(
            "<%dq" % len(FLIGHT_DTYPE.names)
        ).pack_into
        size = self.size
        counter = self._counter
        note = self._note
        domain_ids = self._domain_ids
        bounds = self._bounds
        bis = bisect_right
        intern = self._intern_domain
        clock = self._clock
        now_ns = (
            time.monotonic_ns
            if type(clock) is RealMonotonicClock
            else clock.now_ns
        )
        no_note = (0, -1)
        no_shadow = (-1, 0)

        fallback_code = FLIGHT_CODE_FALLBACK
        shed_code = FLIGHT_CODE_SHED

        def record(
            domain: str, code: int, hits_addend: int, latency_ms: float
        ) -> None:
            """Stamp one decision (RPC handler thread, post-serialize)."""
            i = next(counter)
            stem, lane = note.value
            if lane != -1:
                note.value = no_note  # consume: no inheriting a note
            code2, algo = note.shadow
            if code2 != -1:
                note.shadow = no_shadow  # consume
            if note.fallback:
                note.fallback = False  # consume
                # The fault domain answered this request; sheds keep
                # their own code (a shed never reaches the backend, so
                # the two can't genuinely collide).
                if code != shed_code:
                    code = fallback_code
            dom = domain_ids.get(domain)
            if dom is None:
                dom = intern(domain)
            pack_row(
                mv,
                (i % size) * itemsize,
                i + 1,
                now_ns(),
                dom,
                stem,
                lane,
                code,
                hits_addend if hits_addend > 0 else 1,
                bis(bounds, latency_ms),
                code2,
                algo,
                note.corr,  # sticky per-request id; see _Note.corr
            )

        return record

    def _intern_domain(self, domain: str) -> int:
        # Cold path only (first sight of a domain).  The lock keeps
        # the list position and the id in agreement; without it two
        # threads interning different domains can cross-attribute
        # (append/len interleave).  Double-check inside: the loser of
        # the outer dict-get race must adopt the winner's id.
        with self._intern_lock:
            dom = self._domain_ids.get(domain)
            if dom is not None:
                return dom
            names = self._domain_names
            if len(names) >= MAX_DOMAINS:
                return 0
            names.append(domain)
            dom = len(names) - 1
            self._domain_ids[domain] = dom
            return dom

    # -- read surface -----------------------------------------------------

    def stamped(self) -> int:
        """Total records ever stamped (gauge; reads the seq high-water
        mark out of the ring, so it needs no extra counter)."""
        return int(self._ring["seq"].max())

    def snapshot(self) -> np.ndarray:
        """A consistent copy of the live records, oldest first.

        One C-level ``copy()`` under the GIL, then a validity window:
        a slot is live iff its seq is in ``(hwm - size, hwm]`` — slots
        never written (seq 0) drop out, and so would a slot from a
        writer that lapped the ring mid-copy."""
        ring = self._ring.copy()
        seq = ring["seq"]
        hwm = int(seq.max())
        if hwm == 0:
            return ring[:0]
        live = ring[seq > max(0, hwm - self.size)]
        return live[np.argsort(live["seq"], kind="stable")]

    def snapshot_dicts(self, limit: Optional[int] = None) -> List[dict]:
        """The JSON-facing view (incident reports, /debug surfaces):
        newest first, domain ids resolved back to names, latency
        buckets annotated with their upper bound."""
        live = self.snapshot()
        if limit is not None:
            live = live[-limit:]
        names = self._domain_names
        bounds = self._bounds
        out = []
        for rec in live[::-1].tolist():
            (
                seq, ts_ns, dom, stem, lane, code, hits, bucket,
                code2, algo, corr,
            ) = rec
            d = {
                "seq": seq,
                "ts_ns": ts_ns,
                "domain": names[dom] if 0 <= dom < len(names) else "?",
                "stem_hash": f"{stem & 0xFFFFFFFF:08x}",
                "lane": lane,
                "code": code,
                "hits": hits,
                "latency_le_ms": (
                    bounds[bucket] if bucket < len(bounds) else float("inf")
                ),
            }
            if corr:
                # Cross-hop correlation id, rendered in the same hex16
                # form the gRPC metadata and trace spans carry.
                d["corr"] = f"{corr & 0xFFFFFFFFFFFFFFFF:016x}"
            if code2 != -1:
                # Shadow-mode dual record: the candidate kernel's
                # would-be code + its algorithm-table name.
                d["shadow_code"] = code2
                d["shadow_algorithm"] = _ALGO_NAMES.get(algo, str(algo))
            if code == FLIGHT_CODE_SHED:
                # Overload-controller shed (overload/controller.py):
                # annotate so readers never mistake the sentinel for a
                # protocol code.
                d["shed"] = True
            elif code == FLIGHT_CODE_DEGRADED:
                d["degraded"] = True
            elif code == FLIGHT_CODE_FORWARDED:
                d["forwarded"] = True
            elif code == FLIGHT_CODE_FALLBACK:
                # Device-path fault domain answered this one
                # (backends/fault_domain.py).
                d["fallback"] = True
            out.append(d)
        return out

    def domain_names(self) -> List[str]:
        return list(self._domain_names)

    def register_stats(self, store, scope: str = "ratelimit.tpu.flight") -> None:
        """Bounded family: ring capacity + total stamped (a counter —
        its rate is the recorder's own served-decision rate)."""
        store.gauge_fn(scope + ".capacity", lambda: self.size)
        store.counter_fn(scope + ".stamped", self.stamped)


def make_flight_recorder(
    size: int, clock: Optional[MonotonicClock] = None
) -> Optional[FlightRecorder]:
    """Size 0 (FLIGHT_RECORDER_SIZE=0) disables: callers keep None and
    the serving path pays one attribute load + branch."""
    if size <= 0:
        return None
    return FlightRecorder(size, clock)
