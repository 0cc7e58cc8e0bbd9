"""CounterEngine: host orchestration around the device model.

Port of ratelimit_tpu/backends/engine.py.  Owns the counter table (one
int32 tensor of u32 bits on the engine's device), the host slot table,
and batch padding/bucketing.  The host halves -- ``DEFAULT_BUCKETS``,
``_Dedup``, ``_dedup_chunk``, ``_decide_host`` and the u8/u16/u32
readback choice -- are the reference's, unchanged.

Two model protocols, as in the reference.  The fixed-window model
serves through its saturating unique-slot step (K1, int32[4, padded]
up, u8/u16/u32 afters back).  A model with ``lane_counts`` runs the
generic algorithm protocol (sliding window K4, GCRA K5): int32[5,
padded] up (the divider row added), the batch clock ``now`` beside it,
the model's own readback (u32[2, padded] or i32[padded]) back, and
``decide_generic`` on the host.  Stable-stem models
(``windowed_keys=False``) get the Python slot table with
refresh-on-touch expiry, so a hot key keeps its slot and state.

The device half runs on a CUDA stream the engine owns.
``_device_submit`` fills a pinned staging buffer with the packed batch,
and the batch's shape alone picks the form (``lanes_by_value``).  A chunk
of at most 128 padded lanes, fixed-window or algorithm, goes by value:
ONE launch carries the lanes as kernel parameters and its kernel (K1,
K4 or K5) writes the readback straight into pinned host memory, so the
chunk is one device activity.  A wider chunk (warmup, bursts, wide
requests) takes the mapped form of its kernel (K1, K4 or K5): ONE
launch whose kernel reads the staged batch through its device alias and
writes the readback the same way -- again one device activity, with no
copy and no device buffer.  Either way an event is recorded after it.  ``step_complete`` waits
on that event (never on the whole device) before the host decide pass.
With a launch recorder attached (``attach_launch_recorder``), each
submission also leaves a phase record (observability/launches.py): its
host phases on the monotonic clock and, on CUDA, its device time from a
pair of timing events recorded around the launch while the stream is
held by a gate (``_DeviceTimer``), so the pair times the device work and
not the host's enqueue.  Detached, ``submit_packed`` and ``step_complete``
each pay one attribute load and one branch for it, and ``_serve_on``
one load and three branches.
Each in-flight submission holds its own staging buffers, so the
dispatcher can launch batch N+1 while batch N's readback is in flight;
stream order stands in for the reference's donated-buffer chain.  The
stream is passed explicitly wherever it is used: ``step_complete`` runs
on another thread, and a stream context is thread-local.  No two live
engines share a stream (``claim_stream``): a stall on one bank's stream
must hold up no other bank.  An engine whose table lies in bank groups
over several cards (parallel.ShardedCounterEngine) holds one stream,
staging pool and event per card, each on its card
(``_more_streams`` beside ``_stream``); this engine is one card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import logging
import math
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from ..models.fixed_window import (
    OUT_DTYPES,
    FixedWindowModel,
    lanes_by_value,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
)
from .slot_table import EntryArrays, SlotTable, stamp_table_stats

logger = logging.getLogger("ratelimit.engine")

# Pad batches up to one of these sizes so a handful of kernel shapes
# serve every batch length (batch-axis bucketing to fixed shapes).
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# Host numpy views of the readback storage types (u16 lives in int16).
_HOST_VIEW = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8}

#: torch hands out the CUDA streams of one priority from a pool of this
#: many per device, in turn (kStreamsPerPool in c10/cuda/CUDAStream.cpp).
STREAM_POOL_SIZE = 32

#: cuda_stream handle -> the engine that holds that stream, weakly: a
#: stream is held until its engine is released or collected.
_HELD_STREAMS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
#: Streams made outside torch's pool (_create_stream), per device index.
#: None is ever destroyed: a released one serves a later claim.
_OWN_STREAMS: dict = {}
_HELD_LOCK = threading.Lock()


def _draw_stream(device: torch.device):
    """The next stream of torch's pool on `device`, or None off CUDA."""
    if device.type != "cuda":
        return None
    return torch.cuda.Stream(device)


def _create_stream(device: torch.device):
    """A new stream on `device` outside torch's pool: cudaStreamCreate
    through torch's own cudart binding, wrapped as an ExternalStream."""
    handle = ctypes.c_void_p(0)
    with torch.cuda.device(device):
        err = torch.cuda.cudart().cudaStreamCreate(ctypes.addressof(handle))
    if int(err) != 0 or not handle.value:
        raise RuntimeError(f"cudaStreamCreate failed on {device} (error {int(err)})")
    return torch.cuda.ExternalStream(handle.value, device=device)


def _stream_context(stream, device: torch.device):
    """Context that makes `stream` current, and its device with it
    (torch's set_stream does both); nothing off CUDA."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def claim_stream(device: torch.device, holder):
    """A stream of `device` that no live engine holds, now held by
    `holder` (None off CUDA).  torch's pool hands its streams out in
    turn, so once it wraps a plain draw gives a new engine -- a
    restarted bank among them -- the stream of a live one, and a stall
    on either would stall both.  Draws until a free stream comes up;
    once every stream of the pool is held, takes a released stream of
    its own or makes a new one (_create_stream)."""
    with _HELD_LOCK:
        for _ in range(STREAM_POOL_SIZE):
            stream = _draw_stream(device)
            if stream is None:
                return None
            if stream.cuda_stream not in _HELD_STREAMS:
                _HELD_STREAMS[stream.cuda_stream] = holder
                return stream
        own = _OWN_STREAMS.setdefault(device.index, [])
        stream = next((s for s in own if s.cuda_stream not in _HELD_STREAMS), None)
        if stream is None:
            stream = _create_stream(device)
            own.append(stream)
        _HELD_STREAMS[stream.cuda_stream] = holder
        return stream


def _streams_of(holder) -> list:
    """`holder`'s streams: ``_stream`` and, for an engine over several
    cards (parallel.ShardedCounterEngine), its other cards' streams."""
    streams = [getattr(holder, "_stream", None), *getattr(holder, "_more_streams", ())]
    return [s for s in streams if s is not None]


def release_stream(holder) -> None:
    """Give `holder`'s streams back: a later engine may draw them."""
    with _HELD_LOCK:
        for stream in _streams_of(holder):
            if _HELD_STREAMS.get(stream.cuda_stream) is holder:
                del _HELD_STREAMS[stream.cuda_stream]


def stream_idle(holder, lost: bool = False) -> bool:
    """Whether every stream of `holder` has finished all the work queued
    on it (True off CUDA).  A stream whose query fails -- a lost context
    -- answers `lost`: busy by default, so it stays held."""
    for stream in _streams_of(holder):
        try:
            if not stream.query():
                return False
        except Exception:
            if not lost:
                return False
    return True


@dataclass
class HostBatch:
    """Unpadded batch assembled on the host (numpy, batch order)."""

    slots: np.ndarray  # int32
    hits: np.ndarray  # uint32
    limits: np.ndarray  # uint32
    fresh: np.ndarray  # bool
    shadow: np.ndarray  # bool
    # Per-lane window length in seconds; only generic-algorithm models
    # consume it.  None -> dividers of 1 reach the device (inert for
    # warmup probes with hits=0).
    dividers: Optional[np.ndarray] = None  # uint32


@dataclass
class HostDecisions:
    """Device decisions pulled back to host numpy, unpadded."""

    codes: np.ndarray
    limit_remaining: np.ndarray
    befores: np.ndarray
    afters: np.ndarray
    over_limit: np.ndarray
    near_limit: np.ndarray
    within_limit: np.ndarray
    shadow_mode: np.ndarray
    set_local_cache: np.ndarray


def _pick_table_cls(native: Optional[bool]):
    """Slot-table implementation choice: C++ (one FFI call per batch)
    with automatic fallback to the Python oracle."""
    if native is False:
        return SlotTable
    from . import native_slot_table

    if native_slot_table.available():
        return native_slot_table.NativeSlotTable
    if native is True:
        raise RuntimeError("native slot table requested but unavailable")
    return SlotTable


@dataclass
class _Dedup:
    """Host-side duplicate-slot aggregation for one device chunk.

    The slot table hands every same-key lane the same slot; combining
    them before the device step (group totals + per-lane exclusive
    prefixes, Redis-pipeline order) lets the device run the unique-slot
    step (K1) and reproduces per-lane results exactly on readback.
    """

    uniq_slots: np.ndarray  # int32[g] sorted unique slots
    inv: np.ndarray  # intp[count] lane -> group
    totals: np.ndarray  # uint64[g] group hit totals
    prefix: np.ndarray  # uint64[count] exclusive same-slot prefix, batch order
    fresh: np.ndarray  # bool[g] any lane fresh
    limit_max: np.ndarray  # uint32[g] max limit in group (saturation cap)
    divider_max: Optional[np.ndarray] = None  # uint32[g] or None

    def totals_u32(self) -> np.ndarray:
        """Group totals CLAMPED (not wrapped) into the saturating u32
        counter domain the device runs in."""
        return np.minimum(self.totals, 0xFFFFFFFF).astype(np.uint32)


def _dedup_chunk(
    slots: np.ndarray,
    hits: np.ndarray,
    limits: np.ndarray,
    fresh: np.ndarray,
    dividers: Optional[np.ndarray] = None,
) -> _Dedup:
    uniq, inv = np.unique(slots, return_inverse=True)
    inv = inv.reshape(-1)
    g = len(uniq)
    h64 = hits.astype(np.uint64)
    totals = np.zeros(g, dtype=np.uint64)
    np.add.at(totals, inv, h64)
    fresh_g = np.zeros(g, dtype=bool)
    np.logical_or.at(fresh_g, inv, fresh)
    limit_max = np.zeros(g, dtype=np.uint32)
    np.maximum.at(limit_max, inv, limits)
    divider_max = None
    if dividers is not None:
        divider_max = np.zeros(g, dtype=np.uint32)
        np.maximum.at(divider_max, inv, dividers.astype(np.uint32))
    if g == len(slots):  # no duplicates: identity prefixes
        prefix = np.zeros(len(slots), dtype=np.uint64)
    else:
        order = np.argsort(inv, kind="stable")
        inv_s = inv[order]
        h_s = h64[order]
        cs = np.cumsum(h_s) - h_s  # global exclusive prefix
        seg_start = np.empty(len(inv_s), dtype=bool)
        seg_start[0] = True
        seg_start[1:] = inv_s[1:] != inv_s[:-1]
        base = cs[seg_start]  # one per group, group-id order
        prefix = np.empty(len(slots), dtype=np.uint64)
        prefix[order] = cs - base[inv_s]
    return _Dedup(
        uniq_slots=uniq.astype(np.int32),
        inv=inv,
        totals=totals,
        prefix=prefix,
        fresh=fresh_g,
        limit_max=limit_max,
        divider_max=divider_max,
    )


def _decode_keys(blob, lens: np.ndarray) -> List[str]:
    """Split a length-prefixed utf-8 key blob back into strings (the
    Python-table path; the native table never needs this)."""
    if isinstance(blob, np.ndarray):
        blob = blob.tobytes()
    keys = []
    off = 0
    for ln in lens.tolist():
        keys.append(blob[off : off + ln].decode("utf-8"))
        off += ln
    return keys


_NATIVE_DECIDE = None  # resolved on first use: False, or the fn


def _native_decide_fn():
    """The C++ fused decide pass, or None (resolved once)."""
    global _NATIVE_DECIDE
    if _NATIVE_DECIDE is None:
        from . import native_slot_table

        _NATIVE_DECIDE = (
            native_slot_table.decide_reconstruct
            if native_slot_table.available()
            else False
        )
    return _NATIVE_DECIDE or None


def _decide_host(
    afters_padded: np.ndarray,
    hits_u32: np.ndarray,
    limits_u32: np.ndarray,
    shadow: np.ndarray,
    near_ratio: float,
    dedup: Optional["_Dedup"] = None,
) -> HostDecisions:
    """Threshold state machine on host numpy, from device `afters`.

    The device returned one (possibly saturated) `after` per UNIQUE
    slot; per-lane values are rebuilt as
        before_lane = (after_group - group_total) + lane_prefix
    in exact uint64 arithmetic (see the reference's _decide_host for
    the two saturation regimes and why both are decision-exact)."""
    from ..limiter.base import decide_batch

    if dedup is not None:
        native = _native_decide_fn()
        if native is not None:
            from ..api import Code

            g = len(dedup.uniq_slots)
            (
                codes, remaining, befores, afters,
                over, near, within, shadow_d, set_lc,
            ) = native(
                afters_padded[:g],
                dedup.totals,
                dedup.inv,
                dedup.prefix,
                hits_u32,
                limits_u32,
                shadow,
                near_ratio,
                int(Code.OK),
                int(Code.OVER_LIMIT),
            )
            return HostDecisions(
                codes=codes,
                limit_remaining=remaining,
                befores=befores,
                afters=afters,
                over_limit=over,
                near_limit=near,
                within_limit=within,
                shadow_mode=shadow_d,
                set_local_cache=set_lc,
            )

    U32_MAX = np.uint64(0xFFFFFFFF)
    count = len(hits_u32)
    hits = hits_u32.astype(np.int64)
    if dedup is None:  # afters already per-lane (general device path)
        afters = afters_padded[:count].astype(np.int64)
        befores = afters - hits
    else:
        g = len(dedup.uniq_slots)
        afters_g = afters_padded[:g].astype(np.uint64)
        saturated = afters_g >= U32_MAX
        before_g = np.where(
            saturated,
            U32_MAX,
            afters_g - np.minimum(dedup.totals, afters_g),
        )
        befores_u64 = before_g[dedup.inv] + dedup.prefix
        afters_u64 = np.minimum(
            befores_u64 + hits_u32.astype(np.uint64), U32_MAX
        )
        befores = np.minimum(befores_u64, U32_MAX).astype(np.int64)
        afters = afters_u64.astype(np.int64)
    d = decide_batch(
        limits=limits_u32,
        befores=befores,
        afters=afters,
        hits=hits,
        near_ratio=near_ratio,
        shadow_mask=shadow,
        local_cache_mask=np.zeros(count, dtype=bool),
    )
    return HostDecisions(
        codes=d.codes,
        limit_remaining=d.limit_remaining,
        befores=befores,
        afters=afters,
        over_limit=d.over_limit,
        near_limit=d.near_limit,
        within_limit=d.within_limit,
        shadow_mode=d.shadow_mode,
        set_local_cache=d.set_local_cache.astype(bool),
    )


def decide_generic(
    model,
    fetched: np.ndarray,
    hits_u32: np.ndarray,
    limits_u32: np.ndarray,
    shadow: np.ndarray,
    dedup: _Dedup,
    now: int,
) -> HostDecisions:
    """Host half of the generic algorithm protocol: the model rebuilds
    per-lane effective (before, after) counts from its device readback,
    then the SHARED threshold state machine (limiter.base.decide_batch)
    produces codes and stat deltas, so near-limit and partial-hit
    attribution are the same for every algorithm.  Generic algorithms
    never feed the host over-limit cache (their capacity refills
    continuously, so an OVER_LIMIT verdict holds for no full window):
    set_local_cache stays False."""
    from ..limiter.base import decide_batch

    befores, afters = model.lane_counts(fetched, dedup, hits_u32, limits_u32, now)
    count = len(hits_u32)
    d = decide_batch(
        limits=limits_u32,
        befores=befores,
        afters=afters,
        hits=hits_u32.astype(np.int64),
        near_ratio=model.near_ratio,
        shadow_mask=shadow,
        local_cache_mask=np.zeros(count, dtype=bool),
    )
    return HostDecisions(
        codes=d.codes,
        limit_remaining=d.limit_remaining,
        befores=befores,
        afters=afters,
        over_limit=d.over_limit,
        near_limit=d.near_limit,
        within_limit=d.within_limit,
        shadow_mode=d.shadow_mode,
        set_local_cache=np.zeros(count, dtype=bool),
    )


#: Idle stagings an engine keeps for reuse.  The dispatcher has at most
#: TPU_PIPELINE_DEPTH (2 by default) submissions in flight; inline
#: serving (no batch window) has one for each RPC completing on the
#: engine at once, which can be many.  Past the cap the oldest idle
#: staging is dropped: its pinned blocks go back to torch's caching host
#: allocator, to be reused by the next staging made.
STAGING_POOL_CAP = 8


class _Staging:
    """Host buffers of one in-flight submission: `words` int32 of packed
    batch and `nbytes` of readback (pinned on CUDA, so a by-value or
    mapped kernel reaches them through their device aliases), plus the event
    recorded after the last device work of the submission.  A staging
    object returns to the engine's free list only after step_complete
    has waited on its event and copied the readback out: until then a
    kernel or a copy may still be reading its words or writing its
    readback."""

    __slots__ = ("packed", "packed_np", "readback", "event")

    def __init__(self, words: int, nbytes: int, device: torch.device):
        pin = device.type == "cuda"
        self.packed = torch.empty(words, dtype=torch.int32, pin_memory=pin)
        self.packed_np = self.packed.numpy()
        self.readback = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None


class _Phase:
    """The phase stamps of one submission, carried in its token from
    submit_packed to step_complete (see observability/launches.py and
    phases.PHASE_DTYPE).  ``held`` leaves the stamp to the dispatcher, which
    learns the launch seq that joins the two records only from its own
    record; ``fields``, set by step_complete, is then what it stamps
    (stamp_phase)."""

    __slots__ = (
        "record", "bank", "algo", "lanes", "groups", "fresh", "submit_t0", "submit_ns",
        "assign_ns", "stage_ns", "enqueue_ns", "mark", "events", "held", "fields",
    )

    def __init__(self, record, bank: int, algo: int, lanes: int):
        self.record = record
        self.bank = bank
        self.algo = algo
        self.lanes = lanes
        self.stage_ns = self.enqueue_ns = 0
        self.events = []  # (start, end) timing events, one pair a chunk
        self.held = False
        self.fields = None

    def stage_done(self, t: int) -> None:
        """The staging ends at `t` (the chunk's launch begins)."""
        self.stage_ns += t - self.mark  # tpu-lint: disable=shared-state -- a _Phase is one submission's: written by the submitting (owner) thread until its token is handed on, then by the completing thread alone
        self.mark = t  # tpu-lint: disable=shared-state -- same one-submission ownership as stage_ns

    def enqueue_done(self, t: int) -> None:
        """The launch and its event records end at `t`."""
        self.enqueue_ns += t - self.mark  # tpu-lint: disable=shared-state -- same one-submission ownership as stage_ns
        self.mark = t


class _DeviceTimer:
    """Times a chunk's device work with a pair of CUDA timing events
    recorded while a gate holds the stream (csrc/gate.cu): the start
    event, the kernel and the end event, enqueued meanwhile, then run
    back to back, so the pair times the device work and not the host's
    enqueue between the start event and the launch (on a stream idle
    between chunks, an ungated start event completes as soon as it is
    recorded).  ``open`` enqueues a wait for the pinned host word to
    reach a new ticket (cuStreamWaitValue32) and records the start
    event, ``close`` records the end event and writes the ticket: one C
    call each.  The gate is first tried on a stream of its own
    (``_probe``): only one seen to hold and then to let go ever holds an
    engine's stream.  Where the driver has no such wait, the probe fails
    or a call fails, no chunk is timed (``works`` False): an ungated pair
    would time the host's enqueue, so device_ns stays 0 (unknown) rather
    than read that.  Event pairs are the engine's (``pairs``, freed with
    it)."""

    #: Seconds the probe waits for a released stream to run on.
    PROBE_S = 1.0
    #: cudaErrorNotReady: an event not yet done.
    NOT_READY = 600

    def __init__(self, device: torch.device, pairs: Deque[tuple]):
        from .. import kernels

        self.tickets = itertools.count(1)
        self.works = False
        try:
            with kernels.on_device(device):
                self.word = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            self.alias = kernels.mapped_alias(self.word.data_ptr())
            self._open = kernels.function("rl_gate_open")
            self._close = kernels.function("rl_gate_close")
            self._elapsed = kernels.function("rl_elapsed_ns")
            self._query = kernels.function("rl_event_query")
            self._make = kernels.function("rl_timing_pair")
            weakref.finalize(self, _free_pairs, pairs, kernels.function("rl_timing_free"))
            self.works = self._probe(device)
        except Exception:
            logger.exception("device timing unavailable: phase records keep device_ns 0")

    def pair(self) -> tuple:
        """A new (start, end) pair of timing events, as raw handles."""
        start, end = ctypes.c_void_p(), ctypes.c_void_p()
        rc = self._make(ctypes.byref(start), ctypes.byref(end))
        if rc != 0:
            raise RuntimeError(f"cudaEventCreate failed (error {rc})")
        return start.value, end.value

    def open(self, stream, start: int) -> int:
        """Hold `stream` and record `start` on it; returns the ticket
        ``close`` lets it go with."""
        ticket = next(self.tickets) & 0x7FFFFFFF or 1
        self._check(self._open(stream.cuda_stream, self.alias, ticket, start))
        return ticket

    def close(self, stream, end: int, ticket: int) -> None:
        """Record `end` on `stream` and let it go (its ticket)."""
        self._check(self._close(stream.cuda_stream, end, self.word.data_ptr(), ticket))

    def _check(self, rc: int) -> None:
        """Stop timing after a failed call (`rc`, a CUDA error)."""
        if rc != 0:
            self.works = False  # tpu-lint: disable=shared-state -- the timer is touched only by the engine's submitting (owner) thread
            logger.warning("device timing failed (error %d): phase records keep device_ns 0", rc)

    def elapsed_ns(self, start: int, end: int) -> int:
        """Device ns between two completed events (0 where unknown)."""
        ns = ctypes.c_longlong(0)
        return ns.value if self._elapsed(start, end, ctypes.addressof(ns)) == 0 else 0

    def _probe(self, device: torch.device) -> bool:
        """Whether the start event behind the gate waits while it holds,
        and the end event runs once it lets go, on a stream made for the
        probe (left behind where the release never arrives)."""
        stream = _create_stream(device)
        start, end = self.pair()
        ticket = next(self.tickets)
        rc = self._open(stream.cuda_stream, self.alias, ticket, start)
        held = rc == 0 and self._query(start) == self.NOT_READY
        self._close(stream.cuda_stream, end, self.word.data_ptr(), ticket)
        deadline = time.monotonic() + self.PROBE_S
        while self._query(end) != 0:
            if time.monotonic() > deadline:
                logger.warning("stream gate never let go: phase records keep device_ns 0")
                return False
            time.sleep(1e-4)
        if not held:
            logger.warning("stream gate did not hold: phase records keep device_ns 0")
        return held


def _free_pairs(pairs: Deque[tuple], free) -> None:
    """Destroy an engine's idle timing event pairs."""
    while pairs:
        free(*pairs.pop())


def stamp_phase(ph: _Phase, launch: int) -> None:
    """Stamp `ph`'s record (step_complete's ``fields``) joined to the
    launch record `launch` (0: none).  A recorder that raises, or has
    no phase ring, loses the record and nothing else."""
    try:
        ph.record(launch, *ph.fields)
    except Exception:
        logger.exception("phase record dropped")


class CounterEngine:
    def __init__(
        self,
        num_slots: int = 1 << 20,
        near_ratio: float = 0.8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device="cuda",
        model=None,
        native_table: Optional[bool] = None,
    ):
        """`device` defaults to the GPU and raises there when CUDA is
        absent; only device="cpu" runs the plain versions.  `model`
        defaults to a FixedWindowModel on that device.  A model must
        provide EITHER the saturating unique-slot serving step in the two
        forms the engine serves from its staging (by value,
        step_counters_unique_lanes, and mapped,
        step_counters_unique_mapped) OR the generic algorithm
        protocol: the serving step by value, ``step_serve_lanes(state,
        words, now, out)``, and mapped, ``step_serve_mapped(state,
        words, now, out)``, and ``readback_shape(n)`` on the device,
        plus ``lane_counts(out, dedup, hits, limits, now)`` on the
        host.  A subclass that
        overrides ``_device_submit`` brings its own device step
        (parallel.ShardedCounterEngine).
        `native_table`: None = use the C++ slot table when
        it builds/loads, True = require it, False = pure Python;
        generic models with stable-stem keys (windowed_keys=False)
        always get the Python table with refresh-on-touch expiry."""
        self.device = resolve_device(device)
        self.model = (
            model
            if model is not None
            else FixedWindowModel(num_slots, near_ratio, device=self.device)
        )
        # Generic algorithm protocol marker: the model owns both the
        # device step and the host lane reconstruction.
        self._generic = hasattr(self.model, "lane_counts")
        needs = (
            ("step_serve_lanes", "step_serve_mapped", "readback_shape")
            if self._generic
            else ("step_counters_unique_lanes", "step_counters_unique_mapped")
        )
        if type(self)._device_submit is CounterEngine._device_submit and not all(
            hasattr(self.model, name) for name in needs
        ):
            raise TypeError(
                "model must provide the saturating unique-slot serving "
                "step (step_counters_unique_lanes and "
                "step_counters_unique_mapped) or the generic protocol "
                "(step_serve_lanes, step_serve_mapped, readback_shape and "
                "lane_counts); for mesh models use "
                "parallel.ShardedCounterEngine"
            )
        if self.model.device != self.device:
            raise ValueError(
                f"model is on {self.model.device}, engine on {self.device}"
            )
        if self._generic and not getattr(self.model, "windowed_keys", True):
            # Stable-stem keys: refresh-on-touch expiry keeps a hot
            # key's slot -- and the window/TAT state it carries -- alive
            # instead of reclaiming it `divider` seconds after first
            # sight.
            self._table_cls = functools.partial(SlotTable, refresh_expiry=True)
        else:
            self._table_cls = _pick_table_cls(native_table)
        self.slot_table = self._table_cls(self.model.num_slots)
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self._stream = claim_stream(self.device, self)
        self._free_staging: Deque[_Staging] = deque(maxlen=STAGING_POOL_CAP)
        self._counts = self._fresh_state()
        # Gauge snapshots, written only by the thread that owns the
        # slot table (the dispatcher collector) and read lock-free.
        self.stat_live_keys = 0
        self.stat_evictions = 0
        self.stat_dedup_groups = 0
        self.stat_window_rollovers = 0
        # The slot table's sweeps (gc): the last one's monotonic ns and
        # keys freed, and how many have run.
        self.stat_gc_ns = 0
        self.stat_gc_freed = 0
        self.stat_gc_sweeps = 0
        # The native slot table's own counters (stamp_table_stats): its
        # assign lookups and probe cells, rehashes and their ns, and the
        # host index's bytes; 0 on the Python table.
        self.stat_lookups = 0
        self.stat_probes = 0
        self.stat_rehashes = 0
        self.stat_rehash_ns = 0
        self.stat_index_bytes = 0
        # The last checkpoint restore (checkpoint.restore_engine): its ns,
        # split into the file's read, import_state and the slot table,
        # and the live keys it restored.
        self.stat_restore_ns = 0
        self.stat_restore_read_ns = 0
        self.stat_restore_state_ns = 0
        self.stat_restore_table_ns = 0
        self.stat_restore_keys = 0
        # Launch recorder for phase records (attach_launch_recorder);
        # None = detached.  _ph is the submission being launched (the
        # submitting thread's), _timer and _timing (its idle event
        # pairs) serve the device timing on CUDA.
        self._phases = None
        self._phase_bank = 0
        self._phase_algo = 0
        self._ph: Optional[_Phase] = None
        self._timer: Optional[_DeviceTimer] = None
        self._timing: Deque[tuple] = deque()

    def attach_launch_recorder(self, recorder, bank: int = 0, algo: Optional[int] = None) -> None:
        """Stamp a phase record of every later submission into
        `recorder` (observability/launches.py) under `bank` and `algo`
        (the model's registry id by default); None detaches.  A
        submission already in flight keeps the recorder it started with."""
        if algo is None:
            from ..models.registry import ALGORITHMS

            name = self.algorithm
            algo = ALGORITHMS[name].algo_id if name in ALGORITHMS else 0
        self._phase_bank = int(bank)
        self._phase_algo = int(algo)
        self._phases = recorder

    def _on_stream(self):
        """Context that puts this thread's work on the engine stream.
        Every copy out of the table runs there too, ordered after the
        engine's own kernels: nothing of an engine waits on the whole
        device or on another engine's stream, so a stream stalled by one
        bank cannot hold up the restart of another."""
        return _stream_context(self._stream, self.device)

    def _fresh_state(self):
        """A fresh table, made on the engine stream."""
        with self._on_stream():
            return self.model.init_state()

    def give_back_stream(self) -> None:
        """release_stream of this engine.  An engine proxy
        (cluster/faults.py) delegates the call, so the stream goes back
        from the engine that claimed it."""
        release_stream(self)

    # -- host-side key handling -----------------------------------------

    def warmup_probe_slots(self, bucket: int) -> np.ndarray:
        """`bucket` distinct in-table slots (the worst-case shape)."""
        ns = self.model.num_slots
        return (np.arange(bucket, dtype=np.int64) % ns).astype(np.int32)

    def assign_slot(self, key: str, now: int, expiry: int):
        """The slot table's assign: (slot, fresh) for `key`."""
        return self.slot_table.assign(key, now, expiry)

    def gc(self, now: int) -> int:
        """Sweep the slot table of keys expired at `now`; returns how
        many it freed, and stamps the sweep's time and count."""
        t0 = time.monotonic_ns()
        freed = self.slot_table.gc(now)
        self.stat_gc_ns = time.monotonic_ns() - t0  # tpu-lint: disable=shared-state -- collector-owned engine
        self.stat_gc_freed = freed  # tpu-lint: disable=shared-state -- collector-owned engine
        self.stat_gc_sweeps += 1  # tpu-lint: disable=shared-state -- collector-owned engine
        return freed

    def reset(self) -> None:
        """Drop all counters and key assignments: the model's fresh state
        (every state row of an algorithm bank), made on the engine's
        streams by ``_fresh_state``, and an empty slot table.  Needs
        exclusive access to the engine (``cache.run_exclusive``, or a
        thread that owns it), as every slot-table touch.  Nothing here
        waits for the card: the zeroing is enqueued behind the engine's
        earlier work, so a fault domain never sees it as a device call."""
        self._counts = self._fresh_state()  # tpu-lint: disable=shared-state -- reset() is an exclusive-access hook; serving never races it
        self.slot_table = self._table_cls(self.model.num_slots)  # tpu-lint: disable=shared-state -- same exclusive-access contract

    # -- device step ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def step(self, batch: HostBatch, now: int = 0) -> HostDecisions:
        """Run one padded device step per <=max_batch chunk."""
        return self.step_complete(self.step_submit(batch, now))

    def hold_phase(self, token) -> Optional[_Phase]:
        """The phase stamps a submission's token carries (None where no
        recorder was attached), now held: step_complete leaves the stamp
        to the caller, who gives stamp_phase the launch seq to join."""
        ph = token[5]
        if ph is not None:
            ph.held = True
        return ph

    def step_submit(self, batch: HostBatch, now: int = 0):
        """Launch the device work for `batch` WITHOUT waiting for the
        readback; returns an opaque token for step_complete.  Takes
        pre-assigned slots (warmup, tests); the serving path is
        `submit_packed`.  Must be called from the thread that owns this
        engine."""
        n = len(batch.slots)
        chunks = []
        for start in range(0, n, self.max_batch):
            count = min(n - start, self.max_batch)
            end = start + count
            dedup = _dedup_chunk(
                batch.slots[start:end],
                batch.hits[start:end],
                batch.limits[start:end],
                batch.fresh[start:end],
                None if batch.dividers is None else batch.dividers[start:end],
            )
            handle, reassemble = self._device_submit(dedup, now)
            chunks.append((handle, start, count, dedup, reassemble))
            self.stat_window_rollovers += int(np.count_nonzero(dedup.fresh))  # tpu-lint: disable=shared-state -- collector-owned engine
        self.stat_live_keys = len(self.slot_table)  # tpu-lint: disable=shared-state -- collector-owned engine
        self.stat_evictions = self.slot_table.evictions  # tpu-lint: disable=shared-state -- collector-owned engine
        stamp_table_stats(self, self.slot_table)
        self.stat_dedup_groups = sum(len(c[3].uniq_slots) for c in chunks)  # tpu-lint: disable=shared-state -- collector-owned engine
        return (batch.hits, batch.limits, batch.shadow, chunks, now, None)

    def submit_packed(self, now: int, key_blob, meta: np.ndarray):
        """Serving fast path: assign slots AND dedup in one native call
        per chunk, then launch the device step (no wait).  Keys arrive
        as a length-prefixed utf-8 blob and per-lane scalars as one
        LANE_DTYPE record array (see dispatcher.LanePack).  Returns
        the same token shape as step_submit."""
        recorder = self._phases
        if recorder is not None:
            return self._submit_recorded(recorder, now, key_blob, meta)
        hits, limits, shadow, dedups = self._assign_dedup(now, key_blob, meta)
        return self._launch_chunks(hits, limits, shadow, dedups, now, None)

    def _submit_recorded(self, recorder, now: int, key_blob, meta: np.ndarray):
        """submit_packed with its phases stamped: assign [t0, t1), then
        each chunk's staging and launch (marked in _serve_on), then the
        gauges until the return."""
        clock = time.monotonic_ns
        t0 = clock()
        hits, limits, shadow, dedups = self._assign_dedup(now, key_blob, meta)
        ph = _Phase(getattr(recorder, "record_phase", None), self._phase_bank,
                    self._phase_algo, len(meta))
        ph.mark = t1 = clock()
        before = self.stat_window_rollovers
        self._ph = ph  # tpu-lint: disable=shared-state -- set and cleared by the engine's submitting (owner) thread around its own launch
        try:
            token = self._launch_chunks(hits, limits, shadow, dedups, now, ph)
        finally:
            self._ph = None
        ph.groups = self.stat_dedup_groups
        ph.fresh = self.stat_window_rollovers - before
        ph.submit_t0 = t0
        ph.assign_ns = t1 - t0
        ph.submit_ns = clock() - t0
        return token

    def _assign_dedup(self, now: int, key_blob, meta: np.ndarray):
        """submit_packed's first phase: every chunk's slots assigned and
        deduped.  Returns (hits, limits, shadow, [(start, count,
        _Dedup)])."""
        n = len(meta)
        key_lens = meta["len"].astype(np.int64)
        expiries = np.ascontiguousarray(meta["expiry"])
        hits = np.ascontiguousarray(meta["hits"])
        limits = np.ascontiguousarray(meta["limits"])
        shadow = meta["shadow"].astype(bool)
        # Generic models need per-lane window lengths on the device;
        # the fixed-window paths never read them.
        dividers = np.ascontiguousarray(meta["divider"]) if self._generic else None
        table = self.slot_table
        fused = hasattr(table, "assign_dedup_packed")
        blob_arr = (
            np.frombuffer(key_blob, dtype=np.uint8)
            if isinstance(key_blob, (bytes, bytearray))
            else key_blob
        )
        # Chunks of one submission share pin scope: a key assigned in
        # chunk 1 must never be evicted for a chunk-2 lane.
        multi_fused = fused and n > self.max_batch
        if multi_fused:
            offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(key_lens, out=offs[1:])
            table.begin_batch()
        # Phase 1 -- assign + dedup EVERY chunk before any device
        # launch: slot-table exhaustion must error the batch before a
        # single hit is committed to the counters.
        dedups: List[tuple] = []
        try:
            if fused:
                for start in range(0, n, self.max_batch):
                    count = min(n - start, self.max_batch)
                    end = start + count
                    bl = (
                        blob_arr[offs[start] : offs[end]]
                        if multi_fused
                        else blob_arr
                    )
                    inv, uniq, totals, prefix, freshg, limitmax = (
                        table.assign_dedup_packed(
                            bl,
                            key_lens[start:end],
                            now,
                            expiries[start:end],
                            hits[start:end],
                            limits[start:end],
                        )
                    )
                    dedup = _Dedup(
                        uniq_slots=uniq,
                        inv=inv,
                        totals=totals,
                        prefix=prefix,
                        fresh=freshg,
                        limit_max=limitmax,
                    )
                    dedups.append((start, count, dedup))
            else:
                keys = _decode_keys(key_blob, key_lens)
                slots64, fresh = table.assign_batch(keys, now, expiries)
                slots = slots64.astype(np.int32)
                for start in range(0, n, self.max_batch):
                    count = min(n - start, self.max_batch)
                    end = start + count
                    dedup = _dedup_chunk(
                        slots[start:end],
                        hits[start:end],
                        limits[start:end],
                        fresh[start:end],
                        None if dividers is None else dividers[start:end],
                    )
                    dedups.append((start, count, dedup))
        finally:
            if multi_fused:
                table.end_batch()
        return hits, limits, shadow, dedups

    def _launch_chunks(self, hits, limits, shadow, dedups, now: int, ph):
        """submit_packed's second phase: launch the device step per
        chunk; returns the token, which carries `ph` (the phase stamps,
        or None) to step_complete."""
        chunks = []
        for start, count, dedup in dedups:
            handle, reassemble = self._device_submit(dedup, now)
            chunks.append((handle, start, count, dedup, reassemble))
            self.stat_window_rollovers += int(np.count_nonzero(dedup.fresh))
        table = self.slot_table
        self.stat_live_keys = len(table)
        self.stat_evictions = table.evictions
        stamp_table_stats(self, table)
        self.stat_dedup_groups = sum(len(d.uniq_slots) for _, _, d in dedups)
        return (hits, limits, shadow, chunks, now, ph)

    def step_complete(self, token) -> HostDecisions:
        """Wait for the readback of a step_submit token and run the
        host threshold state machine.  Touches no engine state but the
        staging and timing-event free lists (GIL-atomic appends), so any
        thread may call it."""
        ph = token[5]
        if ph is not None:
            return self._complete_recorded(ph, token)
        return self._decide_chunks(token)

    def _complete_recorded(self, ph: _Phase, token) -> HostDecisions:
        """step_complete with its phases stamped: the wait on every
        chunk's event [c0, c1), then the readback copy and the decide;
        the device time is read from the chunks' timing events once they
        have completed, and is 0 (unknown) unless every chunk was timed.
        Stamped here unless the dispatcher holds the record
        (``ph.held``); a recorder that raises loses the record, never the
        chunk."""
        clock = time.monotonic_ns
        c0 = clock()
        chunks = token[3]
        for chunk in chunks:
            self._wait_handle(chunk[0])
        c1 = clock()
        device_ns = 0
        timed = len(ph.events) == len(chunks)
        for pair in ph.events:
            ns = self._timer.elapsed_ns(*pair)
            timed = timed and ns > 0
            device_ns += ns
            self._timing.append(pair)  # tpu-lint: disable=shared-state -- GIL-atomic deque append (complete side) against pop (submit side, EAFP) once the pair's elapsed time is read
        if not timed:
            device_ns = 0
        out = self._decide_chunks(token)
        c2 = clock()
        ph.fields = (
            ph.bank, ph.algo, ph.lanes, ph.groups, ph.fresh,
            ph.submit_t0, ph.submit_ns, ph.assign_ns, ph.stage_ns, ph.enqueue_ns,
            c0, c2 - c0, c1 - c0, c2 - c1, device_ns,
        )
        if not ph.held:
            stamp_phase(ph, 0)
        return out

    def _decide_chunks(self, token) -> HostDecisions:
        hits, limits, shadow, chunks, now, _ph = token
        if not chunks:
            empty = np.zeros(0, dtype=np.int32)
            return HostDecisions(*([empty] * 8), empty.astype(bool))
        outs: List[HostDecisions] = []
        for handle, start, count, dedup, reassemble in chunks:
            fetched = self._fetch(handle)
            if reassemble is not None:
                fetched = reassemble(fetched)
            end = start + count
            if self._generic:
                outs.append(
                    decide_generic(
                        self.model,
                        fetched,
                        hits[start:end],
                        limits[start:end],
                        shadow[start:end],
                        dedup,
                        now,
                    )
                )
                continue
            outs.append(
                _decide_host(
                    fetched,
                    hits[start:end],
                    limits[start:end],
                    shadow[start:end],
                    self.model.near_ratio,
                    dedup,
                )
            )
        if len(outs) == 1:
            return outs[0]
        return HostDecisions(
            *(
                np.concatenate([getattr(o, f) for o in outs])
                for f in HostDecisions.__dataclass_fields__
            )
        )

    def _staging_size(self):
        """(int32 words uploaded, bytes read back) that one submission
        can need at most.  Fixed window: int32[4, N] up, <= 4 B per lane
        back; generic models upload a fifth (divider) row and read back
        up to 8 B per lane (sliding window: u32[2, N])."""
        rows, out_bytes = (5, 8) if self._generic else (4, 4)
        return rows * self.max_batch, out_bytes * self.max_batch

    def _take_staging(self) -> _Staging:
        try:
            return self._free_staging.pop()  # tpu-lint: disable=shared-state -- GIL-atomic deque pop (submit side, EAFP: an empty pool makes a new staging) against append (complete side) after the event wait: a staging re-enters the pool only once its readback is copied out
        except IndexError:
            return _Staging(*self._staging_size(), self.device)

    def _fetch(self, handle) -> np.ndarray:
        """Wait for one submission's readback; copy it out and recycle
        its staging buffers (the pool keeps STAGING_POOL_CAP at most)."""
        st, readback = handle
        self._wait(st)
        out = readback.numpy().view(_HOST_VIEW[readback.dtype]).copy()
        self._free_staging.append(st)
        return out

    def _wait_handle(self, handle) -> None:
        """Wait for every event of one chunk's handle (_fetch's wait)."""
        self._wait(handle[0])

    @staticmethod
    def _wait(st: _Staging) -> None:
        """Wait for `st`'s event: the device work that writes its readback."""
        if st.event is not None:
            st.event.synchronize()  # tpu-lint: disable=torch-host-sync -- the wait for this submission's own readback: it runs on the dispatcher's completer thread, or with no batch window on the RPC's thread after the bank's lock is released, under no lock, and each RPC waits on its own item event bounded by KERNEL_DEADLINE_S

    def _device_submit(self, dedup: _Dedup, now: int):
        """Launch the device step for one deduped chunk; returns the
        handle step_complete waits on and the function that turns its
        readback into one value per unique slot (None: the readback is
        that already)."""
        g = len(dedup.uniq_slots)
        padded = self._bucket(g)
        ns = self.model.num_slots
        if self._generic:
            return self._device_submit_generic(dedup, now, g, padded, ns)
        # Dtype choice uses the UNWRAPPED uint64 totals; totals past
        # u32 max are CLAMPED for the device (not wrapped), matching
        # the saturating counter arithmetic.
        cap = int(dedup.totals.max(initial=0)) + int(
            dedup.limit_max.max(initial=1)
        )
        dt = "uint8" if cap <= 0xFF else ("uint16" if cap <= 0xFFFF else "")

        # ONE packed int32[4, padded] batch.  Rows: slots, hits (u32
        # bits), limits (u32 bits), fresh.  Padding uses DISTINCT
        # out-of-table slots (num_slots + i), which K1 leaves inert.
        st = self._take_staging()
        pk = st.packed_np[: 4 * padded].reshape(4, padded)
        pk[0, :g] = dedup.uniq_slots
        pk[1, :g] = dedup.totals_u32().view(np.int32)
        pk[2, :g] = dedup.limit_max.view(np.int32)
        pk[3, :g] = dedup.fresh
        if padded > g:
            pk[0, g:] = np.arange(ns, ns + (padded - g), dtype=np.int64)
            pk[1, g:] = 0
            pk[2, g:] = 1
            pk[3, g:] = 0
        m = self.model
        handle = self._serve(
            st,
            st.packed[: 4 * padded].view(4, padded),
            OUT_DTYPES[dt],
            (padded,),
            lambda counts, words, out: m.step_counters_unique_lanes(counts, dt, words, out),
            lambda counts, words, out: m.step_counters_unique_mapped(counts, dt, words, out),
        )
        return handle, None

    def _serve(
        self,
        st: _Staging,
        host: torch.Tensor,
        dtype: torch.dtype,
        shape,
        lanes_step,
        wide_step,
    ):
        """Run a serving step on the engine's table (_serve_on) and return
        the handle (st, readback) for _fetch."""
        self._counts, handle = self._serve_on(
            self._stream, self._counts, st, host, dtype, shape, lanes_step, wide_step
        )
        return handle

    def _serve_on(self, stream, counts, st: _Staging, host: torch.Tensor,
                  dtype: torch.dtype, shape, lanes_step, wide_step):
        """Run a serving step on the table `counts` on `stream` (and its
        device) over the packed batch `host` (int32[..., rows, padded], a
        view of `st.packed`) whose readback is dtype[shape], a view of
        `st.readback`.  The batch's shape alone picks the step
        (lanes_by_value): `lanes_step(counts, host, out)` up to 128 lanes,
        `wide_step(counts, host, out)` past it; each returns (counts,
        readback).  `st`'s event is recorded on `stream` after the last of
        it.  Returns (counts, the handle (st, readback) for _fetch).
        While a submission with a recorder attached is launched
        (``_ph``), the staging ends at entry and the launch at return,
        and on CUDA the step is timed (_step_timed)."""
        ph = self._ph
        if ph is not None:
            ph.stage_done(time.monotonic_ns())
        rows, padded = host.shape[-2:]
        with _stream_context(stream, counts.device):
            nbytes = math.prod(shape) * dtype.itemsize
            out = st.readback[:nbytes].view(dtype).view(shape)
            by_value = lanes_by_value(host.numel() // (rows * padded), padded)
            step = lanes_step if by_value else wide_step
            if ph is None or st.event is None:
                counts, readback = step(counts, host, out)
            else:
                counts, readback = self._step_timed(ph, stream, step, counts, host, out)
            if st.event is not None:
                st.event.record(stream)
        if ph is not None:
            ph.enqueue_done(time.monotonic_ns())
        return counts, (st, readback)

    def _step_timed(self, ph: _Phase, stream, step, counts, host: torch.Tensor, out):
        """`step(counts, host, out)` between a pair of timing events,
        enqueued while the gate holds `stream` (_DeviceTimer); the pair
        joins the submission's ``events``.  Untimed where the timer does
        not work."""
        timer = self._device_timer(counts.device)
        if not timer.works:
            return step(counts, host, out)
        pair = self._timing_pair(timer)
        ticket = timer.open(stream, pair[0])
        try:
            result = step(counts, host, out)
        finally:
            timer.close(stream, pair[1], ticket)
        ph.events.append(pair)
        return result

    def _device_timer(self, device: torch.device) -> _DeviceTimer:
        """The engine's device timer, made on first use."""
        if self._timer is None:
            self._timer = _DeviceTimer(device, self._timing)  # tpu-lint: disable=shared-state -- made lazily by the engine's submitting (owner) thread
        return self._timer

    def _timing_pair(self, timer: _DeviceTimer) -> tuple:
        """An idle (start, end) pair of timing events."""
        try:
            return self._timing.pop()  # tpu-lint: disable=shared-state -- GIL-atomic deque pop (submit side, EAFP) against append (complete side) once the pair's elapsed time is read
        except IndexError:
            return timer.pair()

    def _device_submit_generic(self, dedup: _Dedup, now: int, g: int, padded: int, ns: int):
        """Generic algorithm path: ONE int32[5, padded] batch -- rows
        slots, hits bits, limits bits, fresh, divider bits -- plus the
        batch clock, served in the form its shape picks (_serve); the
        model owns the state layout, the kernel and the host
        reconstruction.  Padding uses DISTINCT out-of-table slots with
        divider 1, limit 1 and hits 0, so pad lanes are inert."""
        st = self._take_staging()
        pk = st.packed_np[: 5 * padded].reshape(5, padded)
        pk[0, :g] = dedup.uniq_slots
        pk[1, :g] = dedup.totals_u32().view(np.int32)
        pk[2, :g] = dedup.limit_max.view(np.int32)
        pk[3, :g] = dedup.fresh
        if dedup.divider_max is not None:
            pk[4, :g] = dedup.divider_max.view(np.int32)
        else:
            pk[4, :g] = 1
        if padded > g:
            pk[0, g:] = np.arange(ns, ns + (padded - g), dtype=np.int64)
            pk[1, g:] = 0
            pk[2, g:] = 1
            pk[3, g:] = 0
            pk[4, g:] = 1
        m = self.model
        handle = self._serve(
            st,
            st.packed[: 5 * padded].view(5, padded),
            torch.int32,
            m.readback_shape(padded),
            lambda state, words, out: m.step_serve_lanes(state, words, now, out),
            lambda state, words, out: m.step_serve_mapped(state, words, now, out),
        )
        return handle, None

    # -- checkpoint surface ---------------------------------------------

    @property
    def algorithm(self) -> str:
        """The model's algorithm-table name (models/registry.py), so a
        restore can never feed one kernel's state rows to another."""
        return getattr(self.model, "algo", "fixed_window")

    def export_state(self) -> dict:
        """Named copy of the per-slot device state, the reference's
        contract: fixed-window ``{"counts": uint32[num_slots]}``;
        generic models one uint32[num_slots] row per
        ``model.state_rows`` name."""
        rows = getattr(self.model, "state_rows", ("counts",))
        if rows == ("counts",):
            return {"counts": self.export_counts()}
        with self._on_stream():
            arr = state_to_numpy(self._counts)
        return {name: arr[i].copy() for i, name in enumerate(rows)}

    def import_state(self, state: dict) -> None:
        """Inverse of export_state; validates names and shapes."""
        rows = getattr(self.model, "state_rows", ("counts",))
        if set(state) != set(rows):
            raise ValueError(
                f"{self.algorithm} state has rows {list(rows)}, got {sorted(state)}"
            )
        if rows == ("counts",):
            self.import_counts(state["counts"])
            return
        ns = self.model.num_slots
        stacked = np.empty((len(rows), ns), dtype=np.uint32)
        for i, name in enumerate(rows):
            arr = np.asarray(state[name], dtype=np.uint32).reshape(-1)
            if arr.shape[0] != ns:
                raise ValueError(
                    f"state row {name!r} size {arr.shape[0]} != num_slots {ns}"
                )
            stacked[i] = arr
        with self._on_stream():
            self._counts = state_from_numpy(stacked, self.device)  # tpu-lint: disable=shared-state -- rebinding the state is an exclusive-access hook: restore and handoff run it through run_exclusive on the bank's owner thread, the restart merge on a new engine before it is swapped in

    # -- live key export/import (the fault domain's restart merge) -------

    def export_keys(self, pred, drop: bool = True):
        """Export the live keys matching ``pred(key) -> bool``: returns
        ``(state, entries)`` where ``state`` holds one column-subset
        array per export_state row (column i is key i's per-slot state)
        and ``entries`` is ``[(key, expiry), ...]``.  With ``drop`` (the
        default) the exported keys leave THIS engine -- their slots are
        zeroed and released -- so a key that comes back later can never
        resurrect stale state.

        Must run with exclusive engine access (the dispatcher thread),
        like every slot-table touch."""
        ents = self.slot_table.entries()
        sel = [(k, s, e) for k, s, e in ents if pred(k)]
        state = {
            name: np.array(arr, copy=True)
            for name, arr in self.export_state().items()
        }
        if not sel:
            return {name: arr[:0].copy() for name, arr in state.items()}, []
        idx = np.array([s for _, s, _ in sel], dtype=np.int64)
        out = {name: arr[idx].copy() for name, arr in state.items()}
        if drop:
            for arr in state.values():
                arr[idx] = 0
            self.import_state(state)
            keep = [(k, s, e) for k, s, e in ents if not pred(k)]
            table_cls = type(self.slot_table)
            if getattr(self.slot_table, "refresh_expiry", False):
                self.slot_table = table_cls.from_entries(
                    self.model.num_slots, keep, refresh_expiry=True
                )
            else:
                self.slot_table = table_cls.from_entries(self.model.num_slots, keep)
        return out, [(k, e) for k, _s, e in sel]

    def import_keys(self, state: dict, entries, now: int) -> dict:
        """Inverse of export_keys, into THIS engine's table: assign a
        local slot per key and land its state columns.  A key already
        live here MERGES instead of overwriting: fixed-window ``counts``
        add (saturating: both sides counted disjoint hits), every other
        row takes the element-wise max (GCRA's later TAT, sliding
        window's newer window: the stricter side -- a merge may briefly
        over-deny, never over-admit).  Entries whose lease already
        expired at ``now`` are dropped.  Returns {imported, merged,
        dropped}.

        Must run with exclusive engine access (the dispatcher thread)."""
        res = {"imported": 0, "merged": 0, "dropped": 0}
        if not entries:
            return res
        full = {
            name: np.array(arr, copy=True)
            for name, arr in self.export_state().items()
        }
        for i, (key, expiry) in enumerate(entries):
            if int(expiry) <= now:
                res["dropped"] += 1
                continue
            slot, fresh = self.slot_table.assign(key, now, int(expiry))
            for name, arr in full.items():
                col = state[name][i]
                if fresh:
                    arr[slot] = col
                elif name == "counts":
                    arr[slot] = min(int(arr[slot]) + int(col), 0xFFFFFFFF)
                else:
                    arr[slot] = max(arr[slot], col)
            res["imported" if fresh else "merged"] += 1
        self.import_state(full)
        return res

    # -- the handoff's short legs (cluster/handoff.py) -------------------

    def _slot_index(self, slots):
        """Index into the state tensor of every state row at `slots`
        (a fixed-window table has one row, an algorithm table one per
        state_rows name)."""
        idx = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int64))
        return (Ellipsis, idx.to(self.device))

    def read_slots(self, slots) -> dict:
        """The state rows at `slots` as uint32 columns, by row name."""
        rows = getattr(self.model, "state_rows", ("counts",))
        with self._on_stream():
            got = state_to_numpy(self._counts[self._slot_index(slots)])
        if rows == ("counts",):
            return {"counts": got.reshape(-1)}
        return {name: got[i] for i, name in enumerate(rows)}

    def write_slots(self, slots, state: dict) -> None:
        """Set the state rows at `slots` to the uint32 columns of
        `state` (one per state_rows name)."""
        rows = getattr(self.model, "state_rows", ("counts",))
        vals = np.stack([np.asarray(state[name], dtype=np.uint32) for name in rows])
        if rows == ("counts",):
            vals = vals[0]
        host = torch.from_numpy(np.ascontiguousarray(vals).view(np.int32))
        with self._on_stream():
            self._counts[self._slot_index(slots)] = host.to(self.device)

    def release_keys(self, moved: EntryArrays) -> int:
        """The second leg of a handoff export: release each entry of
        `moved` (EntryArrays built off the owner thread) that the slot
        table still holds as given and zero its state, by slot id.  A
        slot that gc gave to another key since the copy is left alone.
        Returns how many keys left.

        Must run with exclusive engine access, and is short: one probe a
        moved key (a C call for the C table), a scatter of zeros to the
        freed slots, no pass over the whole table and no copy of the
        state."""
        freed = self.slot_table.release_arrays(moved)
        if len(freed):
            rows = getattr(self.model, "state_rows", ("counts",))
            zero = np.zeros(len(freed), dtype=np.uint32)
            self.write_slots(freed, {name: zero for name in rows})
        return int(len(freed))

    def land_keys(self, keys, expiries, state: dict, now: int) -> dict:
        """The exclusive leg of a handoff import: assign a slot per key
        in one batch and land its state columns, merging as import_keys
        does (fixed-window ``counts`` add saturating, other rows take
        the max), with a gather and a scatter of the touched slots
        only.  Entries must be live at `now` (the caller drops expired
        ones off the owner thread).  Returns {imported, merged}."""
        n = len(keys)
        if not n:
            return {"imported": 0, "merged": 0}
        exp = np.asarray(expiries, dtype=np.int64)
        slots, fresh = self.slot_table.assign_batch(list(keys), now, exp.tolist())
        slots = np.asarray(slots, dtype=np.int64)
        fresh = np.asarray(fresh, dtype=bool)
        uniq, inv = np.unique(slots, return_inverse=True)
        # A slot is new when its first key in the batch was: later
        # duplicates of that key merge into it, as one at a time.
        new = np.zeros(len(uniq), dtype=bool)
        np.logical_or.at(new, inv, fresh)
        cur = self.read_slots(uniq)
        out = {}
        for name, have in cur.items():
            col = np.asarray(state[name], dtype=np.uint32)
            base = np.where(new, np.uint32(0), have)
            if name == "counts":
                total = base.astype(np.uint64)
                np.add.at(total, inv, col.astype(np.uint64))
                out[name] = np.minimum(total, 0xFFFFFFFF).astype(np.uint32)
            else:
                top = base.copy()
                np.maximum.at(top, inv, col)
                out[name] = top
        self.write_slots(uniq, out)
        imported = int(fresh.sum())
        return {"imported": imported, "merged": n - imported}

    def export_counts(self) -> np.ndarray:
        """Flat uint32 copy of the counter table."""
        with self._on_stream():
            return state_to_numpy(self._counts).reshape(-1)

    def import_counts(self, counts: np.ndarray) -> None:
        arr = np.asarray(counts, dtype=np.uint32).reshape(-1)
        if arr.shape[0] != self.model.num_slots:
            raise ValueError(
                f"counts size {arr.shape[0]} != num_slots {self.model.num_slots}"
            )
        host = torch.from_numpy(arr.view(np.int32).copy())
        with self._on_stream():
            self._counts = host.to(self.device)
