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
``_device_submit`` fills a staging buffer with the packed batch.  A
chunk of at most 128 padded lanes (``lanes_by_value``, by shape alone),
fixed-window or algorithm, goes by value: ONE launch carries the lanes
as kernel parameters and its kernel (K1, K4 or K5) writes the readback
straight into pinned host memory, so the chunk is one device activity.
A wider chunk (warmup, bursts) takes the device form: one non_blocking
host-to-device copy, the kernel, one non_blocking device-to-host copy
of its output into pinned readback memory.  Either way an event is
recorded after the last of it.  ``step_complete`` waits
on that event (never on the whole device) before the host decide pass.
Each in-flight submission holds its own staging buffers, so the
dispatcher can launch batch N+1 while batch N's readback is in flight;
stream order stands in for the reference's donated-buffer chain.  The
stream is passed explicitly wherever it is used: ``step_complete`` runs
on another thread, and a stream context is thread-local.  No two live
engines share a stream (``claim_stream``): a stall on one bank's stream
must hold up no other bank.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
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
from .slot_table import EntryArrays, SlotTable

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


def release_stream(holder) -> None:
    """Give `holder`'s stream back: a later engine may draw it."""
    stream = getattr(holder, "_stream", None)
    if stream is None:
        return
    with _HELD_LOCK:
        if _HELD_STREAMS.get(stream.cuda_stream) is holder:
            del _HELD_STREAMS[stream.cuda_stream]


def stream_idle(holder, lost: bool = False) -> bool:
    """Whether `holder`'s stream has finished all the work queued on it
    (True off CUDA).  A stream whose query fails -- a lost context --
    answers `lost`: busy by default, so it stays held."""
    stream = getattr(holder, "_stream", None)
    if stream is None:
        return True
    try:
        return bool(stream.query())
    except Exception:
        return lost


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
    batch and `nbytes` of readback (pinned on CUDA, so both copies are
    truly asynchronous and a by-value kernel can write the readback
    through its device alias), plus the event recorded after the last
    device work of the submission.  A staging object returns to the
    engine's free list only after step_complete has waited on its event
    and copied the readback out: until then a kernel or a copy may still
    be writing into its readback."""

    __slots__ = ("packed", "packed_np", "readback", "event")

    def __init__(self, words: int, nbytes: int, device: torch.device):
        pin = device.type == "cuda"
        self.packed = torch.empty(words, dtype=torch.int32, pin_memory=pin)
        self.packed_np = self.packed.numpy()
        self.readback = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None


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
        provide EITHER the saturating unique-slot serving step in both
        forms (step_counters_unique_packed and its by-value
        step_counters_unique_lanes) OR the generic algorithm
        protocol: ``step_serve_packed(state, packed, now)``, its
        by-value ``step_serve_lanes(state, words, now, out)`` and
        ``readback_shape(n)`` on the device, plus ``lane_counts(out,
        dedup, hits, limits, now)`` on the host.  A subclass that
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
            ("step_serve_packed", "step_serve_lanes", "readback_shape")
            if self._generic
            else ("step_counters_unique_packed", "step_counters_unique_lanes")
        )
        if type(self)._device_submit is CounterEngine._device_submit and not all(
            hasattr(self.model, name) for name in needs
        ):
            raise TypeError(
                "model must provide the saturating unique-slot serving "
                "step (step_counters_unique_packed and "
                "step_counters_unique_lanes) or the generic protocol "
                "(step_serve_packed, step_serve_lanes, readback_shape and "
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
        with self._on_stream():
            self._counts = self.model.init_state()
        # Gauge snapshots, written only by the thread that owns the
        # slot table (the dispatcher collector) and read lock-free.
        self.stat_live_keys = 0
        self.stat_evictions = 0
        self.stat_dedup_groups = 0
        self.stat_window_rollovers = 0

    def _on_stream(self):
        """Context that puts this thread's work on the engine stream.
        Every copy out of the table runs there too, ordered after the
        engine's own kernels: nothing of an engine waits on the whole
        device or on another engine's stream, so a stream stalled by one
        bank cannot hold up the restart of another."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

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

    def gc(self, now: int) -> int:
        return self.slot_table.gc(now)

    # -- device step ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def step(self, batch: HostBatch, now: int = 0) -> HostDecisions:
        """Run one padded device step per <=max_batch chunk."""
        return self.step_complete(self.step_submit(batch, now))

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
        self.stat_dedup_groups = sum(len(c[3].uniq_slots) for c in chunks)  # tpu-lint: disable=shared-state -- collector-owned engine
        return (batch.hits, batch.limits, batch.shadow, chunks, now)

    def submit_packed(self, now: int, key_blob, meta: np.ndarray):
        """Serving fast path: assign slots AND dedup in one native call
        per chunk, then launch the device step (no wait).  Keys arrive
        as a length-prefixed utf-8 blob and per-lane scalars as one
        LANE_DTYPE record array (see dispatcher.LanePack).  Returns
        the same token shape as step_submit."""
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
        # Phase 2 -- launch the device step per chunk.
        chunks = []
        for start, count, dedup in dedups:
            handle, reassemble = self._device_submit(dedup, now)
            chunks.append((handle, start, count, dedup, reassemble))
            self.stat_window_rollovers += int(np.count_nonzero(dedup.fresh))
        self.stat_live_keys = len(table)
        self.stat_evictions = table.evictions
        self.stat_dedup_groups = sum(len(d.uniq_slots) for _, _, d in dedups)
        return (hits, limits, shadow, chunks, now)

    def step_complete(self, token) -> HostDecisions:
        """Wait for the readback of a step_submit token and run the
        host threshold state machine.  Touches no engine state but the
        staging free list (a GIL-atomic append), so any thread may call
        it."""
        hits, limits, shadow, chunks, now = token
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
        if st.event is not None:
            st.event.synchronize()  # tpu-lint: disable=torch-host-sync -- the wait for this submission's own readback: it runs on the dispatcher's completer thread, or with no batch window on the RPC's thread after the bank's lock is released, under no lock, and each RPC waits on its own item event bounded by KERNEL_DEADLINE_S
        out = readback.numpy().view(_HOST_VIEW[readback.dtype]).copy()
        self._free_staging.append(st)
        return out

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
            lambda counts, packed: m.step_counters_unique_packed(counts, dt, packed),
        )
        return handle, None

    def _serve(
        self,
        st: _Staging,
        host: torch.Tensor,
        dtype: torch.dtype,
        shape,
        lanes_step,
        packed_step,
    ):
        """Run a serving step on the packed batch `host` (int32[...,
        rows, padded], a view of `st.packed`) whose readback is
        dtype[shape], and return the handle (st, readback) for _fetch.
        The batch's shape alone picks the form: by value
        (`lanes_step(counts, host, out)`; one launch, the readback
        written by the kernel into `st.readback`), or through device
        memory (`packed_step(counts, packed)`; upload, kernel, readback
        copy).  Each returns (counts, readback).  Runs on the engine
        stream; the event follows the kernel either way."""
        rows, padded = host.shape[-2:]
        with self._on_stream():
            if lanes_by_value(host.numel() // (rows * padded), padded):
                nbytes = math.prod(shape) * dtype.itemsize
                out = st.readback[:nbytes].view(dtype).view(shape)
                self._counts, readback = lanes_step(self._counts, host, out)
                self._record(st)
                return st, readback
            packed = host.to(self.device, non_blocking=True)
            self._counts, out = packed_step(self._counts, packed)
            return st, self._read_back(st, out)

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
            lambda state, packed: m.step_serve_packed(state, packed, now),
        )
        return handle, None

    def _read_back(self, st: _Staging, out: torch.Tensor) -> torch.Tensor:
        """Enqueue the copy of `out` into `st`'s pinned readback (same
        dtype and shape) and record `st`'s event after it.  Runs on the
        engine stream."""
        nbytes = out.numel() * out.element_size()
        readback = st.readback[:nbytes].view(out.dtype).view(out.shape)
        readback.copy_(out, non_blocking=True)
        self._record(st)
        return readback

    def _record(self, st: _Staging) -> None:
        """Record `st`'s event on the engine stream, after the work that
        writes its readback; _fetch waits on it."""
        if st.event is not None:
            st.event.record(self._stream)

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
