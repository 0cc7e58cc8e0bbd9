"""CounterEngine: host orchestration around the device model.

Port of ratelimit_tpu/backends/engine.py.  Owns the counter table (one
int32 tensor of u32 bits on the engine's device), the host slot table,
and batch padding/bucketing.  The host halves -- ``DEFAULT_BUCKETS``,
``_Dedup``, ``_dedup_chunk``, ``_decide_host`` and the u8/u16/u32
readback choice -- are the reference's, unchanged.

The device half runs on a CUDA stream the engine owns:
``_device_submit`` fills a pinned int32[4, padded] staging buffer, makes
one non_blocking host-to-device copy, launches K1 (``fw_unique_step``)
and one non_blocking device-to-host copy of the afters into pinned
readback memory, then records an event.  ``step_complete`` waits on
that event (never on the whole device) before the host decide pass.
Each in-flight submission holds its own staging buffers, so the
dispatcher can launch batch N+1 while batch N's readback is in flight;
stream order stands in for the reference's donated-buffer chain.  The
stream is passed explicitly wherever it is used: ``step_complete`` runs
on another thread, and a stream context is thread-local.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.fixed_window import FixedWindowModel, resolve_device, state_to_numpy

# Pad batches up to one of these sizes so a handful of kernel shapes
# serve every batch length (batch-axis bucketing to fixed shapes).
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# Host numpy views of the readback storage types (u16 lives in int16).
_HOST_VIEW = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8}


@dataclass
class HostBatch:
    """Unpadded batch assembled on the host (numpy, batch order)."""

    slots: np.ndarray  # int32
    hits: np.ndarray  # uint32
    limits: np.ndarray  # uint32
    fresh: np.ndarray  # bool
    shadow: np.ndarray  # bool
    # Per-lane window length in seconds; only the generic-algorithm
    # models (not yet ported) consume it.
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
    from .slot_table import SlotTable

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


class _Staging:
    """Host buffers of one in-flight submission: the packed int32[4, N]
    upload and the afters readback (pinned on CUDA, so both copies are
    truly asynchronous), plus the event recorded after the readback.
    A staging object returns to the engine's free list only after
    step_complete has waited on its event and copied the afters out."""

    __slots__ = ("packed", "packed_np", "readback", "event")

    def __init__(self, max_batch: int, device: torch.device):
        pin = device.type == "cuda"
        self.packed = torch.empty(4 * max_batch, dtype=torch.int32, pin_memory=pin)
        self.packed_np = self.packed.numpy()
        self.readback = torch.empty(4 * max_batch, dtype=torch.uint8, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None


class CounterEngine:
    def __init__(
        self,
        num_slots: int = 1 << 20,
        near_ratio: float = 0.8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device="cuda",
        model: Optional[FixedWindowModel] = None,
        native_table: Optional[bool] = None,
    ):
        """`device` defaults to the GPU and raises there when CUDA is
        absent; only device="cpu" runs the plain versions.  `model`
        defaults to a FixedWindowModel on that device (the generic
        algorithm protocol is not ported yet).  `native_table`: None =
        use the C++ slot table when it builds/loads, True = require
        it, False = pure Python."""
        self.device = resolve_device(device)
        self.model = (
            model
            if model is not None
            else FixedWindowModel(num_slots, near_ratio, device=self.device)
        )
        if not hasattr(self.model, "step_counters_unique_packed"):
            raise TypeError(
                "model must provide the saturating unique-slot serving "
                "step (step_counters_unique_packed); the generic "
                "algorithm protocol is not ported yet"
            )
        if self.model.device != self.device:
            raise ValueError(
                f"model is on {self.model.device}, engine on {self.device}"
            )
        self._table_cls = _pick_table_cls(native_table)
        self.slot_table = self._table_cls(self.model.num_slots)
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._free_staging: List[_Staging] = []
        with self._on_stream():
            self._counts = self.model.init_state()
        # Gauge snapshots, written only by the thread that owns the
        # slot table (the dispatcher collector) and read lock-free.
        self.stat_live_keys = 0
        self.stat_evictions = 0
        self.stat_dedup_groups = 0
        self.stat_window_rollovers = 0

    def _on_stream(self):
        """Context that puts this thread's work on the engine stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        """Wait for everything enqueued on the engine stream."""
        if self._stream is not None:
            self._stream.synchronize()

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
            chunks.append((self._device_submit(dedup), start, count, dedup))
            self.stat_window_rollovers += int(np.count_nonzero(dedup.fresh))
        self.stat_live_keys = len(self.slot_table)
        self.stat_evictions = self.slot_table.evictions
        self.stat_dedup_groups = sum(len(c[3].uniq_slots) for c in chunks)
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
                    )
                    dedups.append((start, count, dedup))
        finally:
            if multi_fused:
                table.end_batch()
        # Phase 2 -- launch the device step per chunk.
        chunks = []
        for start, count, dedup in dedups:
            chunks.append((self._device_submit(dedup), start, count, dedup))
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
        for handle, start, count, dedup in chunks:
            fetched = self._fetch(handle)
            end = start + count
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

    def _take_staging(self) -> _Staging:
        try:
            return self._free_staging.pop()
        except IndexError:
            return _Staging(self.max_batch, self.device)

    def _fetch(self, handle) -> np.ndarray:
        """Wait for one submission's readback; copy it out and recycle
        its staging buffers."""
        st, readback = handle
        if st.event is not None:
            st.event.synchronize()
        out = readback.numpy().view(_HOST_VIEW[readback.dtype]).copy()
        self._free_staging.append(st)
        return out

    def _device_submit(self, dedup: _Dedup):
        """Launch the device step for one deduped chunk; returns the
        handle step_complete waits on."""
        g = len(dedup.uniq_slots)
        padded = self._bucket(g)
        ns = self.model.num_slots
        # Dtype choice uses the UNWRAPPED uint64 totals; totals past
        # u32 max are CLAMPED for the device (not wrapped), matching
        # the saturating counter arithmetic.
        cap = int(dedup.totals.max(initial=0)) + int(
            dedup.limit_max.max(initial=1)
        )
        dt = "uint8" if cap <= 0xFF else ("uint16" if cap <= 0xFFFF else "")

        # ONE packed int32[4, padded] upload.  Rows: slots, hits (u32
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
        host = st.packed[: 4 * padded].view(4, padded)
        with self._on_stream():
            packed = host.to(self.device, non_blocking=True)
            self._counts, afters = self.model.step_counters_unique_packed(
                self._counts, dt, packed
            )
            nbytes = afters.numel() * afters.element_size()
            readback = st.readback[:nbytes].view(afters.dtype)
            readback.copy_(afters, non_blocking=True)
            if st.event is not None:
                st.event.record(self._stream)
        return st, readback

    # -- checkpoint surface ---------------------------------------------

    def export_state(self) -> dict:
        """Named copy of the per-slot device state:
        ``{"counts": uint32[num_slots]}``, the reference's contract."""
        return {"counts": self.export_counts()}

    def import_state(self, state: dict) -> None:
        """Inverse of export_state; validates names and shapes."""
        extra = set(state) - {"counts"}
        if extra:
            raise ValueError(
                f"fixed-window state has only a 'counts' row, got {sorted(state)}"
            )
        self.import_counts(state["counts"])

    def export_counts(self) -> np.ndarray:
        """Flat uint32 copy of the counter table."""
        self._sync()
        return state_to_numpy(self._counts)

    def import_counts(self, counts: np.ndarray) -> None:
        arr = np.asarray(counts, dtype=np.uint32).reshape(-1)
        if arr.shape[0] != self.model.num_slots:
            raise ValueError(
                f"counts size {arr.shape[0]} != num_slots {self.model.num_slots}"
            )
        host = torch.from_numpy(arr.view(np.int32).copy())
        with self._on_stream():
            self._counts = host.to(self.device)
