"""Host-side mirror counter engine: the device path's fallback.

Port of ratelimit_tpu/backends/host_engine.py.  When a bank's device
path faults (a stalled stream, a launch error, a lost device --
backends/fault_domain.py), its lanes re-route here: a numpy engine that
evaluates the SAME algorithm semantics as the bank's kernel.  Under
``DEVICE_FAILURE_MODE=host`` the quarantined bank keeps *counting* on
the host until the supervisor restarts the device bank and imports the
mirror's counters back (export_keys/import_keys).

The mirror is numpy on host arrays and runs no torch op: it is not the
kernels' plain PyTorch versions (those serve the tests).  Fixed window
uses :func:`host_fixed_window_step`, the saturating twin of K1;
sliding window and GCRA call their models' numpy ``reference_step``,
twins of K4 and K5 (the same f32 ops in the same order).  Decisions
then go through the host reconstruction the device path uses
(engine._decide_host / engine.decide_generic), so a fallback decision
differs from the device's only by whatever hits the device lost when it
faulted.

``StaticFallbackEngine`` is the allow/deny half of the knob: it
synthesizes fixed-code decisions with ZERO stat deltas (no rule
counters move for traffic the backend never evaluated) and never
touches state.  The caller-deadline path uses it too, with or without
a fault domain.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import Code
from ..models.registry import get_algorithm
from .engine import (
    CounterEngine,
    HostDecisions,
    _decide_host,
    _decode_keys,
    _dedup_chunk,
    decide_generic,
)
from .slot_table import SlotTable

_OK = int(Code.OK)
_OVER = int(Code.OVER_LIMIT)
_U32_MAX = np.uint64(0xFFFFFFFF)


def host_fixed_window_step(
    counts: np.ndarray,
    slots: np.ndarray,
    totals: np.ndarray,
    fresh: np.ndarray,
) -> np.ndarray:
    """K1 on numpy over UNIQUE slots: zero fresh slots, saturating add
    (the counter clamps at u32 max instead of wrapping), return the
    per-group afters.  Mutates ``counts`` in place."""
    before = np.where(fresh, np.uint32(0), counts[slots]).astype(np.uint64)
    after = np.minimum(before + totals.astype(np.uint64), _U32_MAX).astype(
        np.uint32
    )
    counts[slots] = after
    return after


class HostEngine:
    """Numpy twin of :class:`~.engine.CounterEngine` for one bank.

    Implements the engine surface the dispatcher and cache touch --
    ``submit_packed``/``step_complete`` (synchronous: the "token" is
    the finished decisions), the slot table, gc, and the handoff
    protocol (export/import state and keys) -- so a quarantined bank's
    WorkItems run through :func:`~.dispatcher.run_items` unchanged and
    the supervisor can stream its counters back into a restarted
    device engine.
    """

    def __init__(
        self,
        num_slots: int,
        near_ratio: float = 0.8,
        algorithm: str = "fixed_window",
        max_batch: int = 4096,
    ):
        spec = get_algorithm(algorithm)
        self.spec = spec
        # The model carries the metadata and the numpy halves
        # (reference_step, lane_counts); it is built for the CPU and
        # its init_state is never called, so no tensor exists here.
        self.model = spec.make_model(num_slots, near_ratio, device="cpu")
        self._generic = hasattr(self.model, "lane_counts")
        self.slot_table = SlotTable(
            num_slots, refresh_expiry=not spec.windowed_keys
        )
        self.state = np.zeros((len(spec.state_rows), num_slots), np.uint32)
        self.max_batch = int(max_batch)
        self.buckets = (self.max_batch,)
        self.stat_live_keys = 0
        self.stat_evictions = 0
        self.stat_window_rollovers = 0
        self.stat_decisions = 0

    @property
    def algorithm(self) -> str:
        return self.spec.name

    # -- serving surface (dispatcher.run_items protocol) ----------------

    def submit_packed(self, now: int, key_blob, meta: np.ndarray):
        """CounterEngine.submit_packed, evaluated eagerly: assign slots,
        dedup same-key lanes, run the numpy step, rebuild per-lane
        decisions.  Returns the finished HostDecisions as the token
        (step_complete is the identity)."""
        n = len(meta)
        key_lens = meta["len"].astype(np.int64)
        expiries = np.ascontiguousarray(meta["expiry"])
        hits = np.ascontiguousarray(meta["hits"])
        limits = np.ascontiguousarray(meta["limits"])
        shadow = meta["shadow"].astype(bool)
        dividers = (
            np.ascontiguousarray(meta["divider"]) if self._generic else None
        )
        keys = _decode_keys(key_blob, key_lens)
        slots64, fresh = self.slot_table.assign_batch(keys, now, expiries)
        slots = slots64.astype(np.int32)
        outs: List[HostDecisions] = []
        for start in range(0, n, self.max_batch):
            end = min(n, start + self.max_batch)
            dedup = _dedup_chunk(
                slots[start:end],
                hits[start:end],
                limits[start:end],
                fresh[start:end],
                None if dividers is None else dividers[start:end],
            )
            self.stat_window_rollovers += int(np.count_nonzero(dedup.fresh))  # tpu-lint: disable=shared-state -- mirror has one toucher (the bank's fallback lock)
            if self._generic:
                divider_g = (
                    dedup.divider_max
                    if dedup.divider_max is not None
                    else np.ones(len(dedup.uniq_slots), np.uint32)
                )
                out = self.model.reference_step(
                    self.state,
                    dedup.uniq_slots.astype(np.int64),
                    dedup.totals_u32(),
                    dedup.limit_max,
                    dedup.fresh,
                    divider_g,
                    now,
                )
                fetched = np.stack(out) if isinstance(out, tuple) else np.asarray(out)
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
            else:
                afters_g = host_fixed_window_step(
                    self.state[0],
                    dedup.uniq_slots,
                    dedup.totals_u32(),
                    dedup.fresh,
                )
                outs.append(
                    _decide_host(
                        afters_g,
                        hits[start:end],
                        limits[start:end],
                        shadow[start:end],
                        self.model.near_ratio,
                        dedup,
                    )
                )
        self.stat_live_keys = len(self.slot_table)
        self.stat_evictions = self.slot_table.evictions  # tpu-lint: disable=shared-state -- mirror has one toucher (the bank's fallback lock)
        self.stat_decisions += n  # tpu-lint: disable=shared-state -- mirror has one toucher (the bank's fallback lock)
        if len(outs) == 1:
            return outs[0]
        if not outs:
            empty = np.zeros(0, dtype=np.int32)
            return HostDecisions(*([empty] * 8), empty.astype(bool))
        return HostDecisions(
            *(
                np.concatenate([getattr(o, f) for o in outs])
                for f in HostDecisions.__dataclass_fields__
            )
        )

    def step_complete(self, token):
        """The token IS the decisions (the numpy step is synchronous)."""
        return token

    def gc(self, now: int) -> int:
        freed = self.slot_table.gc(now)
        self.stat_live_keys = len(self.slot_table)
        return freed

    # -- handoff surface -------------------------------------------------

    def export_state(self) -> dict:
        rows = self.spec.state_rows
        return {name: self.state[i].copy() for i, name in enumerate(rows)}

    def import_state(self, state: dict) -> None:
        ns = self.model.num_slots
        for i, name in enumerate(self.spec.state_rows):
            arr = np.asarray(state[name], dtype=np.uint32).reshape(-1)
            if arr.shape[0] != ns:
                raise ValueError(
                    f"state row {name!r} size {arr.shape[0]} != num_slots {ns}"
                )
            self.state[i] = arr

    def import_snapshot(self, state: dict, entries) -> int:
        """Seed the mirror from a bank's last pre-fault snapshot: the
        state rows of checkpoint.copy_engine and the live (key, slot,
        expiry) entries of its table copy.  The quarantined bank then
        counts on from where the device was at the snapshot."""
        self.import_state({k: np.asarray(v) for k, v in state.items()})
        self.slot_table = SlotTable.from_entries(
            self.model.num_slots,
            entries,
            refresh_expiry=self.slot_table.refresh_expiry,
        )
        self.stat_live_keys = len(self.slot_table)
        return len(entries)

    # Live key export/import: the device engine's semantics (merge on
    # collision, drop expired), whose implementation only touches
    # export_state/import_state and the slot table, all provided above.
    export_keys = CounterEngine.export_keys
    import_keys = CounterEngine.import_keys


class StaticFallbackEngine:
    """DEVICE_FAILURE_MODE allow|deny synthesizer: answers every lane
    with a fixed code, zero stat deltas (rule counters must not move
    for traffic the backend never evaluated), and no state.  Shadow
    rules never enforce: a deny answers them OK, like every other
    path."""

    def __init__(self, allow: bool):
        self.allow = bool(allow)
        self.stat_decisions = 0

    def submit_packed(self, now: int, key_blob, meta: np.ndarray):
        n = len(meta)
        z = np.zeros(n, dtype=np.int64)
        limits = meta["limits"].astype(np.int64)
        if self.allow:
            codes = np.full(n, _OK, dtype=np.int32)
            remaining = limits
        else:
            codes = np.where(meta["shadow"] != 0, _OK, _OVER).astype(np.int32)
            remaining = z
        self.stat_decisions += n  # tpu-lint: disable=shared-state -- GIL-atomic stats counter, scrape-only reader
        return HostDecisions(
            codes=codes,
            limit_remaining=remaining,
            befores=z,
            afters=z,
            over_limit=z,
            near_limit=z,
            within_limit=z,
            shadow_mode=z,
            set_local_cache=np.zeros(n, dtype=bool),
        )

    def step_complete(self, token):
        return token


#: Shared static synthesizers (stateless): the caller-deadline path
#: uses these even when no fault domain is built.
STATIC_ALLOW = StaticFallbackEngine(allow=True)
STATIC_DENY = StaticFallbackEngine(allow=False)
