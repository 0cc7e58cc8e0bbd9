"""Sharded fixed-window counter model: the slot space split into banks.

Port of ratelimit_tpu/parallel/sharded.py.  The counter table is one
int32 tensor of u32 bits laid out (num_banks, slots_per_bank),
bank-major, like the JAX model's device layout.  Bank ownership is
MODULO-STRIPED: global slot s lives in bank ``s % num_banks`` at local
position ``s // num_banks``, so the host slot table's dense allocation
spreads over every bank from the first key.

The JAX model puts one bank on each chip of a ``Mesh`` and recombines
per-lane answers with a ``psum``.  Here a mesh is ``num_banks`` banks on
ONE CUDA device (:func:`make_mesh`): every lane has exactly one owner
bank, so each kernel writes each lane once and no collective is needed.
A mesh whose banks would span several cards is refused; placing banks
across cards waits for a four-card cell (ROADMAP.md, Queue 3).

Two kernels, in csrc/sharded.cu:

- K6 ``sharded_routed_step``, the serving step: the engine routes each
  unique slot to its bank on the host (local ids, one packed
  int32[num_banks, 4, cap] batch) and one launch serves every bank --
  fresh-zero, gather, SATURATING add, unique scatter-set, narrow
  readback.  Up to 128 routed lanes (8 banks x cap 16) go by value,
  ``sharded_routed_step_lanes``: the batch rides in the launch's
  parameters and the readback lands in pinned host memory
  (``fixed_window.lanes_by_value`` decides, from the shape alone);
- K7 ``sharded_general_update``, the duplicate-tolerant step over a
  replicated batch of GLOBAL ids: zero fresh slots, gather, the
  per-slot prefix (K2's tile pass) on the raw ids, MODULAR scatter-add,
  with an optional narrow readback -- K3's fused general step under the
  striped index policy, one cooperative launch; ``step`` takes its
  decision epilogue (``sharded_general_step``), still one launch.

Like the single-table steps, both update ``counts`` IN PLACE.  Each
wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version, kept beside it, only for a tensor on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..backends.engine import DEFAULT_BUCKETS, CounterEngine
from ..models import fixed_window as fw
from ..models.fixed_window import (
    DeviceBatch,
    DeviceDecisions,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
)
from ..ops.prefix import per_slot_inclusive_prefix
from ..ops.u32 import narrow, widen

K6 = "sharded_routed_step"
K6_LANES = "sharded_routed_step_lanes"
K7 = "sharded_general_update"
K7_STEP = "sharded_general_step"


@dataclass(frozen=True)
class Mesh:
    """``num_banks`` counter banks on one device: the port's
    counterpart of the JAX package's 1-D device mesh."""

    num_banks: int
    device: torch.device


def make_mesh(n_banks: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of `n_banks` banks on `device`.

    `n_banks` None means one bank per card, as the JAX package's
    ``make_mesh()`` takes every local device: one bank on a device that
    names one card (or the CPU), one per visible card for plain "cuda"
    -- and banks on more than one card raise ValueError: they are never
    folded onto one card."""
    device = torch.device(device)
    if n_banks is None:
        n_banks = 1
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        if device.index is None and cards > 1:
            raise ValueError(
                f"one bank per visible card is a mesh over {cards} cards, which "
                "is not ported: every bank lives on one device; banks across "
                "cards wait for a four-card cell (ROADMAP.md, Queue 3).  Pass "
                "n_banks and one device to put several banks on one card."
            )
    if n_banks < 1:
        raise ValueError(f"a mesh needs at least one bank, got {n_banks}")
    return Mesh(int(n_banks), resolve_device(device))


def _check_banked(counts: torch.Tensor) -> Tuple[int, int]:
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise TypeError(
            "counts must be an int32[num_banks, slots_per_bank] tensor, got "
            f"{counts.dtype} {tuple(counts.shape)}"
        )
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    return counts.shape[0], counts.shape[1]


# -- K6: routed unique-slot serving step --------------------------------


def _routed_step_plain(
    counts: torch.Tensor, packed: torch.Tensor, out_dtype: str
) -> torch.Tensor:
    """Plain version of K6: K1's plain step on each bank, with the local
    ids of bank b moved to positions b * spb + id of the flattened table
    (JAX's index semantics at width spb first; inert ids past it)."""
    nb, spb = counts.shape
    idx, live = fw.slot_index(packed[:, 0], spb)
    bank = torch.arange(nb, dtype=torch.int64, device=counts.device).unsqueeze(1)
    rows = packed.transpose(0, 1).reshape(4, -1).clone()
    rows[0] = torch.where(live, bank * spb + idx, nb * spb).reshape(-1).to(torch.int32)
    out = fw._unique_step_plain(counts.view(-1), rows, out_dtype)
    return out.view(nb, packed.shape[2])


def sharded_routed_step(
    counts: torch.Tensor, packed: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K6: the serving step of every bank in one launch.  `packed` is
    int32[num_banks, 4, cap] (rows per bank: LOCAL slot ids, hits bits,
    limit bits, fresh); live local ids are distinct within a bank, ids
    in [-spb, -1] address id + spb and every other id (the engine pads
    with spb + i) is inert.  Returns int32[num_banks, cap] afters
    ("") or the saturated narrow readback ("uint8" -> uint8, "uint16"
    -> int16 storage); updates `counts` in place."""
    if out_dtype not in fw.OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {sorted(fw.OUT_DTYPES)}")
    nb, spb = _check_banked(counts)
    if (
        packed.dtype != torch.int32
        or packed.dim() != 3
        or packed.shape[:2] != (nb, 4)
    ):
        raise TypeError(
            f"packed must be int32[{nb}, 4, cap], got {packed.dtype} "
            f"{tuple(packed.shape)}"
        )
    if packed.device != counts.device:
        raise ValueError("packed and counts must be on one device")
    if counts.device.type == "cpu":
        return _routed_step_plain(counts, packed, out_dtype)
    fw._require_cuda(counts.device)
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if nb > 65535:
        raise ValueError(f"at most 65535 banks per launch, got {nb}")
    cap = packed.shape[2]
    out = torch.empty((nb, cap), dtype=fw.OUT_DTYPES[out_dtype], device=counts.device)
    if cap == 0:
        return out
    rc = kernels.function("rl_sharded_routed_step")(
        counts.data_ptr(),
        spb,
        packed.data_ptr(),
        nb,
        cap,
        out.data_ptr(),
        fw._OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    kernels.check(rc, K6)
    kernels.launches[K6] += 1
    return out


def sharded_routed_step_lanes(
    counts: torch.Tensor, words: torch.Tensor, out: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K6's by-value form: the same step as sharded_routed_step on an
    int32[num_banks, 4, cap] batch held in HOST memory (num_banks x cap
    <= 128), carried by the launch as parameters.  The readback goes
    into `out` (OUT_DTYPES[out_dtype][num_banks, cap]), host memory that
    must be pinned on a CUDA table, written through its device alias.
    Only enqueued on a CUDA table: wait on the stream (an event) before
    reading `out`.  Returns `out`."""
    nb, _ = _check_banked(counts)
    fw._check_unique_lanes(words, out, out_dtype)
    if words.dim() != 3 or words.shape[0] != nb:
        raise TypeError(f"words must be int32[{nb}, 4, cap], got {tuple(words.shape)}")
    if counts.device.type == "cpu":
        return out.copy_(_routed_step_plain(counts, words, out_dtype))
    fw._require_cuda(counts.device)
    cap = words.shape[2]
    if cap == 0:
        return out
    rc = kernels.function("rl_sharded_routed_step_lanes")(
        counts.data_ptr(),
        counts.shape[1],
        words.data_ptr(),
        nb,
        cap,
        out.data_ptr(),
        fw._OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    kernels.check(rc, K6_LANES)
    kernels.launches[K6_LANES] += 1
    return out


# -- K7: duplicate-tolerant update over global ids ----------------------


def _general_update_plain(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor],
    out_dtype: str,
) -> torch.Tensor:
    """Plain version of K7 (in place; returns the afters or their narrow
    readback)."""
    nb, spb = counts.shape
    ns = nb * spb
    s = slots.to(torch.int64)
    # Only [0, ns) is in the table: negative ids never wrap here.
    in_table = (s >= 0) & (s < ns)
    pos = torch.where(in_table, (s % nb) * spb + s // nb, torch.zeros_like(s))
    table = counts.view(-1)
    table[pos[in_table & fresh]] = 0
    before = torch.where(in_table, widen(table[pos]), torch.zeros_like(s))
    afters = before + widen(per_slot_inclusive_prefix(slots, hits))
    touched = pos[in_table]
    total = torch.zeros(ns, dtype=torch.int64, device=counts.device)
    total.index_add_(0, touched, widen(hits)[in_table])
    table[touched] = narrow(widen(table[touched]) + total[touched])
    if out_dtype == "":
        return narrow(afters)
    return fw.readback_plain(afters, widen(hits), widen(limits), out_dtype)


def sharded_general_update(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    out_dtype: str = "",
) -> torch.Tensor:
    """K7: zero fresh slots, gather, add the per-slot prefix of the raw
    GLOBAL ids, modular scatter-add of hits, over the (num_banks,
    slots_per_bank) table, in one launch of the fused general step.  An
    id in [0, num_banks * slots_per_bank) is owned by bank id %
    num_banks at id // num_banks; any other id -- negative ones
    included -- reads a zero counter and scatters nowhere.  Duplicate
    ids are allowed.  Returns the per-lane afters (int32 u32 bits), or
    with out_dtype "uint8"/"uint16" min(after, limit + hits) narrowed
    (`limits` then required); updates `counts` in place."""
    nb, spb = _check_banked(counts)
    fw.check_general_lanes(counts, slots, hits, fresh, limits, out_dtype)
    if counts.device.type == "cpu":
        return _general_update_plain(counts, slots, hits, fresh, limits, out_dtype)
    return fw.launch_general_step(
        "rl_sharded_general_step", (nb, spb), K7,
        counts, slots, hits, fresh, limits, out_dtype,
    )


def sharded_general_step(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: torch.Tensor,
    shadow: torch.Tensor,
    near_ratio: float,
) -> DeviceDecisions:
    """K7 with K3's decision block on its afters, in ONE cooperative
    launch (the fused general step's decision epilogue).  Updates
    `counts` in place."""
    nb, spb = _check_banked(counts)
    fw.check_general_lanes(counts, slots, hits, fresh, limits, shadow=shadow)
    if counts.device.type == "cpu":
        afters = _general_update_plain(counts, slots, hits, fresh, None, "")
        return fw._decision_block_plain(afters, hits, limits, shadow, near_ratio)
    return fw.launch_general_step(
        "rl_sharded_general_step", (nb, spb), K7_STEP,
        counts, slots, hits, fresh, limits, shadow=shadow, near_ratio=near_ratio,
    )


class ShardedFixedWindowModel:
    """Fixed-window decisions over a bank-sharded counter table.

    ``num_slots`` is the GLOBAL slot count, rounded up to a multiple of
    the mesh's bank count so that every bank has the same size (100
    slots over 8 banks -> 104, 13 per bank).  Slot ids from the host
    slot table index the global space."""

    def __init__(self, num_slots: int, mesh: Mesh, near_ratio: float = 0.8):
        self.mesh = mesh
        self.num_banks = mesh.num_banks
        self.slots_per_bank = -(-int(num_slots) // self.num_banks)
        self.num_slots = self.slots_per_bank * self.num_banks
        self.near_ratio = float(near_ratio)
        self.device = mesh.device

    def init_state(self) -> torch.Tensor:
        """Fresh table: int32[num_banks, slots_per_bank], all zero."""
        return torch.zeros(
            (self.num_banks, self.slots_per_bank), dtype=torch.int32, device=self.device
        )

    def step(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, DeviceDecisions]:
        """The sharded forward step: K7 + K3's decision block, one launch
        (sharded_general_step)."""
        return counts, sharded_general_step(
            counts, batch.slots, batch.hits, batch.fresh, batch.limits,
            batch.shadow, self.near_ratio,
        )

    def step_counters(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Counter update only (K7): returns (counts, afters)."""
        return counts, sharded_general_update(counts, batch.slots, batch.hits, batch.fresh)

    def step_counters_compact(
        self, counts: torch.Tensor, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K7 with the saturated narrow readback min(after, limit +
        hits) as uint8 or uint16 (int16 storage)."""
        return counts, sharded_general_update(
            counts, batch.slots, batch.hits, batch.fresh, batch.limits, out_dtype
        )

    def step_counters_unique_routed_packed(
        self, counts: torch.Tensor, out_dtype: str, packed: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed serving step (K6) on one packed int32[num_banks,
        4, cap] upload: returns (counts, afters[num_banks, cap])."""
        return counts, sharded_routed_step(counts, packed, out_dtype)

    def step_counters_unique_routed_lanes(
        self, counts: torch.Tensor, out_dtype: str, words: torch.Tensor, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed serving step in K6's by-value form: the batch of
        step_counters_unique_routed_packed held in host memory, the
        readback into `out` (pinned host memory on the card).  Returns
        (counts, out); wait on the stream before reading `out`."""
        return counts, sharded_routed_step_lanes(counts, words, out, out_dtype)

    def step_counters_unique_routed(
        self, counts: torch.Tensor, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed serving step on a batch whose fields are each
        shaped (num_banks, cap), slot ids LOCAL (shadow unused)."""
        packed = torch.stack(
            [batch.slots, batch.hits, batch.limits, batch.fresh.to(torch.int32)], dim=1
        )
        return self.step_counters_unique_routed_packed(counts, out_dtype, packed)


class ShardedCounterEngine(CounterEngine):
    """CounterEngine over a bank-sharded model.

    Host orchestration (slot table, dedup, host decide) is inherited;
    the device step is the ROUTED unique step (K6): unique slots are
    routed on the host to their owning bank (the Redis-cluster key-slot
    analog, reference driver_impl.go:108-126), each bank receives only
    its share of the batch, and the readback is unrouted on the host."""

    def __init__(
        self,
        mesh: Mesh,
        num_slots: int = 1 << 20,
        near_ratio: float = 0.8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        native_table: Optional[bool] = None,
    ):
        super().__init__(
            buckets=buckets,
            device=mesh.device,
            model=ShardedFixedWindowModel(num_slots, mesh, near_ratio),
            native_table=native_table,
        )
        # Routed-balance gauge: real lanes each bank received in the
        # last chunk.
        self.stat_bank_lane_counts = [0] * self.model.num_banks

    def _staging_size(self):
        """The routed upload is int32[num_banks, 4, cap] and its
        readback up to 4 B per routed lane, where cap is at most the
        bucket of min(max_batch, slots_per_bank): one bank holds at most
        slots_per_bank distinct slots (the warmup skew probe reaches
        it)."""
        m = self.model
        cap = self._bucket(min(self.max_batch, m.slots_per_bank))
        words = m.num_banks * 4 * cap
        return words, words

    def _device_submit(self, dedup, now: int = 0):
        # `now` is the generic-algorithm batch clock; the sharded engine
        # serves fixed-window only.
        m = self.model
        spb = m.slots_per_bank
        nb = m.num_banks
        uniq = dedup.uniq_slots
        g = len(uniq)
        totals32 = dedup.totals_u32()

        valid = (uniq >= 0) & (uniq < m.num_slots)
        vi = np.nonzero(valid)[0]
        banks_u = (uniq[vi] % nb).astype(np.int64)
        # Sorted uniq is not bank-grouped under modulo striping: order
        # lanes by bank (stable) before computing per-bank positions.
        order = np.argsort(banks_u, kind="stable")
        vi = vi[order]
        banks = banks_u[order]
        counts_pb = np.bincount(banks, minlength=nb)
        starts = np.concatenate([[0], np.cumsum(counts_pb)])
        pos = np.arange(len(vi)) - starts[banks]
        cap = self._bucket(max(int(counts_pb.max(initial=1)), 1))
        self.stat_bank_lane_counts = counts_pb.tolist()

        # ONE packed int32[nb, 4, cap] batch.  Padding ids spb + i are
        # distinct and out of the bank, so K6 leaves them inert.
        st = self._take_staging()
        pk = st.packed_np[: nb * 4 * cap].reshape(nb, 4, cap)
        pk[:, 0, :] = spb + np.arange(cap, dtype=np.int64)
        pk[:, 1, :] = 0
        pk[:, 2, :] = 1
        pk[:, 3, :] = 0
        pk[banks, 0, pos] = uniq[vi] // nb
        pk[banks, 1, pos] = totals32[vi].view(np.int32)
        pk[banks, 2, pos] = dedup.limit_max[vi].view(np.int32)
        pk[banks, 3, pos] = dedup.fresh[vi]

        # Dtype choice from the unwrapped uint64 totals (see
        # CounterEngine._device_submit): clamped-total groups take the
        # raw u32 readback, never the narrow one.
        cap_val = int(dedup.totals[vi].max(initial=0)) + int(
            dedup.limit_max[vi].max(initial=1)
        )
        dt = "uint8" if cap_val <= 0xFF else ("uint16" if cap_val <= 0xFFFF else "")
        handle = self._serve(
            st,
            st.packed[: nb * 4 * cap].view(nb, 4, cap),
            fw.OUT_DTYPES[dt],
            (nb, cap),
            lambda counts, words, out: m.step_counters_unique_routed_lanes(
                counts, dt, words, out
            ),
            lambda counts, packed: m.step_counters_unique_routed_packed(counts, dt, packed),
        )

        def reassemble(fetched: np.ndarray) -> np.ndarray:
            out = np.zeros(g, dtype=np.uint32)
            out[vi] = fetched[banks, pos]
            # Out-of-table slots (warmup probes) answer as on one table:
            # before 0, after = hits (never saturated: totals <= cap_val
            # by the dtype choice).
            out[~valid] = totals32[~valid]
            return out

        return handle, reassemble

    def warmup_probe_slots(self, bucket: int) -> np.ndarray:
        """All-one-bank probes: slots k * num_banks all land in bank 0,
        so the probe's routed cap is the widest (most skewed) this
        engine can serve for a `bucket`-lane batch -- min(bucket,
        slots_per_bank), since one bank holds at most slots_per_bank
        distinct slots.  The clamp keeps the probes distinct and in the
        table on small tables."""
        m = self.model
        width = min(int(bucket), m.slots_per_bank)
        return (np.arange(width, dtype=np.int64) * m.num_banks).astype(np.int32)

    def _slot_index(self, slots):
        """Global slot g lives in bank g % num_banks at position
        g // num_banks."""
        nb = self.model.num_banks
        idx = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int64)).to(self.device)
        return (idx % nb, idx // nb)

    def export_counts(self) -> np.ndarray:
        """Flat uint32 copy in GLOBAL slot order: bank b's position l
        holds global slot l * num_banks + b, so the (num_banks,
        slots_per_bank) layout transposes back."""
        with self._on_stream():
            return state_to_numpy(self._counts).T.reshape(-1)

    def import_counts(self, counts) -> None:
        arr = np.asarray(counts, dtype=np.uint32).reshape(-1)
        m = self.model
        if arr.shape[0] != m.num_slots:
            raise ValueError(f"counts size {arr.shape[0]} != num_slots {m.num_slots}")
        banked = arr.reshape(m.slots_per_bank, m.num_banks).T
        with self._on_stream():
            self._counts = state_from_numpy(banked, self.device)
