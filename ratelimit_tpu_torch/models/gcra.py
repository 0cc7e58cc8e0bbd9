"""GCRA (token bucket) rate limiting on the GPU.

Port of ratelimit_tpu/models/gcra.py: the Generic Cell Rate Algorithm
in its virtual-scheduling form.  Each slot stores one theoretical
arrival time (TAT).  With emission interval ``T = divider / limit`` and
burst tolerance ``tau = divider - T``, a request of ``h`` cells at
``now`` conforms iff ``TAT <= now + tau``, and then
``TAT' = max(TAT, now) + h * T``: capacity returns one cell per ``T``
seconds, with no burst at a window edge.

Per-slot state is one 64-bit TAT as two u32 rows (int32[2, num_slots]):

    row 0: tat_sec    unix seconds
    row 1: tat_frac   fractional second in 2^-32 units

The device math runs in float32 on the relative value ``TAT - now``
(bounded by about one window while a key is live).  For a group of
duplicate lanes the device grants a budget of ``B`` cells and advances
the TAT by ``min(total_h, B)`` cells; the host maps budgets onto the
shared threshold state machine (``lane_counts``).

The serving step, K5 ``gcra_serve_step`` (csrc/algorithms.cu), takes the
engine's packed int32[5, N] batch and ``now`` and returns int32[N]
budgets; it updates ``state`` IN PLACE.  Its by-value form,
``gcra_serve_step_lanes``, takes the batch in host memory (N <= 128)
and writes the budgets into the caller's pinned host `out`: the engine
serves every chunk of at most 128 padded lanes through it, as one
device activity.  Its mapped form, ``gcra_serve_step_mapped``, reads a
batch of any width from pinned host memory through its device alias
and writes the budgets likewise: the engine serves every wider chunk
through it, again as one device activity.  ``gcra_serve_step`` itself,
on device tensors, is the JAX-named API.  The wrappers launch the kernel for a CUDA tensor (or
raise) and run the plain PyTorch version beside it only for a tensor on
the CPU.  The plain version equals the JAX package's numpy
``reference_step`` bit for bit; the jitted JAX step may differ by one
cell where XLA fuses a multiply and an add.  ``GcraModel.reference_step``
is that numpy step, copied: the step of a quarantined bank's host
mirror (backends/host_engine.py), which runs no torch op.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.u32 import U32_MASK, narrow, widen
from .algorithm_step import (
    check_step_inputs,
    f32_to_i32,
    f32_to_u32,
    launch,
    now_i32,
    step_lanes,
    step_mapped,
)
from .fixed_window import resolve_device, slot_index
from .registry import ALGO_GCRA

K5 = "gcra_serve_step"
K5_LANES = "gcra_serve_step_lanes"
K5_MAPPED = "gcra_serve_step_mapped"

_FRAC_UNIT = 2.0**-32
_FRAC_SCALE = 2.0**32
#: Largest float32 strictly below 2^32 -- the frac-store clamp.
_FRAC_MAX = float(np.nextafter(np.float32(_FRAC_SCALE), np.float32(0)))
_B_MAX = float(2**31 - 128)  # i32-safe budget clamp (f32-representable)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _gcra_step_plain(state: torch.Tensor, packed: torch.Tensor, now: int) -> torch.Tensor:
    """Plain version of K5: the f32 ops of the JAX step in the numpy
    oracle's order (updates `state` in place, returns int32 budgets)."""
    ns = state.shape[1]
    idx, live = slot_index(packed[0], ns)
    hits = widen(packed[1])
    limits = widen(packed[2])
    fresh = packed[3] != 0
    divider = widen(packed[4])
    now_u = now_i32(now) & U32_MASK
    zero = torch.zeros_like(hits)

    take = live & ~fresh
    sec = torch.where(take, widen(state[0][idx]), zero)
    frac = torch.where(take, widen(state[1][idx]), zero)

    # Signed seconds from now to the TAT, by two's-complement wrap.
    rel = (sec - now_u) & U32_MASK
    rel = torch.where(rel >= 1 << 31, rel - (1 << 32), rel)
    d = rel.to(torch.float32) + frac.to(torch.float32) * _f32(_FRAC_UNIT)
    v = torch.maximum(d, _f32(0.0))  # (TAT - now)+

    divf = divider.to(torch.float32)
    t_emit = divf / limits.to(torch.float32)  # inf when limit == 0
    tau = divf - t_emit
    b_f = torch.floor((tau - v) / t_emit) + _f32(1.0)
    # Replace limit == 0's NaN before the clip; clamp keeps other NaNs,
    # as jnp.clip does.
    b_f = torch.where(limits > 0, b_f, _f32(0.0))
    b_f = torch.clamp(b_f, 0.0, _B_MAX)

    adm = torch.minimum(hits.to(torch.float32), b_f)  # cells admitted
    upd = adm > 0
    new_d = v + adm * torch.where(upd, t_emit, _f32(0.0))
    floor_d = torch.floor(new_d)
    new_sec = (now_u + f32_to_u32(floor_d)) & U32_MASK
    new_frac = f32_to_u32(
        torch.minimum((new_d - floor_d) * _f32(_FRAC_SCALE), _f32(_FRAC_MAX))
    )

    rows = idx[live]
    state[0][rows] = narrow(torch.where(upd, new_sec, sec)[live])
    state[1][rows] = narrow(torch.where(upd, new_frac, frac)[live])
    return f32_to_i32(b_f)


def gcra_serve_step(state: torch.Tensor, packed: torch.Tensor, now: int) -> torch.Tensor:
    """K5: one GCRA serving step over UNIQUE slots (the engine dedups).
    `state` int32[2, ns] is updated in place; returns int32[N] budgets
    in [0, 2^31 - 128]."""
    check_step_inputs(state, 2, packed)
    if state.device.type == "cpu":
        return _gcra_step_plain(state, packed, now)
    out = torch.empty(packed.shape[1], dtype=torch.int32, device=state.device)
    return launch("rl_gcra_serve_step", K5, state, packed, now, out)


def gcra_serve_step_lanes(
    state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
) -> torch.Tensor:
    """K5's by-value form: the same step as gcra_serve_step on the
    int32[5, N] batch `words` held in HOST memory (N <= 128), the
    budgets into `out` int32[N], host memory that must be pinned on a
    CUDA table.  Only enqueued on a CUDA table: wait on the stream (an
    event) before reading `out`.  Returns `out`."""
    return step_lanes(
        "rl_gcra_serve_step_lanes", K5_LANES, _gcra_step_plain, state, 2, words, now, out, ()
    )


def gcra_serve_step_mapped(
    state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
) -> torch.Tensor:
    """K5's mapped form: the same step as gcra_serve_step on the
    int32[5, N] batch `words` of any width held in PINNED host memory,
    read by the kernel through its device alias, the budgets into `out`
    int32[N], pinned host memory written the same way.  On a CUDA table,
    pageable memory raises KernelError and a device tensor ValueError.
    Only enqueued: keep `words` and wait on the stream (an event) before
    reading `out`.  Returns `out`."""
    return step_mapped(
        "rl_gcra_serve_step_mapped", K5_MAPPED, _gcra_step_plain, state, 2, words, now, out, ()
    )


class GcraModel:
    """Configuration + serving step for the TAT table.  `device`
    defaults to the GPU; only an explicit "cpu" runs the plain
    version."""

    algo = ALGO_GCRA
    #: Stable-stem keys: the TAT must survive window rollovers; the
    #: owning engine uses refresh-on-touch expiry.
    windowed_keys = False
    state_rows = ("tat_sec", "tat_frac")

    def __init__(self, num_slots: int, near_ratio: float = 0.8, device="cuda"):
        self.num_slots = int(num_slots)
        self.near_ratio = float(near_ratio)
        self.device = resolve_device(device)

    def init_state(self) -> torch.Tensor:
        """Fresh state: every TAT at 0 (the distant past: any key's
        first sighting has full burst capacity)."""
        return torch.zeros(
            (len(self.state_rows), self.num_slots), dtype=torch.int32, device=self.device
        )

    def step_serve_packed(
        self, state: torch.Tensor, packed: torch.Tensor, now: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One serving step (K5): returns (state, budgets) with `state`
        updated in place.  Padding lanes use out-of-table slots with
        divider 1, limit 1 and hits 0, so they are inert."""
        return state, gcra_serve_step(state, packed, now)

    def step_serve_lanes(
        self, state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K5's by-value form: the same batch as
        step_serve_packed, held in host memory, the budgets into `out`
        (pinned host memory on the card).  Returns (state, out); wait on
        the stream before reading `out`."""
        return state, gcra_serve_step_lanes(state, words, now, out)

    def step_serve_mapped(
        self, state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K5's mapped form: the batch of
        step_serve_packed in pinned host memory, of any width, read by
        the kernel through its device alias, the budgets into `out`
        (pinned).  Returns (state, out); wait on the stream before
        reading `out` or reusing `words`."""
        return state, gcra_serve_step_mapped(state, words, now, out)

    @staticmethod
    def readback_shape(n: int) -> Tuple[int, ...]:
        """Shape of the int32 readback of an n-lane step: the budgets."""
        return (n,)

    # -- host half (backends/engine.py generic protocol) ----------------

    def lane_counts(
        self,
        out: np.ndarray,
        dedup,
        hits_u32: np.ndarray,
        limits_u32: np.ndarray,
        now: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Map per-group budgets onto the shared (before, after)
        surface: ``before = limit - B + prefix`` is the cells already
        consumed against the limit in pipeline order, so
        ``after > limit  <=>  prefix + h > B`` -- exactly the
        conformance test.  ``before`` can go slightly negative when a
        lane's limit sits below its group's max (mixed-limit groups
        only); decide_batch's comparisons remain correct."""
        g = len(dedup.uniq_slots)
        budgets = np.asarray(out).reshape(-1)[:g].astype(np.int64)
        befores = (
            limits_u32.astype(np.int64)
            - budgets[dedup.inv]
            + dedup.prefix.astype(np.int64)
        )
        afters = befores + hits_u32.astype(np.int64)
        return befores, afters

    def reference_step(
        self,
        state: np.ndarray,
        slots: np.ndarray,
        hits: np.ndarray,
        limits: np.ndarray,
        fresh: np.ndarray,
        divider: np.ndarray,
        now: int,
    ) -> np.ndarray:
        """Numpy twin of K5 over unique in-table slots, on host arrays:
        the host mirror's step (backends/host_engine.py).  Mutates
        ``state`` (uint32[2, num_slots]) in place and returns the
        per-slot budgets; the f32 ops are the kernel's, in its order.
        Runs no torch op."""
        now_u = np.uint32(now)
        sec = state[0, slots].copy()
        frac = state[1, slots].copy()
        fresh = fresh.astype(bool)
        sec[fresh] = 0
        frac[fresh] = 0
        rel = (sec - now_u).view(np.int32)
        d = rel.astype(np.float32) + frac.astype(np.float32) * np.float32(
            _FRAC_UNIT
        )
        v = np.maximum(d, np.float32(0.0))
        limits = limits.astype(np.uint32)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_emit = divider.astype(np.float32) / limits.astype(np.float32)
            tau = divider.astype(np.float32) - t_emit
            b_f = np.floor((tau - v) / t_emit) + np.float32(1.0)
        b_f = np.where(limits > 0, b_f, np.float32(0.0))
        b_f = np.clip(b_f, np.float32(0.0), np.float32(_B_MAX))
        adm = np.minimum(hits.astype(np.float32), b_f)
        upd = adm > 0
        new_d = v + adm * np.where(upd, t_emit, np.float32(0.0))
        floor_d = np.floor(new_d)
        new_sec = (now_u + floor_d.astype(np.uint32)).astype(np.uint32)
        new_frac = np.minimum(
            (new_d - floor_d) * np.float32(_FRAC_SCALE),
            np.float32(_FRAC_MAX),
        ).astype(np.uint32)
        state[0, slots] = np.where(upd, new_sec, sec)
        state[1, slots] = np.where(upd, new_frac, frac)
        return b_f.astype(np.int32)
