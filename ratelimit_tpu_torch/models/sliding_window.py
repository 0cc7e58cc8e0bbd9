"""Sliding-window rate limiting on the GPU.

Port of ratelimit_tpu/models/sliding_window.py.  Each slot holds the
request count of its current window and of the previous one, and
admission weighs the previous count by the un-elapsed fraction of the
current window:

    effective(now) = floor(prev * (divider - (now - w)) / divider) + curr

with ``w = now - now % divider``.  Per-slot state is three u32 rows
(int32 tensor of the same bits, int32[3, num_slots]):

    row 0: window_start   unix seconds of the slot's current window
    row 1: curr           count in the current window (saturating)
    row 2: prev           count in the previous window

Keys are the stable stem (``windowed_keys = False``): the slot survives
window rollovers and the kernel ages its state lazily per lane -- same
window: accumulate; adjacent: prev = curr, curr = 0; older: both zero.
``fresh`` lanes (newly assigned slots) start from zero.

The serving step, K4 ``sw_serve_step`` (csrc/algorithms.cu), takes the
engine's packed int32[5, N] batch and ``now`` and returns u32[2, N]
(weighted prev, curr after) per unique slot; the host rebuilds
per-lane counts (``lane_counts``) and runs the shared threshold state
machine.  The step updates ``state`` IN PLACE.  Its by-value form,
``sw_serve_step_lanes``, takes the batch in host memory (N <= 128) and
writes the readback into the caller's pinned host `out`: the engine
serves every chunk of at most 128 padded lanes through it, as one
device activity.  Its mapped form, ``sw_serve_step_mapped``, reads a
batch of any width from pinned host memory through its device alias
and writes the readback likewise: the engine serves every wider chunk
through it, again as one device activity.  ``sw_serve_step`` itself,
on device tensors, is the JAX-named API.  The wrappers launch the kernel for a CUDA tensor (or
raise) and run the plain PyTorch version beside it only for a tensor on
the CPU.  ``SlidingWindowModel.reference_step`` is K4 once more in
numpy on host arrays, the step of a quarantined bank's host mirror
(backends/host_engine.py): it runs no torch op.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.u32 import U32_MASK, narrow, widen
from .algorithm_step import (
    check_step_inputs,
    f32_to_u32,
    launch,
    now_i32,
    step_lanes,
    step_mapped,
)
from .fixed_window import resolve_device, slot_index
from .registry import ALGO_SLIDING_WINDOW

K4 = "sw_serve_step"
K4_LANES = "sw_serve_step_lanes"
K4_MAPPED = "sw_serve_step_mapped"


def _sw_step_plain(state: torch.Tensor, packed: torch.Tensor, now: int) -> torch.Tensor:
    """Plain version of K4: int64 arithmetic masked to 32 bits and the
    f32 ops of the JAX step in its order (updates `state` in place)."""
    ns = state.shape[1]
    idx, live = slot_index(packed[0], ns)
    hits = widen(packed[1])
    fresh = packed[3] != 0
    divider = widen(packed[4])
    now_u = now_i32(now) & U32_MASK
    zero = torch.zeros_like(hits)

    win = torch.where(live, widen(state[0][idx]), zero)
    curr = torch.where(live, widen(state[1][idx]), zero)
    prev = torch.where(live, widen(state[2][idx]), zero)

    w = now_u - now_u % divider
    same = (win == w) & ~fresh
    adjacent = (win == ((w - divider) & U32_MASK)) & ~fresh  # u32 wrap intended
    new_prev = torch.where(same, prev, torch.where(adjacent, curr, zero))
    base = torch.where(same, curr, zero)

    elapsed = now_u - w
    frac = ((divider - elapsed) & U32_MASK).to(torch.float32) / divider.to(
        torch.float32
    )
    wprev = f32_to_u32(torch.floor(new_prev.to(torch.float32) * frac))
    after = torch.clamp(base + hits, max=U32_MASK)  # saturating

    rows = idx[live]
    state[0][rows] = narrow(w[live])
    state[1][rows] = narrow(after[live])
    state[2][rows] = narrow(new_prev[live])
    return narrow(torch.stack([wprev, after]))


def sw_serve_step(state: torch.Tensor, packed: torch.Tensor, now: int) -> torch.Tensor:
    """K4: one sliding-window serving step over UNIQUE slots (the engine
    dedups).  `state` int32[3, ns] is updated in place; returns the
    int32[2, N] u32 bits (weighted prev, curr after) per lane."""
    check_step_inputs(state, 3, packed)
    if state.device.type == "cpu":
        return _sw_step_plain(state, packed, now)
    out = torch.empty((2, packed.shape[1]), dtype=torch.int32, device=state.device)
    return launch("rl_sw_serve_step", K4, state, packed, now, out)


def sw_serve_step_lanes(
    state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
) -> torch.Tensor:
    """K4's by-value form: the same step as sw_serve_step on the
    int32[5, N] batch `words` held in HOST memory (N <= 128), the
    readback into `out` int32[2, N], host memory that must be pinned on
    a CUDA table.  Only enqueued on a CUDA table: wait on the stream (an
    event) before reading `out`.  Returns `out`."""
    return step_lanes(
        "rl_sw_serve_step_lanes", K4_LANES, _sw_step_plain, state, 3, words, now, out, (2,)
    )


def sw_serve_step_mapped(
    state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
) -> torch.Tensor:
    """K4's mapped form: the same step as sw_serve_step on the int32[5,
    N] batch `words` of any width held in PINNED host memory, read by
    the kernel through its device alias, the readback into `out`
    int32[2, N], pinned host memory written the same way.  On a CUDA
    table, pageable memory raises KernelError and a device tensor
    ValueError.  Only enqueued: keep `words` and wait on the stream (an
    event) before reading `out`.  Returns `out`."""
    return step_mapped(
        "rl_sw_serve_step_mapped", K4_MAPPED, _sw_step_plain, state, 3, words, now, out, (2,)
    )


class SlidingWindowModel:
    """Configuration + serving step for the two-window table.  `device`
    defaults to the GPU; only an explicit "cpu" runs the plain
    version."""

    algo = ALGO_SLIDING_WINDOW
    #: Stable-stem keys: slots survive window rollovers; the owning
    #: engine uses refresh-on-touch expiry.
    windowed_keys = False
    state_rows = ("window_start", "curr", "prev")

    def __init__(self, num_slots: int, near_ratio: float = 0.8, device="cuda"):
        self.num_slots = int(num_slots)
        self.near_ratio = float(near_ratio)
        self.device = resolve_device(device)

    def init_state(self) -> torch.Tensor:
        """Fresh state: all slots empty in window 0."""
        return torch.zeros(
            (len(self.state_rows), self.num_slots), dtype=torch.int32, device=self.device
        )

    def step_serve_packed(
        self, state: torch.Tensor, packed: torch.Tensor, now: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One serving step (K4): returns (state, out) with `state`
        updated in place.  Padding lanes use out-of-table slots with
        divider 1 and hits 0, so they are inert."""
        return state, sw_serve_step(state, packed, now)

    def step_serve_lanes(
        self, state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K4's by-value form: the same batch as
        step_serve_packed, held in host memory, the readback into `out`
        (pinned host memory on the card).  Returns (state, out); wait on
        the stream before reading `out`."""
        return state, sw_serve_step_lanes(state, words, now, out)

    def step_serve_mapped(
        self, state: torch.Tensor, words: torch.Tensor, now: int, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K4's mapped form: the batch of
        step_serve_packed in pinned host memory, of any width, read by
        the kernel through its device alias, the readback into `out`
        (pinned).  Returns (state, out); wait on the stream before
        reading `out` or reusing `words`."""
        return state, sw_serve_step_mapped(state, words, now, out)

    @staticmethod
    def readback_shape(n: int) -> Tuple[int, ...]:
        """Shape of the int32 readback of an n-lane step: (weighted
        prev, after) rows."""
        return (2, n)

    # -- host half (backends/engine.py generic protocol) ----------------

    def lane_counts(
        self,
        out: np.ndarray,
        dedup,
        hits_u32: np.ndarray,
        limits_u32: np.ndarray,
        now: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-lane (before, after) effective counts from the per-group
        readback, in pipeline order: the weighted-prev term is constant
        per group, so

            before_lane = wprev_g + (after_g - total_g) + prefix_lane

        in exact integer arithmetic.  A group saturated at u32 max is
        treated as fully over, as on the fixed-window path."""
        g = len(dedup.uniq_slots)
        U32_MAX = np.uint64(0xFFFFFFFF)
        wprev_g = out[0, :g].astype(np.int64)
        after_g = out[1, :g].astype(np.uint64)
        saturated = after_g >= U32_MAX
        before_g = np.where(
            saturated, U32_MAX, after_g - np.minimum(dedup.totals, after_g)
        ).astype(np.int64)
        befores = (
            wprev_g[dedup.inv]
            + before_g[dedup.inv]
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
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Numpy twin of K4 over unique in-table slots, on host arrays:
        the host mirror's step (backends/host_engine.py).  Mutates
        ``state`` (uint32[3, num_slots]) in place and returns (wprev,
        after); the f32 ops are the kernel's, in its order.  Runs no
        torch op."""
        win = state[0, slots].copy()
        curr = state[1, slots].copy()
        prev = state[2, slots].copy()
        now_u = np.uint32(now)
        divider = divider.astype(np.uint32)
        w = now_u - now_u % divider
        fresh = fresh.astype(bool)
        same = (win == w) & ~fresh
        adjacent = (win == w - divider) & ~fresh
        new_prev = np.where(same, prev, np.where(adjacent, curr, 0)).astype(
            np.uint32
        )
        base = np.where(same, curr, 0).astype(np.uint32)
        elapsed = now_u - w
        frac = (divider - elapsed).astype(np.float32) / divider.astype(
            np.float32
        )
        wprev = np.floor(new_prev.astype(np.float32) * frac).astype(np.uint32)
        after = np.minimum(
            base.astype(np.uint64) + hits.astype(np.uint64),
            np.uint64(0xFFFFFFFF),
        ).astype(np.uint32)
        state[0, slots] = w
        state[1, slots] = after
        state[2, slots] = new_prev
        return wprev, after
