"""Plumbing shared by the algorithm-bank serving kernels (K4, K5).

Both kernels take the engine's packed int32[5, N] batch -- rows: slots,
hits bits, limit bits, fresh, divider bits -- and the batch clock
``now`` against a [rows, num_slots] state table (int32 tensor of u32
bits), update the table in place and return a narrow per-lane readback.
Each has K1's three forms: the device form reads the batch from device
memory and returns a device tensor; the by-value form takes the batch
in host memory (at most ``MAX_LANES`` lanes, carried in the launch's
parameters) and writes the readback into the caller's `out`, pinned
host memory on the card; the mapped form takes a batch of any width in
pinned host memory, which the kernel reads through its device alias,
and writes the readback into `out` the same way.  This module checks
those inputs, launches a
kernel through ``kernels`` -- or, for a state tensor on the CPU only,
runs its plain version -- and holds the f32-to-integer conversions the
plain versions need to match the kernels and JAX: truncate, saturate at
the type's range, NaN to 0 (PTX ``cvt.rzi``, XLA's convert; numpy's cast
wraps instead).
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import kernels
from ..ops.u32 import U32_MASK
from .fixed_window import _require_cuda, check_lanes_out

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


def _check_state(state: torch.Tensor, rows: int) -> None:
    if state.dtype != torch.int32 or state.dim() != 2 or state.shape[0] != rows:
        raise TypeError(
            f"state must be int32[{rows}, num_slots], got {state.dtype} "
            f"{tuple(state.shape)}"
        )
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")


def check_step_inputs(state: torch.Tensor, rows: int, packed: torch.Tensor) -> None:
    """Raise unless `state` is int32[rows, ns] and `packed` int32[5, N]
    on the same device."""
    _check_state(state, rows)
    if packed.dtype != torch.int32 or packed.dim() != 2 or packed.shape[0] != 5:
        raise TypeError(
            f"packed must be int32[5, N], got {packed.dtype} {tuple(packed.shape)}"
        )
    if packed.device != state.device:
        raise ValueError("packed and state must be on one device")


def now_i32(now: int) -> int:
    """The batch clock as the int32 the kernels take (the JAX engine
    ships ``jnp.asarray(now, jnp.int32)``)."""
    now = int(now)
    if not _I32_MIN <= now <= _I32_MAX:
        raise ValueError(f"now={now} does not fit the kernels' int32 clock")
    return now


def launch(
    fn: str, name: str, state: torch.Tensor, packed: torch.Tensor, now: int,
    out: torch.Tensor,
) -> torch.Tensor:
    """Launch the C function `fn` on CUDA tensors and count it as
    kernel `name`; returns `out`."""
    _require_cuda(state.device)
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    n = packed.shape[1]
    if n == 0:
        return out
    kernels.launch(
        fn,
        name,
        # The by-value form's words and readback are host memory.
        (state, *(t for t in (packed, out) if t.device.type != "cpu")),
        state.data_ptr(),
        state.shape[1],
        packed.data_ptr(),
        n,
        now_i32(now),
        out.data_ptr(),
        kernels.stream_ptr(state.device),
    )
    return out


def step_lanes(
    fn: str,
    name: str,
    plain: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
    state: torch.Tensor,
    rows: int,
    words: torch.Tensor,
    now: int,
    out: torch.Tensor,
    readback_rows: tuple,
    by_value: bool = True,
) -> torch.Tensor:
    """A kernel's by-value form: `state` int32[rows, ns], `words` the
    host int32[5, N] batch (N <= MAX_LANES), the readback into `out`
    int32[*readback_rows, N], a host tensor.  For a state on the CPU
    `plain`'s readback is copied into `out`; on the card the C function
    `fn` is launched and counted as kernel `name`, or raises -- wait on
    the stream (an event) before reading `out`.  Returns `out`.
    `by_value` False lifts the width cap (step_mapped)."""
    _check_state(state, rows)
    if words.dim() != 2:
        raise TypeError(f"words must be int32[5, N], got {tuple(words.shape)}")
    check_lanes_out(words, 5, out, torch.int32, (*readback_rows, words.shape[1]), by_value)
    if state.device.type == "cpu":
        return out.copy_(plain(state, words, now))
    return launch(fn, name, state, words, now, out)


def step_mapped(
    fn: str,
    name: str,
    plain: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
    state: torch.Tensor,
    rows: int,
    words: torch.Tensor,
    now: int,
    out: torch.Tensor,
    readback_rows: tuple,
) -> torch.Tensor:
    """A kernel's mapped form: as step_lanes, on a batch `words` of any
    width in PINNED host memory, which the kernel reads through its
    device alias while it runs, the readback into the pinned `out` the
    same way.  On the card, pageable `words` or `out` raise KernelError
    and a device tensor ValueError; nothing falls back.  Keep `words`
    and wait on the stream (an event) before reading `out` or reusing
    either.  Returns `out`."""
    return step_lanes(fn, name, plain, state, rows, words, now, out, readback_rows, by_value=False)


def f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 holding the u32 that ``cvt.rzi.u32.f32`` gives:
    truncated, clamped to [0, 2^32 - 1], NaN -> 0."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)  # tpu-lint: disable=dtype-pack-contract -- host-side emulation of cvt.rzi.u32.f32 in the plain version: the clamp bound 2^32 - 1 is not an f32; no kernel argument or transfer is f64
    return torch.trunc(x).clamp(0.0, float(U32_MASK)).to(torch.int64)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as ``cvt.rzi.s32.f32``: truncated, clamped to
    the int32 range, NaN -> 0."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)  # tpu-lint: disable=dtype-pack-contract -- host-side emulation of cvt.rzi.s32.f32 in the plain version (exact int32 bounds); no kernel argument or transfer is f64
    return torch.trunc(x).clamp(float(_I32_MIN), float(_I32_MAX)).to(torch.int32)
