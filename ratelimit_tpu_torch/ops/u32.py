"""uint32 values held in int32 tensors.

torch has little ``uint32`` arithmetic, so the port keeps every u32
(counters, hits, limits) as an int32 tensor of the same bits -- the
layout the reference's packed transfer already uses
(``bitcast_convert_type``).  The plain versions widen to int64, do the
u32 arithmetic there, and narrow the low 32 bits back.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integer tensor) -> int64 holding the u32 value."""
    return t.to(torch.int64) & U32_MASK


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 tensor holding the low 32 bits (modular)."""
    return (((t & U32_MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def narrow16(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int16 tensor holding the low 16 bits (u16 storage)."""
    return (((t & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
