"""K2: the per-slot inclusive prefix as a hand-written CUDA kernel.

Port of the Pallas TPU kernel ratelimit_tpu/ops/prefix_pallas.py
(``_prefix_kernel``, ``pl.pallas_call`` at line 82).  The kernel is
csrc/prefix.cu: the launcher zeroes the output, then one block per
lower-triangle pair of 128-lane tiles (528 blocks at N = 4096) adds its
partial sums into it with modular atomics, which is exact in any
order.  Its bound and limits are described there.  Unlike the Pallas
kernel it takes any N >= 1, not only multiples of 128.  Its tile pass
(csrc/prefix_tiles.cuh) is also phase B of the fused general step (K3,
K7), which zeroes its own scratch: the forward steps never launch this
kernel alone.

On a CUDA tensor the wrapper launches the kernel (or raises); only a
tensor on the CPU takes the plain version, ops/prefix.py.
"""

from __future__ import annotations

import torch

from .. import kernels
from .prefix import per_slot_inclusive_prefix

KERNEL = "per_slot_inclusive_prefix"


def per_slot_inclusive_prefix_cuda(
    slots: torch.Tensor, hits: torch.Tensor
) -> torch.Tensor:
    """Drop-in for ops.prefix.per_slot_inclusive_prefix: `slots`
    int32[N], `hits` int32[N] of u32 bits -> int32[N] of u32 sums."""
    if slots.dim() != 1 or hits.shape != slots.shape:
        raise ValueError(
            f"slots and hits must be 1-D of one length, got "
            f"{tuple(slots.shape)} and {tuple(hits.shape)}"
        )
    if slots.dtype != torch.int32 or hits.dtype != torch.int32:
        raise TypeError(
            f"slots and hits must be int32, got {slots.dtype} and {hits.dtype}"
        )
    if slots.device != hits.device:
        raise ValueError("slots and hits must be on one device")
    if slots.device.type == "cpu":
        return per_slot_inclusive_prefix(slots, hits)
    if slots.device.type != "cuda":
        raise ValueError(f"unsupported device {slots.device}")
    if not (slots.is_contiguous() and hits.is_contiguous()):
        raise ValueError("slots and hits must be contiguous")
    n = slots.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=slots.device)
    if n == 0:
        return out
    kernels.launch(
        "rl_per_slot_inclusive_prefix",
        KERNEL,
        (slots, hits, out),
        slots.data_ptr(),
        hits.data_ptr(),
        out.data_ptr(),
        n,
        kernels.stream_ptr(slots.device),
    )
    return out
