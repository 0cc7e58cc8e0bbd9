"""Segmented (per-slot) prefix sums for duplicate keys in one batch --
the plain PyTorch version of K2 (ops/prefix_cuda.py).

The reference's Redis pipeline executes INCRBY commands sequentially,
so when the same key appears k times in one batch, the i-th occurrence
observes the counter *including* occurrences 0..i.  For each batch
element this computes the inclusive sum of hits of earlier (and its
own) batch elements targeting the same slot, with the algorithm of
ratelimit_tpu/ops/prefix.py: stable argsort, cumsum, segment base,
unsort.  Sums are taken in int64 and wrap to 32 bits at the end, the
modular u32 result of the reference.
"""

from __future__ import annotations

import torch

from .u32 import narrow, widen


def per_slot_inclusive_prefix(
    slots: torch.Tensor, hits: torch.Tensor
) -> torch.Tensor:
    """For each i: sum of hits[j] for j <= i with slots[j] == slots[i].

    `slots` int32[N]; `hits` int32[N] holding u32 bits.  Returns
    int32[N] holding the u32 sums, on the inputs' device.
    """
    n = slots.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=slots.device)
    # Stable sort groups equal slots while preserving batch order
    # within a group, which is what gives "earlier in the batch" its
    # meaning.
    order = torch.argsort(slots, stable=True)
    sorted_hits = widen(hits)[order]
    sorted_slots = slots[order]

    excl = torch.cumsum(sorted_hits, 0) - sorted_hits
    seg_start = torch.ones(n, dtype=torch.bool, device=slots.device)
    seg_start[1:] = sorted_slots[1:] != sorted_slots[:-1]
    seg_id = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    # excl is non-decreasing, so its value at a segment's start is the
    # segment's base.
    seg_base = excl[seg_start]
    within_incl = excl - seg_base[seg_id] + sorted_hits

    out = torch.empty(n, dtype=torch.int64, device=slots.device)
    out[order] = within_incl
    return narrow(out)
