"""Peaks of one NVIDIA H100 SXM and the least time of a served chunk's
kernel.

The peaks and the host-link rule are copied from the program's
chip_smoke.py (``PEAK_BYTES_PER_S``, ``HOST_LINK_BYTES_PER_S``,
``mapped_bound``) so that a change to the program cannot move this
yardstick.  A served chunk past 128 lanes is one launch whose kernel
reads the staged lanes from pinned host memory and writes the answers
back there, so its least time is the larger of two quotients: the bytes
that must cross the host link in its busier direction over the link's
rate (the link is full duplex), and the bytes that must cross HBM over
its rate.

The bytes are counted from the cell's inputs, not from how the program
packs them: each algorithm's reference gives, for one distinct key of a
chunk (the duplicates of a key are one table row), the bytes it needs in
and out over the host link and through HBM (``BYTES_PER_KEY``).
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at 700 W.
HBM_BYTES_PER_S = 3.35e12
#: PCIe 5.0 x16, one direction.
HOST_LINK_BYTES_PER_S = 64e9


def least_seconds(bytes_per_key, distinct_keys: int) -> float:
    """The least time a chunk of `distinct_keys` keys can take, with
    `bytes_per_key` = (in, out, HBM) bytes a key."""
    inbound, outbound, hbm = bytes_per_key
    link = max(inbound, outbound) * distinct_keys / HOST_LINK_BYTES_PER_S
    return max(link, hbm * distinct_keys / HBM_BYTES_PER_S)
