"""Sharded fixed-window counter model: the slot space split into banks.

Port of ratelimit_tpu/parallel/sharded.py.  The counter table is int32
of u32 bits laid out (num_banks, slots_per_bank), bank-major, like the
JAX model's device layout.  Bank ownership is MODULO-STRIPED: global
slot s lives in bank ``s % num_banks`` at local position
``s // num_banks``, so the host slot table's dense allocation spreads
over every bank from the first key.

The JAX model puts one bank on each chip of a ``Mesh`` and recombines
per-lane answers with a ``psum``.  Here a mesh (:func:`make_mesh`)
places its banks in GROUPS, one device each: group g holds the
contiguous banks [g k, (g + 1) k) as one int32[k, slots_per_bank]
tensor on its device.  ``make_mesh()`` gives one bank per visible card,
as the JAX package's takes every local device; ``make_mesh(n, device)``
one group of n banks; ``make_mesh(n, devices=...)`` one group per listed
device, which may repeat (several groups on one card, sharing that
card's stream in the engine).  A state is the one group's tensor, or a
tuple of the groups' tensors; ``ShardedFixedWindowModel.parts`` and
``join`` are the only code that tells the two apart.
``Mesh.card_groups`` gives the per-card plan (``CardPlan``): the groups a
card holds, its link, its bank rows and its stream.

Three kernels, in csrc/sharded.cu:

- K6 ``sharded_routed_step``, the serving step: the engine routes each
  unique slot to its bank on the host (local ids, one packed
  int32[num_banks, 4, cap] batch) and one launch serves every bank --
  fresh-zero, gather, SATURATING add, unique scatter-set, narrow
  readback.  The engine serves from its pinned staging in the form
  ``fixed_window.lanes_by_value`` picks from the shape alone: up to 128
  routed lanes (banks x cap) by value, ``sharded_routed_step_lanes``
  (the batch rides in the launch's parameters), past that mapped,
  ``sharded_routed_step_mapped`` (the kernel reads the staged batch
  through its device alias); either way the readback lands in pinned
  host memory and the chunk is one launch.  ``sharded_routed_step``
  itself takes a batch in device memory (the JAX-named API).  Routing
  is done on the host, so K6 needs no collective.  Over several groups
  K6 has a CARD form, ONE launch over the banks of every group a card
  holds (``sharded_routed_card_step``, by value
  ``sharded_routed_card_step_lanes``, mapped
  ``sharded_routed_card_step_mapped``), and the mesh's served chunk is
  ONE host call that launches it on every card
  (``mesh_routed_step_lanes``, ``mesh_routed_step_mapped``, and
  ``mesh_routed_step`` on device tensors: the mesh entries,
  kernels.launch_mesh);
- K7, the duplicate-tolerant step over a replicated batch of GLOBAL
  ids: zero fresh slots, gather, the per-slot prefix (K2's tile pass)
  on the raw ids, MODULAR scatter-add, with an optional narrow readback
  or the decision block -- K3's fused general step under another index
  policy.  A group of every bank owns every lane: one launch, counted
  as ``sharded_general_update`` or ``sharded_general_step``.  Over
  several groups, ONE cooperative launch a card over every group it
  holds (``sharded_card_step``, counted as ``sharded_card_update`` or
  ``sharded_card_step``): each card works on its own groups' banks and
  stores the lanes it owns into the one output on the home device
  (the first group's) -- in place on the home card, through a peer
  mapping from another.  Each lane has one owner, so those stores are
  JAX's ``psum``.  Every such card's launch is enqueued by ONE host
  call (``rl_mesh_card_step``, the counterpart of JAX's one SPMD
  dispatch);
- ``sharded_combine``, the ``psum`` where a card cannot map the home
  card (Mesh.links): such a card's owned lanes in ONE partial on its own
  card, copied home in one copy, and one launch that puts each lane a
  combine card owns into the home output, in place.

Like the single-table steps, K6 and K7 update the table IN PLACE.  Each
wrapper launches its kernel for a CUDA tensor, under that tensor's
device (kernels.launch), or raises, and runs its plain PyTorch version,
kept beside it, only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..backends.engine import (
    _HOST_VIEW,
    DEFAULT_BUCKETS,
    STAGING_POOL_CAP,
    CounterEngine,
    _stream_context,
    _Staging,
    claim_stream,
    release_stream,
)
from ..models import fixed_window as fw
from ..models.fixed_window import (
    DeviceBatch,
    DeviceDecisions,
    lanes_by_value,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
)
from ..ops.prefix import per_slot_inclusive_prefix
from ..ops.u32 import narrow, widen

K6 = "sharded_routed_step"
K6_LANES = "sharded_routed_step_lanes"
K6_MAPPED = "sharded_routed_step_mapped"
K6_CARD = "sharded_routed_card_step"
K6_CARD_LANES = "sharded_routed_card_step_lanes"
K6_CARD_MAPPED = "sharded_routed_card_step_mapped"
K7 = "sharded_general_update"
K7_STEP = "sharded_general_step"
K7_CARD = "sharded_card_update"
K7_CARD_STEP = "sharded_card_step"
COMBINE = "sharded_combine"

#: The most groups a mesh may have: one card's launch of K7 carries a
#: table pointer for each (csrc/counter_update.cuh kMaxGroups).
MAX_GROUPS = 256
#: How a card's owned lanes reach the home device's output (Mesh.links).
LINKS = ("home", "peer", "combine")
#: The mesh entries: every card's launch in one host call.
MESH_ROUTED = "rl_mesh_routed_step"
MESH_ROUTED_LANES = "rl_mesh_routed_step_lanes"
MESH_ROUTED_MAPPED = "rl_mesh_routed_step_mapped"
MESH_CARD = "rl_mesh_card_step"


class CardPlan(NamedTuple):
    """One card's share of a mesh: the groups it holds (ascending), how
    K7's owned lanes reach the home output (``link``, Mesh.links), the
    bank rows those groups hold in order (K6's rows of the routed batch
    on this card), the card's device, and the stream its work goes on
    (None: that device's current stream)."""

    groups: Tuple[int, ...]
    link: str
    rows: Tuple[int, ...]
    device: torch.device
    stream: object = None


@dataclass(frozen=True)
class Mesh:
    """``num_banks`` counter banks in ``len(devices)`` equal groups, group
    g on ``devices[g]``: the port's counterpart of the JAX package's 1-D
    device mesh.  ``device``, the first group's, is the home device: it
    holds the batch, the recombined answers and the engine's host work.

    ``links`` says, for each card (``cards``, the home card first), how
    K7 brings the lanes that card owns to the home device: "home" for the
    home card, "peer" for a card that stores into the home card's memory
    through a peer mapping, "combine" for one that cannot (its partial is
    copied home and sharded_combine puts its lanes in place).  make_mesh
    reads it from the topology; a mesh built without it takes "combine"
    for every card past the home one, the way that needs no mapping."""

    num_banks: int
    devices: Tuple[torch.device, ...]
    links: Tuple[str, ...] = ()

    def __post_init__(self):
        # One device names a mesh of one group.
        if isinstance(self.devices, torch.device):
            object.__setattr__(self, "devices", (self.devices,))
        cards = len(self.cards)
        if not self.links:
            object.__setattr__(self, "links", ("home",) + ("combine",) * (cards - 1))
        links = tuple(self.links)
        if len(links) != cards or links[:1] != ("home",) or not set(links[1:]) <= set(LINKS[1:]):
            raise ValueError(f"links {links} do not fit {cards} cards: the home card's is "
                             f"'home', every other's 'peer' or 'combine'")
        object.__setattr__(self, "links", links)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the groups, the home device first."""
        return tuple(dict.fromkeys(self.devices))

    def card_groups(self, streams: Sequence = ()) -> Tuple[CardPlan, ...]:
        """The per-card plan (CardPlan: groups, link, rows, device and
        stream) of each card, the home card's first: what a served chunk
        (K6's card form) and grouped_general_step (K7) launch over.
        `streams` gives each card's stream, in that order (the engine's
        claimed streams); by default none."""
        k = self.banks_per_group
        streams = tuple(streams) or (None,) * len(self.cards)
        plans = []
        for card, link, stream in zip(self.cards, self.links, streams):
            groups = tuple(g for g, d in enumerate(self.devices) if d == card)
            rows = tuple(b for g in groups for b in range(g * k, (g + 1) * k))
            plans.append(CardPlan(groups, link, rows, card, stream))
        return tuple(plans)

    def paths(self) -> dict:
        """How K7's psum crosses each pair of a card and the home card:
        {"cuda:1->cuda:0": "peer" or "combine"}; empty on one card."""
        return {f"{card}->{self.device}": link
                for card, link in zip(self.cards[1:], self.links[1:])}

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def groups(self) -> int:
        return len(self.devices)

    @property
    def banks_per_group(self) -> int:
        return self.num_banks // len(self.devices)


def make_mesh(n_banks: Optional[int] = None, device=None, devices=None) -> Mesh:
    """A mesh of `n_banks` banks.

    - ``make_mesh()``: one bank per visible card, one group each, as the
      JAX package's ``make_mesh()`` takes every local device;
    - ``make_mesh(n_banks, device)``: one group of `n_banks` banks on
      `device` ("cuda" by default; `n_banks` None: one bank);
    - ``make_mesh(n_banks, devices=[...])``: one group per listed device,
      `n_banks` (default one per device) split evenly over them.  A
      device may repeat: groups that share a card each get their own
      tensor and, in the engine, their own stream.

    On several cards the mesh's links come from the topology: each card
    that can map the home card's memory (cudaDeviceCanAccessPeer) gets
    the mapping enabled here, once, and stores its lanes there ("peer");
    any other card takes the combine.  Devices of the CPU share one
    memory, so "cpu:0", "cpu:1", ... are cards of one host that all map
    each other: the CPU tests rehearse a mesh of several cards so.

    Raises ValueError for no bank, banks that do not split evenly, no
    device, devices of two types, more than MAX_GROUPS groups, or both
    `device` and `devices`."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass either device or devices, not both")
        devices = tuple(resolve_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(
                "a mesh's devices must be of one type, got "
                + ", ".join(str(d) for d in devices)
            )
    else:
        d = torch.device("cuda" if device is None else device)
        if n_banks is None and d.type == "cuda" and d.index is None:
            resolve_device(torch.device("cuda", 0))  # raises without CUDA
            devices = tuple(
                torch.device("cuda", i) for i in range(torch.cuda.device_count())
            )
        else:
            devices = (resolve_device(d),)
    n_banks = len(devices) if n_banks is None else int(n_banks)
    if n_banks < 1:
        raise ValueError(f"a mesh needs at least one bank, got {n_banks}")
    if n_banks % len(devices):
        raise ValueError(
            f"{n_banks} banks do not split evenly over {len(devices)} groups"
        )
    if len(devices) > MAX_GROUPS:
        raise ValueError(
            f"{len(devices)} groups: one card's launch of K7 carries at most {MAX_GROUPS}"
        )
    home = devices[0]
    cards = tuple(dict.fromkeys(devices))
    links = ("home",) + tuple(
        "peer" if card.type != "cuda" or kernels.enable_peer(card.index, home.index)
        else "combine"
        for card in cards[1:]
    )
    return Mesh(n_banks, devices, links)


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
    kernels.launch(
        "rl_sharded_routed_step",
        K6,
        (counts, packed, out),
        counts.data_ptr(),
        spb,
        packed.data_ptr(),
        nb,
        cap,
        out.data_ptr(),
        fw._OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
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
    # words and out are host memory; the kernel reaches `out` through
    # the alias taken under the table's device (csrc/by_value.cuh).
    kernels.launch(
        "rl_sharded_routed_step_lanes",
        K6_LANES,
        (counts,),
        counts.data_ptr(),
        counts.shape[1],
        words.data_ptr(),
        nb,
        cap,
        out.data_ptr(),
        fw._OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    return out


def sharded_routed_step_mapped(
    counts: torch.Tensor, words: torch.Tensor, out: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K6's mapped form: the same step as sharded_routed_step on an
    int32[num_banks, 4, cap] batch of any width held in PINNED host
    memory, which the kernel reads through its device alias; the
    readback goes into `out` (OUT_DTYPES[out_dtype][num_banks, cap]),
    pinned host memory written the same way.  On a CUDA table, pageable
    memory raises KernelError and a device tensor ValueError; there is no
    fallback.  Only enqueued: keep `words` and wait on the stream (an
    event) before reading `out` or reusing either.  Returns `out`."""
    nb, spb = _check_banked(counts)
    fw._check_unique_lanes(words, out, out_dtype, by_value=False)
    if words.dim() != 3 or words.shape[0] != nb:
        raise TypeError(f"words must be int32[{nb}, 4, cap], got {tuple(words.shape)}")
    if counts.device.type == "cpu":
        return out.copy_(_routed_step_plain(counts, words, out_dtype))
    fw._require_cuda(counts.device)
    if nb > 65535:
        raise ValueError(f"at most 65535 banks per launch, got {nb}")
    cap = words.shape[2]
    if cap == 0:
        return out
    kernels.launch(
        "rl_sharded_routed_step_mapped", K6_MAPPED, (counts,),
        counts.data_ptr(), spb, words.data_ptr(), nb, cap, out.data_ptr(),
        fw._OUT_KIND[out_dtype], kernels.stream_ptr(counts.device),
    )
    return out


# -- K6's card form: every group a card holds, one launch ----------------


def _routed_card_step_plain(
    tables: Sequence[torch.Tensor], packed: torch.Tensor, out_dtype: str
) -> torch.Tensor:
    """Plain version of K6's card form: _routed_step_plain on each group
    the card holds, over that group's rows of the card's batch."""
    k = tables[0].shape[0]
    return torch.cat(
        [_routed_step_plain(t, packed[h * k : (h + 1) * k], out_dtype)
         for h, t in enumerate(tables)]
    )


def _check_card_tables(tables: Sequence[torch.Tensor], one_device: bool = True):
    """(banks a group, slots a bank) of group tables, which must be
    alike, at most MAX_GROUPS, and -- one card's -- on one device."""
    if not tables or len(tables) > MAX_GROUPS:
        raise ValueError(f"1 to {MAX_GROUPS} group tables, got {len(tables)}")
    k, spb = _check_banked(tables[0])
    for t in tables:
        if _check_banked(t) != (k, spb):
            raise ValueError(f"group tables must be int32[{k}, {spb}] alike")
    if one_device:
        kernels.device_of(*tables)
    return k, spb


def _check_card_batch(batch: torch.Tensor, rows: int) -> int:
    if batch.dtype != torch.int32 or batch.dim() != 3 or batch.shape[:2] != (rows, 4):
        raise TypeError(
            f"a card's batch must be int32[{rows}, 4, cap], got {batch.dtype} "
            f"{tuple(batch.shape)}"
        )
    return batch.shape[2]


def _card_ptrs(tables: Sequence[torch.Tensor]):
    return kernels.pointers([t.data_ptr() for t in tables])


def sharded_routed_card_step(
    tables: Sequence[torch.Tensor], packed: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K6's card form: the serving step of every bank of the groups one
    card holds, in ONE launch.  `tables` are the card's group tensors
    (each int32[k, slots_per_bank], one device), `packed` its rows of the
    routed batch, int32[len(tables) x k, 4, cap] group by group (LOCAL
    ids, as sharded_routed_step's).  Returns the readback [len(tables) x
    k, cap] as sharded_routed_step's; updates the tables in place."""
    if out_dtype not in fw.OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {sorted(fw.OUT_DTYPES)}")
    k, spb = _check_card_tables(tables)
    rows = len(tables) * k
    cap = _check_card_batch(packed, rows)
    dev = kernels.device_of(*tables, packed)
    if dev.type == "cpu":
        return _routed_card_step_plain(tables, packed, out_dtype)
    fw._require_cuda(dev)
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if rows > 65535:
        raise ValueError(f"at most 65535 banks a card launch, got {rows}")
    out = torch.empty((rows, cap), dtype=fw.OUT_DTYPES[out_dtype], device=dev)
    if cap == 0:
        return out
    ptrs = _card_ptrs(tables)
    kernels.launch(
        "rl_sharded_routed_card_step", K6_CARD, (*tables, packed, out),
        ctypes.addressof(ptrs), len(tables), k, spb, packed.data_ptr(), cap, out.data_ptr(),
        fw._OUT_KIND[out_dtype], kernels.stream_ptr(dev),
    )
    return out


def sharded_routed_card_step_lanes(
    tables: Sequence[torch.Tensor], words: torch.Tensor, out: torch.Tensor,
    out_dtype: str = "",
) -> torch.Tensor:
    """K6's card form by value: sharded_routed_card_step's batch held in
    HOST memory (len(tables) x k x cap <= 128 lanes), carried by the
    launch as parameters, the readback into `out` (pinned host memory on
    a card, written through its device alias).  Only enqueued on a card:
    wait on the stream before reading `out`.  Returns `out`."""
    k, _ = _check_card_tables(tables)
    fw._check_unique_lanes(words, out, out_dtype)
    cap = _check_card_batch(words, len(tables) * k)
    dev = tables[0].device
    if dev.type == "cpu":
        return out.copy_(_routed_card_step_plain(tables, words, out_dtype))
    fw._require_cuda(dev)
    if cap == 0:
        return out
    ptrs = _card_ptrs(tables)
    kernels.launch(
        "rl_sharded_routed_card_step_lanes", K6_CARD_LANES, tables,
        ctypes.addressof(ptrs), len(tables), k, tables[0].shape[1], words.data_ptr(), cap,
        out.data_ptr(), fw._OUT_KIND[out_dtype], kernels.stream_ptr(dev),
    )
    return out


def sharded_routed_card_step_mapped(
    tables: Sequence[torch.Tensor], words: torch.Tensor, out: torch.Tensor,
    out_dtype: str = "",
) -> torch.Tensor:
    """K6's card form mapped: sharded_routed_card_step's batch, of any
    width, held in PINNED host memory and read by the kernel through its
    device alias, the readback into `out` (pinned, written likewise).
    Only enqueued on a card: keep `words` and wait on the stream before
    reading `out`.  Returns `out`."""
    k, spb = _check_card_tables(tables)
    fw._check_unique_lanes(words, out, out_dtype, by_value=False)
    rows = len(tables) * k
    cap = _check_card_batch(words, rows)
    dev = tables[0].device
    if dev.type == "cpu":
        return out.copy_(_routed_card_step_plain(tables, words, out_dtype))
    fw._require_cuda(dev)
    if rows > 65535:
        raise ValueError(f"at most 65535 banks a card launch, got {rows}")
    if cap == 0:
        return out
    ptrs = _card_ptrs(tables)
    kernels.launch(
        "rl_sharded_routed_card_step_mapped", K6_CARD_MAPPED, tables,
        ctypes.addressof(ptrs), len(tables), k, spb, words.data_ptr(), cap,
        out.data_ptr(), fw._OUT_KIND[out_dtype], kernels.stream_ptr(dev),
    )
    return out


def _card_stream(card: CardPlan):
    """The raw handle of the stream a card's work goes on."""
    stream = card.stream if card.stream is not None else torch.cuda.current_stream(card.device)
    return stream.cuda_stream


def _mesh_frame(parts, cards):
    """The per-card arrays every mesh entry of K6 takes -- device
    ordinals, streams, the cards' group tables end to end, groups a card
    -- and each card's tables."""
    held = [[parts[g] for g in card.groups] for card in cards]
    return held, (
        kernels.ints([card.device.index for card in cards]),
        kernels.pointers([_card_stream(card) for card in cards]),
        kernels.pointers([t.data_ptr() for tables in held for t in tables]),
        kernels.ints([len(tables) for tables in held]),
    )


def _check_mesh_batches(parts, cards, batches, outs, out_dtype):
    """The common checks of a mesh's K6 arguments; returns cap."""
    if out_dtype not in fw.OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {sorted(fw.OUT_DTYPES)}")
    if not (len(cards) == len(batches) == len(outs)):
        raise ValueError(f"{len(cards)} cards, {len(batches)} batches, {len(outs)} outputs")
    k, _ = _check_card_tables(parts, one_device=False)
    caps = {_check_card_batch(b, len(card.groups) * k) for card, b in zip(cards, batches)}
    if len(caps) != 1:
        raise ValueError(f"every card's batch must have one cap, got {sorted(caps)}")
    cap = caps.pop()
    dtype = fw.OUT_DTYPES[out_dtype]
    for card, o in zip(cards, outs):
        if o.dtype != dtype or tuple(o.shape) != (len(card.groups) * k, cap):
            raise TypeError(f"a card's readback must be {dtype}[{len(card.groups) * k}, {cap}], "
                            f"got {o.dtype} {tuple(o.shape)}")
    return cap


def _mesh_host(parts, cards, words, outs, out_dtype, events, by_value: bool, launch):
    """mesh_routed_step_lanes' and mesh_routed_step_mapped's checks, the
    plain version on the CPU, and `launch` on a card."""
    cap = _check_mesh_batches(parts, cards, words, outs, out_dtype)
    for w, o in zip(words, outs):
        fw._check_unique_lanes(w, o, out_dtype, by_value)
    if parts[0].device.type == "cpu":
        for card, w, o in zip(cards, words, outs):
            o.copy_(_routed_card_step_plain([parts[g] for g in card.groups], w, out_dtype))
        return outs
    fw._require_cuda(parts[0].device)
    return launch(parts, cards, words, outs, out_dtype, cap, events)


def mesh_routed_step_lanes(
    parts: Sequence[torch.Tensor], cards: Sequence[CardPlan], words, outs,
    out_dtype: str = "", events=None,
):
    """K6's card form by value on EVERY card of a mesh in ONE host call
    (rl_mesh_routed_step_lanes): `parts` the mesh's group tensors,
    `cards` its plan (Mesh.card_groups), words[c] and outs[c] card c's
    host batch int32[rows, 4, cap] and pinned readback [rows, cap] (rows:
    its groups' banks, in order), each at most 128 lanes.  Each card's
    launch goes on its plan's stream, then events[c] (a torch.cuda.Event
    made on that card, or None) is recorded there.  Counted as one
    sharded_routed_card_step_lanes a card.  On the CPU each card runs the
    plain version.  Returns `outs`."""
    return _mesh_host(parts, cards, words, outs, out_dtype, events, True,
                      launch_mesh_routed_lanes)


def mesh_routed_step_mapped(
    parts: Sequence[torch.Tensor], cards: Sequence[CardPlan], words, outs,
    out_dtype: str = "", events=None,
):
    """K6's card form mapped on EVERY card of a mesh in ONE host call
    (rl_mesh_routed_step_mapped): as mesh_routed_step_lanes, of any width,
    words[c] pinned host memory that card c's kernel reads through its
    device alias.  Counted as one sharded_routed_card_step_mapped a
    card.  Returns `outs`."""
    return _mesh_host(parts, cards, words, outs, out_dtype, events, False,
                      launch_mesh_routed_mapped)


def _launch_mesh_host(entry, kernel, parts, cards, words, outs, out_dtype, cap, events):
    """One call of the mesh entry `entry` (by value or mapped) on checked
    arguments, counted as one `kernel` a card."""
    if cap == 0:
        return outs
    held, frame = _mesh_frame(parts, cards)
    ws = kernels.pointers([w.data_ptr() for w in words])
    os_ = kernels.pointers([o.data_ptr() for o in outs])
    evs = kernels.pointers([None if e is None else e.cuda_event for e in events or [None] * len(cards)])
    kernels.launch_mesh(
        entry, kernel, held, len(cards),
        *(ctypes.addressof(a) for a in frame), parts[0].shape[0], parts[0].shape[1],
        ctypes.addressof(ws), cap, ctypes.addressof(os_), fw._OUT_KIND[out_dtype],
        ctypes.addressof(evs),
    )
    return outs


def launch_mesh_routed_lanes(parts, cards, words, outs, out_dtype, cap, events=None):
    """mesh_routed_step_lanes' launch, on checked arguments: one call of
    rl_mesh_routed_step_lanes."""
    return _launch_mesh_host(MESH_ROUTED_LANES, K6_CARD_LANES, parts, cards, words, outs,
                             out_dtype, cap, events)


def launch_mesh_routed_mapped(parts, cards, words, outs, out_dtype, cap, events=None):
    """mesh_routed_step_mapped's launch, on checked arguments: one call of
    rl_mesh_routed_step_mapped."""
    return _launch_mesh_host(MESH_ROUTED_MAPPED, K6_CARD_MAPPED, parts, cards, words, outs,
                             out_dtype, cap, events)


def mesh_routed_step(
    parts: Sequence[torch.Tensor], cards: Sequence[CardPlan], packed, outs,
    out_dtype: str = "", events=None,
):
    """K6's card form in the device form on EVERY card of a mesh in ONE
    host call (rl_mesh_routed_step): packed[c] and outs[c] card c's batch
    int32[rows, 4, cap] and readback [rows, cap] in its memory, then
    events[c] recorded on the card's stream.  Counted as one
    sharded_routed_card_step a card.  On the CPU each card runs the plain
    version.  Returns `outs`."""
    cap = _check_mesh_batches(parts, cards, packed, outs, out_dtype)
    if parts[0].device.type == "cpu":
        for c, card in enumerate(cards):
            tables = [parts[g] for g in card.groups]
            outs[c].copy_(_routed_card_step_plain(tables, packed[c], out_dtype))
        return outs
    fw._require_cuda(parts[0].device)
    if any(not p.is_contiguous() for p in packed):
        raise ValueError("packed must be contiguous")
    return launch_mesh_routed(parts, cards, packed, outs, out_dtype, cap, events)


def launch_mesh_routed(parts, cards, packed, outs, out_dtype, cap, events=None):
    """mesh_routed_step's launch, on checked arguments: one call of
    rl_mesh_routed_step."""
    held, frame = _mesh_frame(parts, cards)
    n = len(cards)
    pk = kernels.pointers([p.data_ptr() for p in packed])
    os_ = kernels.pointers([o.data_ptr() for o in outs])
    evs = kernels.pointers([None if e is None else e.cuda_event for e in events or [None] * n])
    kernels.launch_mesh(
        MESH_ROUTED, K6_CARD, [(*t, p, o) for t, p, o in zip(held, packed, outs)], n,
        *(ctypes.addressof(a) for a in frame), parts[0].shape[0], parts[0].shape[1],
        ctypes.addressof(pk), cap, ctypes.addressof(os_), fw._OUT_KIND[out_dtype],
        ctypes.addressof(evs),
    )
    return outs


# -- K7: duplicate-tolerant update over global ids ----------------------


def _card_update_plain(
    tables: Sequence[Optional[torch.Tensor]],
    groups: Sequence[int],
    num_banks: int,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7's update on one card: the groups `groups` of a
    `num_banks`-bank table, group g's banks [g k, (g + 1) k) held as
    tables[g] int32[k, slots_per_bank] (in place).  Returns the int64
    afters -- a lane whose bank lies in another group reads a zero
    counter, as on another chip -- and each lane's owner group (its
    bank's; group 0 for an id out of the table)."""
    k, spb = tables[groups[0]].shape
    s = slots.to(torch.int64)
    # Only [0, ns) is in the table: negative ids never wrap here.
    in_table = (s >= 0) & (s < num_banks * spb)
    bank = s % num_banks
    owner = torch.where(in_table, bank // k, torch.zeros_like(s))
    before = torch.zeros_like(s)
    for g in groups:
        mine = in_table & (owner == g)
        pos = torch.where(mine, (bank - g * k) * spb + s // num_banks, torch.zeros_like(s))
        table = tables[g].view(-1)
        table[pos[mine & fresh]] = 0
        before = torch.where(mine, widen(table[pos]), before)
        touched = pos[mine]
        total = torch.zeros(k * spb, dtype=torch.int64, device=table.device)
        total.index_add_(0, touched, widen(hits)[mine])
        table[touched] = narrow(widen(table[touched]) + total[touched])
    return before + widen(per_slot_inclusive_prefix(slots, hits)), owner


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
    afters, _ = _card_update_plain([counts], (0,), counts.shape[0], slots, hits, fresh)
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
    slots_per_bank) table, in one launch of the fused general step (the
    group entry over every bank).  An
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
        "rl_sharded_group_step", (nb, 0, nb, spb), K7,
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
        "rl_sharded_group_step", (nb, 0, nb, spb), K7_STEP,
        counts, slots, hits, fresh, limits, shadow=shadow, near_ratio=near_ratio,
    )


# -- K7 over bank groups: one launch a card, and the combine -------------

#: An output's rows by width: (u32 rows, u16 rows, u8 rows) of [n] each,
#: in that order, for each epilogue of the general step ("decide": the
#: decision block's eight u32 fields, then set_local_cache).
LAYOUTS = {"": (1, 0, 0), "uint16": (0, 1, 0), "uint8": (0, 0, 1), "decide": (8, 0, 1)}
_ROW_DTYPES = (torch.int32, torch.int16, torch.uint8)


def partial_bytes(layout: str, n: int) -> int:
    """Bytes of one output of `n` lanes in `layout`."""
    r32, r16, r8 = LAYOUTS[layout]
    return (4 * r32 + 2 * r16 + r8) * n


def _rows(buf: torch.Tensor, layout: str, n: int):
    """The typed [rows, n] views of an output's bytes `buf` (uint8, from
    offset 0), one a width that `layout` uses."""
    views, at = [], 0
    for rows, dtype in zip(LAYOUTS[layout], _ROW_DTYPES):
        if rows:
            width = rows * dtype.itemsize * n
            views.append(buf[at : at + width].view(dtype).view(rows, n))
            at += width
    return views


def unpack_partial(buf: torch.Tensor, layout: str, n: int):
    """The typed result an output's bytes `buf` (uint8, from offset 0)
    hold: DeviceDecisions ("decide"), int32 afters (""), or the uint8 /
    int16-stored uint16 readback -- views of `buf`."""
    if layout == "decide":
        words = buf[: 32 * n].view(torch.int32).view(8, n)
        return DeviceDecisions(*words.unbind(0), buf[32 * n : 33 * n].view(torch.bool))
    return buf[: partial_bytes(layout, n)].view(fw.OUT_DTYPES[layout])


def _pack_partial(result, n: int) -> torch.Tensor:
    """A typed result as its output's bytes (inverse of unpack_partial)."""
    fields = list(result) if isinstance(result, DeviceDecisions) else [result]
    return torch.cat([f.contiguous().view(torch.uint8).reshape(-1) for f in fields])


def _card_step_plain(tables, groups, num_banks, slots, hits, fresh, limits, layout,
                     shadow, near_ratio, out) -> torch.Tensor:
    """Plain version of sharded_card_step: the card's groups updated in
    place, each lane they own written into `out`, and nothing else."""
    afters, owner = _card_update_plain(tables, groups, num_banks, slots, hits, fresh)
    if layout == "decide":
        result = fw._decision_block_plain(narrow(afters), hits, limits, shadow, near_ratio)
    elif layout == "":
        result = narrow(afters)
    else:
        result = fw.readback_plain(afters, widen(hits), widen(limits), layout)
    n = slots.shape[0]
    size = partial_bytes(layout, n)
    lanes = torch.isin(owner, torch.tensor(groups, dtype=owner.dtype, device=owner.device))
    for d, f in zip(_rows(out[:size], layout, n), _rows(_pack_partial(result, n), layout, n)):
        d[:, lanes] = f[:, lanes]
    return out


def sharded_card_step(
    tables: Sequence[Optional[torch.Tensor]],
    groups: Sequence[int],
    num_banks: int,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor],
    layout: str,
    shadow: Optional[torch.Tensor],
    near_ratio: float,
    out: torch.Tensor,
) -> torch.Tensor:
    """K7 on ONE card over every group it holds: `tables` are the mesh's
    group tensors (group g int32[k, slots_per_bank], the banks [g k, (g +
    1) k) of `num_banks`), `groups` those on this card, where the
    replicated batch of global ids lies.  The card zeroes, gathers and
    scatters only its groups' slots; the per-slot prefix runs over the
    whole batch.  For each lane the card OWNS -- its groups' ids, and ids
    out of the table where it holds group 0 -- the epilogue `layout` ("",
    "uint8", "uint16" or "decide", which needs `shadow` and `near_ratio`)
    goes into `out` (uint8, partial_bytes(layout, n) bytes at least);
    every other byte of `out` is left as it was.  On a card, `out` may lie on another card
    that this one maps (make_mesh); the launch is ordered on this card's
    current stream, and the caller orders the output's reader after it.
    One cooperative launch, counted as sharded_card_step ("decide") or
    sharded_card_update; updates the tables in place.  Returns `out`."""
    groups = tuple(groups)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}")
    if not groups or len(set(groups)) != len(groups) or not all(
        0 <= g < len(tables) for g in groups
    ):
        raise ValueError(f"groups {groups} are not groups of {len(tables)}")
    if len(tables) > MAX_GROUPS or num_banks % len(tables):
        raise ValueError(f"{len(tables)} groups do not split {num_banks} banks (at most "
                         f"{MAX_GROUPS} groups)")
    k = num_banks // len(tables)
    here = [tables[g] for g in groups]
    for t in here:
        if _check_banked(t)[0] != k or t.shape != here[0].shape:
            raise ValueError(f"group tables must be int32[{k}, slots_per_bank] alike")
    decide = layout == "decide"
    fw.check_general_lanes(
        here[0], slots, hits, fresh, limits, "" if decide else layout,
        shadow=shadow if decide else None,
    )
    if decide and (limits is None or shadow is None):
        raise ValueError("the decision block needs the limits and shadow lanes")
    n = slots.shape[0]
    size = partial_bytes(layout, n)
    if out.dtype != torch.uint8 or out.dim() != 1 or not out.is_contiguous():
        raise TypeError(f"out must be contiguous uint8[bytes], got {out.dtype} "
                        f"{tuple(out.shape)}")
    if out.shape[0] < size:
        raise ValueError(f"out of {out.shape[0]} bytes does not hold {layout!r} for {n} "
                         f"lanes")
    kernels.device_of(*here)
    if here[0].device.type == "cpu":
        return _card_step_plain(tables, groups, num_banks, slots, hits, fresh, limits,
                                layout, shadow, near_ratio, out)
    return launch_card_step(tables, groups, num_banks, slots, hits, fresh, limits, layout,
                            shadow, near_ratio, out)


def launch_card_step(tables, groups, num_banks, slots, hits, fresh, limits, layout, shadow,
                     near_ratio, out) -> torch.Tensor:
    """sharded_card_step's launch, on checked arguments: one cooperative
    launch of rl_sharded_card_step, its scratch on the card."""
    dev = tables[groups[0]].device
    fw._require_cuda(dev)
    decide = layout == "decide"
    n = slots.shape[0]
    if n == 0:
        return out
    scratch = torch.empty((2, n), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(tables))(
        *(tables[g].data_ptr() if g in groups else None for g in range(len(tables)))
    )
    given = [t for t in (limits, shadow) if t is not None]
    # `out` is not among the launch's tensors: it may lie on the home
    # card, reached through the peer mapping.
    kernels.launch(
        "rl_sharded_card_step",
        K7_CARD_STEP if decide else K7_CARD,
        (*(tables[g] for g in groups), slots, hits, fresh, *given, scratch),
        ctypes.addressof(ptrs), len(tables), num_banks, tables[groups[0]].shape[1],
        slots.data_ptr(), hits.data_ptr(), fresh.data_ptr(),
        None if limits is None else limits.data_ptr(),
        shadow.data_ptr() if decide else None,
        float(near_ratio), scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(),
        out.data_ptr() + 32 * n if decide else None,
        fw._DECIDE if decide else fw._OUT_KIND[layout], n,
        kernels.stream_ptr(dev),
    )
    return out


def _combine_sources(cards) -> list:
    """Each group's place for the combine: 0 for the groups of a card
    that stores into the home output ("home", "peer"), c + 1 for those
    of the c-th "combine" card, whose lanes reach home in partial c."""
    sources = [0] * sum(len(groups) for groups, _ in cards)
    combine = [groups for groups, link in cards if link == "combine"]
    for c, groups in enumerate(combine):
        for g in groups:
            sources[g] = c + 1
    return sources


def _combine_plain(out, partials, sources, slots, num_banks, slots_per_bank,
                   layout) -> torch.Tensor:
    """Plain version of sharded_combine (in place; returns `out`)."""
    groups = len(sources)
    n = slots.shape[0]
    s = slots.to(torch.int64)
    in_table = (s >= 0) & (s < num_banks * slots_per_bank)
    owner = torch.where(
        in_table, (s % num_banks) // (num_banks // groups), torch.zeros_like(s)
    )
    src = torch.tensor(sources, dtype=torch.int64, device=out.device)[owner]
    dst = _rows(out, layout, n)
    for c in range(partials.shape[0]):
        lanes = src == c + 1
        for d, f in zip(dst, _rows(partials[c], layout, n)):
            d[:, lanes] = f[:, lanes]
    return out


def sharded_combine(
    out: torch.Tensor,
    partials: torch.Tensor,
    sources: Sequence[int],
    slots: torch.Tensor,
    num_banks: int,
    slots_per_bank: int,
    layout: str,
) -> torch.Tensor:
    """The psum of K7 where a card cannot map the home card.  `out`
    (uint8, partial_bytes(layout, n) at least) is the home output that
    the home card and every mapped card stored their owned lanes into;
    `partials` uint8[cards, stride] holds in row c the output that the
    c-th combine card wrote (its owned lanes); both on
    the home device, with `slots` (int32[n], global ids).  sources[g]
    says where group g's lanes lie: 0 in `out` (group 0's always), c + 1
    in partial c (_combine_sources).  Each lane whose owner -- the group
    of bank ``s % num_banks`` for an in-table id s, the group of bank 0
    for any other -- lies on a combine card takes its fields from that
    card's partial, in place in `out`; nothing else is read or written,
    so this select is JAX's sum.  Returns `out`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}")
    n = slots.shape[0]
    if slots.dtype != torch.int32 or slots.dim() != 1 or not slots.is_contiguous():
        raise TypeError(f"slots must be contiguous int32[n], got {slots.dtype} "
                        f"{tuple(slots.shape)}")
    for name, t, dim in (("out", out, 1), ("partials", partials, 2)):
        if t.dtype != torch.uint8 or t.dim() != dim or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous uint8 of {dim} dimension(s), got "
                            f"{t.dtype} {tuple(t.shape)}")
    cards, stride = partials.shape
    size = partial_bytes(layout, n)
    sources = [int(c) for c in sources]
    groups = len(sources)
    if (not 1 <= groups <= MAX_GROUPS or num_banks % groups or not 1 <= cards <= 255
            or sources[0] != 0 or not all(0 <= c <= cards for c in sources)):
        raise ValueError(f"sources {sources} do not place {groups} groups of {num_banks} "
                         f"banks in the home output or one of {cards} partials")
    if out.shape[0] < size or stride < size or stride % 4:
        raise ValueError(f"an output of {out.shape[0]} bytes and partials of {stride} do not "
                         f"hold {layout!r} for {n} lanes")
    if kernels.device_of(out, partials, slots).type == "cpu":
        return _combine_plain(out, partials, sources, slots, num_banks, slots_per_bank, layout)
    return launch_combine(out, partials, sources, slots, num_banks, slots_per_bank, layout)


def launch_combine(out, partials, sources, slots, num_banks, slots_per_bank,
                   layout) -> torch.Tensor:
    """sharded_combine's launch, on checked arguments: one launch of
    rl_sharded_combine, in place in `out`."""
    fw._require_cuda(out.device)
    n = slots.shape[0]
    if n == 0:
        return out
    cards, stride = partials.shape
    table = kernels.ints(sources)  # carried into the launch's parameters
    kernels.launch(
        "rl_sharded_combine",
        COMBINE,
        (out, partials, slots),
        out.data_ptr(), partials.data_ptr(), stride, cards,
        ctypes.addressof(table), len(sources), slots.data_ptr(), num_banks,
        slots_per_bank, *LAYOUTS[layout], n, kernels.stream_ptr(out.device),
    )
    return out


def _pack_lanes(lanes):
    """The given lanes' bytes end to end, the int32 lanes first (so each
    view of a copy stays aligned), and each lane's (offset, bytes), None
    for a lane not given."""
    order = sorted((i for i, t in enumerate(lanes) if t is not None),
                   key=lambda i: -lanes[i].element_size())
    spans, at = [None] * len(lanes), 0
    for i in order:
        size = lanes[i].numel() * lanes[i].element_size()
        spans[i], at = (at, size), at + size
    return torch.cat([lanes[i].view(torch.uint8) for i in order]), spans


def _lanes_to(lanes, packed, spans, dev):
    """The lanes on `dev`: as they are on their own device, else views
    of ONE copy of `packed` (_pack_lanes)."""
    if dev == lanes[0].device:
        return lanes
    here = packed.to(dev, non_blocking=True)
    return [None if sp is None else here[sp[0] : sp[0] + sp[1]].view(t.dtype)
            for t, sp in zip(lanes, spans)]


def mesh_card_step(parts, cards, num_banks, lanes, layout, near_ratio, out):
    """K7's card step on every card of `cards` ((groups, link, ...) each,
    the home card -- parts[0]'s device -- first) whose owned lanes reach
    `out` on the home device in place or through a peer mapping: on the
    card ONE host call (launch_mesh_card_step), on the CPU each card's
    plain step in turn (sharded_card_step).  `lanes` are the batch's
    slots, hits, fresh, limits and shadow (the last two may be None);
    the rest as sharded_card_step's.  Returns `out`."""
    cards = _plans(parts, cards)
    home = parts[0].device
    if not cards or parts[cards[0].groups[0]].device != home:
        raise ValueError(f"the first card of {cards} must hold the home device's groups")
    slots, hits, fresh, limits, shadow = lanes
    if home.type == "cpu":
        for groups, *_ in cards:
            sharded_card_step(parts, groups, num_banks, slots, hits, fresh, limits, layout,
                              shadow, near_ratio, out)
        return out
    # The checks of sharded_card_step, once for every card.
    _check_card_tables(parts, one_device=False)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}")
    decide = layout == "decide"
    fw.check_general_lanes(parts[0], slots, hits, fresh, limits, "" if decide else layout,
                           shadow=shadow if decide else None)
    if decide and (limits is None or shadow is None):
        raise ValueError("the decision block needs the limits and shadow lanes")
    if out.dtype != torch.uint8 or out.dim() != 1 or out.device != home or (
            out.shape[0] < partial_bytes(layout, slots.shape[0])):
        raise ValueError(f"out must be uint8 on {home} holding {layout!r} for the batch")
    return launch_mesh_card_step(parts, cards, num_banks, lanes, layout, near_ratio, out)


def _plans(parts, cards) -> list:
    """`cards` as CardPlans: a (groups, link) pair takes its groups'
    device and that device's current stream."""
    return [c if isinstance(c, CardPlan) else
            CardPlan(tuple(c[0]), c[1], (), parts[c[0][0]].device) for c in cards]


def launch_mesh_card_step(parts, cards, num_banks, lanes, layout, near_ratio,
                          out) -> torch.Tensor:
    """K7's card step on every card of `cards` (CardPlans, the home card
    first; their lanes reach `out` in place or through a peer mapping)
    in ONE host call, rl_mesh_card_step: on each card one cooperative
    launch over every group it holds, on that card's stream (its plan's,
    else its current one).  The home card reads the lanes (slots, hits, fresh, limits,
    shadow; the last two may be None) where they lie; each other card
    takes ONE copy of their bytes end to end (_pack_lanes), which the
    entry makes on that card's stream after the home stream's work so
    far, and the home stream waits on every card's launch.  Counted as
    one sharded_card_update (or sharded_card_step, layout "decide") a
    card.  Arguments as sharded_card_step's, checked by the caller."""
    home = cards[0].device
    n = lanes[0].shape[0]
    if n == 0:
        return out
    decide = layout == "decide"
    packed = spans = None
    base = [t.data_ptr() if t is not None else None for t in lanes]
    tensors, lane_ptrs, copies, scratch = [], [], [], []
    for card in cards:
        dev = card.device
        mine = [parts[g] for g in card.groups]
        if dev == home:
            buf = torch.empty(8 * n, dtype=torch.uint8, device=dev)
            lane_ptrs += base
            copies.append(None)
            tensors.append((*mine, *(t for t in lanes if t is not None), buf))
        else:
            if packed is None:
                packed, spans = _pack_lanes(lanes)
            at = -(-packed.numel() // 16) * 16
            buf = torch.empty(at + 8 * n, dtype=torch.uint8, device=dev)
            lane_ptrs += [None if sp is None else buf.data_ptr() + sp[0] for sp in spans]
            copies.append(buf.data_ptr())
            tensors.append((*mine, buf))
            buf = buf[at:]
        scratch.append(buf.data_ptr())
    held = [set(card.groups) for card in cards]
    tables = kernels.pointers(
        [parts[g].data_ptr() if g in mine else None for mine in held for g in range(len(parts))])
    devices = kernels.ints([card.device.index for card in cards])
    streams = kernels.pointers([_card_stream(card) for card in cards])
    arrays = [kernels.pointers(a) for a in (lane_ptrs, copies, scratch)]
    kernels.launch_mesh(
        MESH_CARD, K7_CARD_STEP if decide else K7_CARD, tensors, len(cards),
        ctypes.addressof(devices), ctypes.addressof(streams), ctypes.addressof(tables),
        len(parts), num_banks, parts[0].shape[1], ctypes.addressof(arrays[0]),
        ctypes.addressof(arrays[1]), None if packed is None else packed.data_ptr(),
        0 if packed is None else packed.numel(), float(near_ratio),
        ctypes.addressof(arrays[2]), out.data_ptr(),
        out.data_ptr() + 32 * n if decide else None,
        fw._DECIDE if decide else fw._OUT_KIND[layout], n,
    )
    return out


def grouped_general_step(
    parts: Sequence[torch.Tensor],
    cards: Sequence[Tuple[Tuple[int, ...], str]],
    num_banks: int,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    layout: str = "",
    shadow: Optional[torch.Tensor] = None,
    near_ratio: float = 0.0,
):
    """K7 over bank groups: parts[g] is group g's int32[k,
    slots_per_bank] tensor, `cards` (Mesh.card_groups, or (groups, link)
    pairs) the groups each card holds and its link, the home card's
    first.  One launch a card (sharded_card_step), on that card's current
    stream, over the batch (on the home device, parts[0]'s).  Each card
    writes the lanes it owns:

    - "home" and "peer": into the one output on the home device, the
      home card in place, a peer-mapped card through the mapping.  On the
      card every such card's launch is enqueued by ONE host call
      (launch_mesh_card_step); the home stream waits on each card;
    - "combine": a card that cannot map the home card writes them into
      ONE partial of the output's layout on its own card, which goes home in ONE copy; then sharded_combine puts each lane
      such a card owns into the home output.

    One group holds every bank and owns every lane: its launch is the
    one-group step.  Returns what sharded_general_update (layout "",
    "uint8", "uint16") or sharded_general_step ("decide") returns on one
    table; updates every group's table in place."""
    if len(parts) == 1:
        if layout == "decide":
            return sharded_general_step(parts[0], slots, hits, fresh, limits, shadow, near_ratio)
        return sharded_general_update(parts[0], slots, hits, fresh, limits, layout)
    cards = [(tuple(card[0]), card[1]) for card in cards]
    if sorted(g for groups, _ in cards for g in groups) != list(range(len(parts))):
        raise ValueError(f"cards {cards} do not hold each of {len(parts)} groups once")
    home = parts[0].device
    n = slots.shape[0]
    size = partial_bytes(layout, n)
    out = torch.empty(size, dtype=torch.uint8, device=home)
    lanes = (slots, hits, fresh, limits, shadow)
    mesh_card_step(parts, [c for c in cards if c[1] != "combine"], num_banks, lanes, layout,
                   near_ratio, out)
    combine = [groups for groups, link in cards if link == "combine"]
    if combine:
        # Each partial starts 16-byte aligned, like the home output.
        partials = torch.empty((len(combine), -(-size // 16) * 16), dtype=torch.uint8,
                               device=home)
        packed = spans = None
        for c, groups in enumerate(combine):
            dev = parts[groups[0]].device
            if dev != home and packed is None:
                packed, spans = _pack_lanes(lanes)
            here = _lanes_to(lanes, packed, spans, dev)
            partial = torch.empty(size, dtype=torch.uint8, device=dev)
            sharded_card_step(parts, groups, num_banks, *here[:4], layout, here[4],
                              near_ratio, partial)
            partials[c, :size].copy_(partial, non_blocking=True)
        sharded_combine(out, partials, _combine_sources(cards), slots, num_banks,
                        parts[0].shape[1], layout)
    return unpack_partial(out, layout, n)


class ShardedFixedWindowModel:
    """Fixed-window decisions over a bank-sharded counter table.

    ``num_slots`` is the GLOBAL slot count, rounded up to a multiple of
    the mesh's bank count so that every bank has the same size (100
    slots over 8 banks -> 104, 13 per bank).  Slot ids from the host
    slot table index the global space.  A state is one int32[num_banks,
    slots_per_bank] tensor on a mesh of one group, else a tuple of each
    group's int32[banks_per_group, slots_per_bank] tensor on its device
    (``parts`` and ``join`` convert).  The batch lies on the home
    device, and so do the answers."""

    def __init__(self, num_slots: int, mesh: Mesh, near_ratio: float = 0.8):
        self.mesh = mesh
        self.num_banks = mesh.num_banks
        self.groups = mesh.groups
        self.banks_per_group = mesh.banks_per_group
        self.slots_per_bank = -(-int(num_slots) // self.num_banks)
        self.num_slots = self.slots_per_bank * self.num_banks
        self.near_ratio = float(near_ratio)
        self.device = mesh.device

    @staticmethod
    def parts(counts) -> Tuple[torch.Tensor, ...]:
        """The group tensors of a state (a tensor is one group's)."""
        return (counts,) if isinstance(counts, torch.Tensor) else tuple(counts)

    @staticmethod
    def join(parts: Sequence[torch.Tensor]):
        """The state of group tensors: the tensor itself for one group."""
        return parts[0] if len(parts) == 1 else tuple(parts)

    def init_state(self):
        """Fresh table, all zero: each group's tensor on its device."""
        shape = (self.banks_per_group, self.slots_per_bank)
        return self.join(
            [torch.zeros(shape, dtype=torch.int32, device=d) for d in self.mesh.devices]
        )

    def _general(self, counts, batch: DeviceBatch, layout: str, limits=None):
        """K7 on a state's groups (grouped_general_step)."""
        decide = layout == "decide"
        return grouped_general_step(
            self.parts(counts), self.mesh.card_groups(), self.num_banks, batch.slots,
            batch.hits, batch.fresh, limits, layout, batch.shadow if decide else None,
            self.near_ratio,
        )

    def step(self, counts, batch: DeviceBatch) -> Tuple[object, DeviceDecisions]:
        """The sharded forward step: K7 + K3's decision block, one launch
        on one group (sharded_general_step); on several, one launch a
        card, every mapped card's in one host call (grouped_general_step)."""
        return counts, self._general(counts, batch, "decide", batch.limits)

    def step_counters(self, counts, batch: DeviceBatch) -> Tuple[object, torch.Tensor]:
        """Counter update only (K7): returns (counts, afters)."""
        return counts, self._general(counts, batch, "")

    def step_counters_compact(
        self, counts, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[object, torch.Tensor]:
        """K7 with the saturated narrow readback min(after, limit +
        hits) as uint8 or uint16 (int16 storage)."""
        return counts, self._general(counts, batch, out_dtype, batch.limits)

    def _card_rows(self, card: CardPlan):
        """A card's rows of a [num_banks, ...] batch: a slice where they
        are one run, else their indices."""
        rows = card.rows
        if rows == tuple(range(rows[0], rows[0] + len(rows))):
            return slice(rows[0], rows[0] + len(rows))
        return list(rows)

    def step_counters_unique_routed_packed(
        self, counts, out_dtype: str, packed: torch.Tensor
    ) -> Tuple[object, torch.Tensor]:
        """The routed serving step (K6) on one packed int32[num_banks, 4,
        cap] upload on the home device.  Returns (counts, afters[num_banks,
        cap]) on the home device.  A tensor `counts` (one group) is one
        launch of sharded_routed_step; over several groups each card's
        rows go to that card and K6's card form runs once a card, every
        card in ONE host call (mesh_routed_step)."""
        parts = self.parts(counts)
        if len(parts) == 1:
            return counts, sharded_routed_step(parts[0], packed, out_dtype)
        if out_dtype not in fw.OUT_DTYPES:
            raise ValueError(f"out_dtype must be one of {sorted(fw.OUT_DTYPES)}")
        if packed.dim() != 3 or packed.shape[:2] != (self.num_banks, 4):
            raise TypeError(f"packed must be int32[{self.num_banks}, 4, cap], got "
                            f"{tuple(packed.shape)}")
        cap = packed.shape[2]
        cards = self.mesh.card_groups()
        batches = [packed[self._card_rows(c)].to(c.device).contiguous() for c in cards]
        outs = [torch.empty((len(c.rows), cap), dtype=fw.OUT_DTYPES[out_dtype], device=c.device)
                for c in cards]
        mesh_routed_step(parts, cards, batches, outs, out_dtype)
        if len(cards) == 1:
            return counts, outs[0]
        out = torch.empty((self.num_banks, cap), dtype=outs[0].dtype, device=self.device)
        for c, o in zip(cards, outs):
            out[self._card_rows(c)] = o.to(self.device)
        return counts, out

    def step_counters_unique_routed_lanes(
        self, counts, out_dtype: str, words: torch.Tensor, out: torch.Tensor
    ) -> Tuple[object, torch.Tensor]:
        """The routed serving step in K6's by-value form: the batch of
        step_counters_unique_routed_packed held in host memory, the
        readback into `out` (pinned host memory on the card).  Over
        several groups K6's card form by value runs once a card, every
        card in ONE host call (mesh_routed_step_lanes), each card on its
        rows of `words` and `out`.  Returns (counts, out); wait on each
        card's stream before reading `out`.  A card whose rows are not one
        run of the batch (its groups not adjacent) reads a gathered copy of
        them and writes a readback of its own, which is waited for and
        scattered into `out` here."""
        parts = self.parts(counts)
        if len(parts) == 1:
            return counts, sharded_routed_step_lanes(parts[0], words, out, out_dtype)
        # Each card's rows must fit a launch (mesh_routed_step_lanes
        # checks them); the whole batch may hold more.
        return counts, self._routed_host(parts, out_dtype, words, out, mesh_routed_step_lanes)

    def step_counters_unique_routed_mapped(
        self, counts, out_dtype: str, words: torch.Tensor, out: torch.Tensor
    ) -> Tuple[object, torch.Tensor]:
        """The routed serving step in K6's mapped form: the batch of
        step_counters_unique_routed_packed, of any width, in PINNED host
        memory that the kernel reads through its device alias, the
        readback into `out` (pinned).  Over several groups K6's card form
        mapped runs once a card, every card in ONE host call
        (mesh_routed_step_mapped), as step_counters_unique_routed_lanes
        does by value.  Returns (counts, out); keep `words` and wait on
        each card's stream before reading `out`."""
        parts = self.parts(counts)
        if len(parts) == 1:
            return counts, sharded_routed_step_mapped(parts[0], words, out, out_dtype)
        return counts, self._routed_host(parts, out_dtype, words, out, mesh_routed_step_mapped)

    def _routed_host(self, parts, out_dtype: str, words: torch.Tensor, out: torch.Tensor,
                     mesh_step) -> torch.Tensor:
        """The routed step over several groups on a batch in host memory:
        `mesh_step` (mesh_routed_step_lanes or mesh_routed_step_mapped)
        once over every card's rows of `words` and `out`; returns `out`."""
        if out_dtype not in fw.OUT_DTYPES:
            raise ValueError(f"out_dtype must be one of {sorted(fw.OUT_DTYPES)}")
        cap = _check_card_batch(words, self.num_banks)
        if out.dtype != fw.OUT_DTYPES[out_dtype] or tuple(out.shape) != (self.num_banks, cap):
            raise TypeError(f"out must be {fw.OUT_DTYPES[out_dtype]}[{self.num_banks}, {cap}], "
                            f"got {out.dtype} {tuple(out.shape)}")
        cards = self.mesh.card_groups()
        batches, outs, spread = [], [], []
        for c in cards:
            rows = self._card_rows(c)
            if isinstance(rows, slice):
                batches.append(words[rows])
                outs.append(out[rows])
                continue
            # A gathered copy; pinned for the mapped kernel, which reads
            # it while it runs (it lives until the wait below).  By value
            # the launch copies the words into its parameters.
            pin = c.device.type == "cuda"
            if pin and mesh_step is mesh_routed_step_mapped:
                batches.append(torch.empty(words[rows].shape, dtype=words.dtype, pin_memory=True))
                batches[-1].copy_(words[rows])
            else:
                batches.append(words[rows].contiguous())
            mine = torch.empty((len(rows), out.shape[1]), dtype=out.dtype, pin_memory=pin)
            outs.append(mine)
            spread.append((c, rows, mine))
        mesh_step(parts, cards, batches, outs, out_dtype)
        for c, rows, mine in spread:
            if c.device.type == "cuda":
                torch.cuda.current_stream(c.device).synchronize()  # tpu-lint: disable=torch-host-sync -- the readback of a card whose rows are not one run of `out`, on this model-level call alone: the engine packs a batch a card and never comes here
            out[rows] = mine
        return out

    def step_counters_unique_routed(
        self, counts, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[object, torch.Tensor]:
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
    its share of the batch, and the readback is unrouted on the host.

    Each CARD of the mesh has its own stream (claim_stream: no two live
    engines share one, so a stall on one card holds up no other engine),
    its own pool of stagings (pinned on its device) and its own event a
    submission.  A mesh of one group serves as one table (one staging,
    one K6 launch, by value or mapped).  Over several groups a chunk
    packs one int32[rows, 4, cap] batch a card -- the rows of every bank
    the card holds -- and ONE host call (mesh_routed_step_lanes, or
    mesh_routed_step_mapped past 128 lanes a card) launches K6's card
    form on every card's stream, reading each card's staged batch and
    writing its readback in pinned memory, and records each card's event;
    the readback is taken once every card's event has fired.  Only the routing is per bank, as the JAX host
    routes.  The home card's stream is ``_stream``, the other cards'
    ``_more_streams``."""

    def __init__(
        self,
        mesh: Mesh,
        num_slots: int = 1 << 20,
        near_ratio: float = 0.8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        native_table: Optional[bool] = None,
    ):
        # The cards past the home one; CounterEngine claims the home
        # card's stream and makes the table (_fresh_state).
        cards = mesh.card_groups()
        self._card_of_group = tuple(mesh.cards.index(d) for d in mesh.devices)
        self._held_rows = tuple(len(c.rows) for c in cards)
        self._more_streams = tuple(claim_stream(c.device, self) for c in cards[1:])
        self._more_staging = tuple(deque(maxlen=STAGING_POOL_CAP) for _ in cards[1:])
        try:
            super().__init__(
                buckets=buckets,
                device=mesh.device,
                model=ShardedFixedWindowModel(num_slots, mesh, near_ratio),
                native_table=native_table,
            )
        except BaseException:
            # No later engine may find these streams held by this one.
            release_stream(self)
            raise
        self._cards = mesh.card_groups(self._card_streams())
        # Each bank's row in the cards' readbacks end to end (_bank_at;
        # None where that is bank order), its card, and its row in that
        # card's batch.
        at = np.argsort([b for c in cards for b in c.rows])
        starts = np.concatenate([[0], np.cumsum(self._held_rows)[:-1]])
        self._bank_card = np.repeat(np.arange(len(cards)), self._held_rows)[at]
        self._bank_row = at - starts[self._bank_card]
        self._bank_at = None if np.array_equal(at, np.arange(len(at))) else at
        # Routed-balance gauge: real lanes each bank received in the
        # last chunk.
        self.stat_bank_lane_counts = [0] * self.model.num_banks

    # -- the cards -----------------------------------------------------

    def _card_streams(self):
        return (self._stream, *self._more_streams)

    def _on_card(self, c: int):
        """Context that puts this thread's work on card c's stream and
        device."""
        return _stream_context(self._card_streams()[c], self.model.mesh.cards[c])

    def _on_group(self, g: int):
        """Context of the card that holds group g."""
        return self._on_card(self._card_of_group[g])

    def _fresh_state(self):
        """A fresh table, each group's tensor made on its card's stream."""
        m = self.model
        shape = (m.banks_per_group, m.slots_per_bank)
        parts = []
        for g, dev in enumerate(m.mesh.devices):
            with self._on_group(g):
                parts.append(torch.zeros(shape, dtype=torch.int32, device=dev))
        return m.join(parts)

    def _pool(self, c: int) -> deque:
        return (self._free_staging, *self._more_staging)[c]

    def _take_card_staging(self, c: int) -> _Staging:
        """An idle staging of card c, or a new one pinned under its
        device, its event made on the card's stream (torch makes an event
        at its first record; the mesh entry then records it)."""
        try:
            return self._pool(c).pop()  # tpu-lint: disable=shared-state -- GIL-atomic deque pop (submit side, EAFP: an empty pool makes a new staging) against append (complete side) after the event wait
        except IndexError:
            dev = self.model.mesh.cards[c]
            with kernels.on_device(dev):
                st = _Staging(*self._staging_size(c), dev)
            if st.event is not None and self.model.groups > 1:
                st.event.record(self._card_streams()[c])
            return st

    def _staging_size(self, c: int = 0):
        """A card's staged batch is int32[rows, 4, cap] (rows: the banks
        it holds) and its readback up to 4 B per routed lane, where cap
        is at most the bucket of min(max_batch, slots_per_bank): one bank
        holds at most slots_per_bank distinct slots (the warmup skew
        probe reaches it)."""
        m = self.model
        cap = self._bucket(min(self.max_batch, m.slots_per_bank))
        words = self._held_rows[c] * 4 * cap
        return words, words

    def _fetch(self, handle) -> np.ndarray:
        """One group's handle as CounterEngine's; several groups' (a list,
        one (staging, readback) a card) after every card's event: the
        cards' readbacks end to end, each staging back to its card's
        pool."""
        if not isinstance(handle, list):
            return super()._fetch(handle)
        for st, _ in handle:
            self._wait(st)
        out = np.concatenate(
            [rb.numpy().view(_HOST_VIEW[rb.dtype]) for _, rb in handle]
        )
        for c, (st, _) in enumerate(handle):
            self._pool(c).append(st)
        return out

    def _wait_handle(self, handle) -> None:
        """Every card's event of a several-group handle (a list)."""
        if not isinstance(handle, list):
            return super()._wait_handle(handle)
        for st, _ in handle:
            self._wait(st)

    # -- the device step -----------------------------------------------

    def _device_submit(self, dedup, now: int = 0):
        # `now` is the generic-algorithm batch clock; the sharded engine
        # serves fixed-window only.
        m = self.model
        spb = m.slots_per_bank
        nb = m.num_banks
        uniq = dedup.uniq_slots
        g_count = len(uniq)
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

        # Dtype choice from the unwrapped uint64 totals (see
        # CounterEngine._device_submit): clamped-total groups take the
        # raw u32 readback, never the narrow one.  One dtype serves the
        # whole chunk.
        cap_val = int(dedup.totals[vi].max(initial=0)) + int(
            dedup.limit_max[vi].max(initial=1)
        )
        dt = "uint8" if cap_val <= 0xFF else ("uint16" if cap_val <= 0xFFFF else "")

        # ONE packed int32[rows, 4, cap] batch a card, its banks' rows.
        # Padding ids spb + i are distinct and out of the bank, so K6
        # leaves them inert.
        multi = len(self._cards) > 1
        lane_card = self._bank_card[banks] if multi else None
        stagings = []
        for c, rows in enumerate(self._held_rows):
            st = self._take_card_staging(c)
            pk = st.packed_np[: rows * 4 * cap].reshape(rows, 4, cap)
            pk[:, 0, :] = spb + np.arange(cap, dtype=np.int64)
            pk[:, 1, :] = 0
            pk[:, 2, :] = 1
            pk[:, 3, :] = 0
            if multi:
                sel = np.nonzero(lane_card == c)[0]
                b, p, v = self._bank_row[banks[sel]], pos[sel], vi[sel]
            else:
                b, p, v = banks, pos, vi
            pk[b, 0, p] = uniq[v] // nb
            pk[b, 1, p] = totals32[v].view(np.int32)
            pk[b, 2, p] = dedup.limit_max[v].view(np.int32)
            pk[b, 3, p] = dedup.fresh[v]
            stagings.append(st)
        if m.groups == 1:
            st = stagings[0]
            self._counts, handle = self._serve_on(
                self._stream, self._counts, st, st.packed[: nb * 4 * cap].view(nb, 4, cap),
                fw.OUT_DTYPES[dt], (nb, cap),
                lambda counts, words, out: m.step_counters_unique_routed_lanes(
                    counts, dt, words, out
                ),
                lambda counts, words, out: m.step_counters_unique_routed_mapped(
                    counts, dt, words, out
                ),
            )
        else:
            handle = self._serve_cards(stagings, cap, dt)
        at = banks if self._bank_at is None else self._bank_at[banks]

        def reassemble(fetched: np.ndarray) -> np.ndarray:
            out = np.zeros(g_count, dtype=np.uint32)
            out[vi] = fetched[at, pos]
            # Out-of-table slots (warmup probes) answer as on one table:
            # before 0, after = hits (never saturated: totals <= cap_val
            # by the dtype choice).
            out[~valid] = totals32[~valid]
            return out

        return handle, reassemble

    def _serve_cards(self, stagings, cap: int, dt: str) -> list:
        """K6's card form on every card's staged batch in ONE host call:
        by value where every card's rows x cap fit a launch's 128 lanes,
        else mapped (each card's kernel reads its staged batch through the
        device alias); either way the kernel writes the readback into each
        staging.  Each card's event is recorded after its launch.  Returns
        the handle: (staging, readback) a card."""
        m = self.model
        parts = m.parts(self._counts)
        dtype = fw.OUT_DTYPES[dt]
        words = [st.packed[: r * 4 * cap].view(r, 4, cap)
                 for st, r in zip(stagings, self._held_rows)]
        readbacks = [st.readback[: r * cap * dtype.itemsize].view(dtype).view(r, cap)
                     for st, r in zip(stagings, self._held_rows)]
        events = [st.event for st in stagings]
        step = (mesh_routed_step_lanes if lanes_by_value(max(self._held_rows), cap)
                else mesh_routed_step_mapped)
        step(parts, self._cards, words, readbacks, dt, events)
        return list(zip(stagings, readbacks))

    def warmup_probe_slots(self, bucket: int) -> np.ndarray:
        """All-one-bank probes: slots k * num_banks all land in bank 0,
        so the probe's routed cap is the widest (most skewed) this
        engine can serve for a `bucket`-lane batch -- min(bucket,
        slots_per_bank), since one bank holds at most slots_per_bank
        distinct slots.  The clamp keeps the probes distinct and in the
        table on small tables.  Every card launches at that cap (its
        banks padding only, but for bank 0's card)."""
        m = self.model
        width = min(int(bucket), m.slots_per_bank)
        return (np.arange(width, dtype=np.int64) * m.num_banks).astype(np.int32)

    # -- the table in global order -------------------------------------

    def _slot_groups(self, slots):
        """Global slot s lives in bank s % num_banks at position
        s // num_banks, and that bank in group bank // banks_per_group:
        (group, lanes of `slots` in it, row in the group's tensor,
        position) for each group that holds any of `slots`."""
        m = self.model
        s = np.asarray(slots, dtype=np.int64).reshape(-1)
        bank = s % m.num_banks
        group = bank // m.banks_per_group
        for g in range(m.groups):
            sel = np.nonzero(group == g)[0]
            if len(sel):
                yield g, sel, bank[sel] - g * m.banks_per_group, s[sel] // m.num_banks

    def read_slots(self, slots) -> dict:
        """The counters at the global `slots`, by group, each group's
        gather on the stream of the card that holds it (every group of a
        card shares that card's one stream)."""
        parts = self.model.parts(self._counts)
        got = np.zeros(len(np.asarray(slots).reshape(-1)), dtype=np.uint32)
        for g, sel, row, col in self._slot_groups(slots):
            dev = self.model.mesh.devices[g]
            with self._on_group(g):
                idx = (torch.from_numpy(row).to(dev), torch.from_numpy(col).to(dev))
                got[sel] = state_to_numpy(parts[g][idx])
        return {"counts": got}

    def write_slots(self, slots, state: dict) -> None:
        """Set the counters at the global `slots` to `state["counts"]`."""
        parts = self.model.parts(self._counts)
        vals = np.asarray(state["counts"], dtype=np.uint32).reshape(-1)
        for g, sel, row, col in self._slot_groups(slots):
            dev = self.model.mesh.devices[g]
            with self._on_group(g):
                idx = (torch.from_numpy(row).to(dev), torch.from_numpy(col).to(dev))
                host = torch.from_numpy(np.ascontiguousarray(vals[sel]).view(np.int32))
                parts[g][idx] = host.to(dev)

    def export_counts(self) -> np.ndarray:
        """Flat uint32 copy in GLOBAL slot order: bank b's position l
        holds global slot l * num_banks + b, so the (num_banks,
        slots_per_bank) layout transposes back.  Each group is copied on
        the stream of the card that holds it (state_to_numpy waits for
        that stream only): the groups of one card share its one stream, and
        a copy never queues behind another card's stream."""
        hosts = []
        for g, part in enumerate(self.model.parts(self._counts)):
            with self._on_group(g):
                hosts.append(state_to_numpy(part))
        return np.concatenate(hosts).T.reshape(-1)

    def import_counts(self, counts) -> None:
        arr = np.asarray(counts, dtype=np.uint32).reshape(-1)
        m = self.model
        if arr.shape[0] != m.num_slots:
            raise ValueError(f"counts size {arr.shape[0]} != num_slots {m.num_slots}")
        banked = arr.reshape(m.slots_per_bank, m.num_banks).T
        k = m.banks_per_group
        parts = []
        for g, dev in enumerate(m.mesh.devices):
            with self._on_group(g):
                parts.append(state_from_numpy(banked[g * k : (g + 1) * k], dev))
        self._counts = m.join(parts)
