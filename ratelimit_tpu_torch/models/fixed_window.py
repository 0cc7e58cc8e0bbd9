"""The flagship model: a fixed-window rate-limit decision step on the GPU.

Port of ratelimit_tpu/models/fixed_window.py.  The counter table is one
int32 tensor of u32 bit patterns (one counter per slot; 2**24 slots =
64 MiB) on the model's device.  Two steps run against it:

- the serving step, ``step_counters_unique_packed``: the engine has
  already deduplicated the batch on the host, so every live slot is
  unique -- K1 ``fw_unique_step`` (csrc/fixed_window.cu), on a batch in
  device memory.  The engine serves from its pinned staging instead, in
  one of two forms that ``lanes_by_value`` picks from the shape alone: up
  to 128 padded lanes by value, ``step_counters_unique_lanes``
  (``fw_unique_step_lanes``: the lanes ride in the launch's parameters),
  and past that mapped, ``step_counters_unique_mapped``
  (``fw_unique_step_mapped``: the kernel reads the staged batch through
  its device alias).  Either way the readback lands in pinned host
  memory and the chunk is one device activity;
- the duplicate-tolerant step, ``forward`` = ``update`` +
  ``decision_block``: zero fresh slots, gather, in-batch per-slot
  prefix (Redis pipeline order), modular scatter-add, threshold
  decisions -- K3, ONE cooperative launch of the fused general step
  (csrc/counter_update.cuh, which runs K2's tile pass inside), whose
  epilogue writes the decisions (``fw_general_step``), the afters or
  their narrow readback (``fw_general_update``).  ``fw_decision_block``
  is the decision block alone, the counterpart of the JAX
  ``decision_block``.

Unlike the JAX functions, which return a new (donated) table, the
steps update ``counts`` IN PLACE and return the same tensor, so the
table is never copied.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (or
raises) and runs its plain PyTorch version -- int64 arithmetic masked
to 32 bits, kept beside it here -- only for a tensor on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops.prefix import per_slot_inclusive_prefix
from ..ops.u32 import U32_MASK, narrow, narrow16, widen

# api.Code values, as device-friendly constants (api.py Code enum).
CODE_OK = 1
CODE_OVER_LIMIT = 2

#: Serving readback types: "" = raw u32 afters, else the saturated
#: narrow readback min(after, limit + hits).  u16 lives in int16
#: storage (torch has few uint16 ops); the host views it as uint16.
OUT_DTYPES = {"": torch.int32, "uint8": torch.uint8, "uint16": torch.int16}
_OUT_KIND = {"": 0, "uint8": 1, "uint16": 2}

K1 = "fw_unique_step"
K1_LANES = "fw_unique_step_lanes"
K1_MAPPED = "fw_unique_step_mapped"
K3_UPDATE = "fw_general_update"
K3_DECIDE = "fw_decision_block"
K3_STEP = "fw_general_step"

#: The fused general step's decision epilogue (Epilogue kDecide in
#: csrc/counter_update.cuh); its other epilogues are the _OUT_KIND codes.
_DECIDE = 3


class DeviceBatch(NamedTuple):
    """One padded descriptor batch on the device.  u32 fields are
    int32 tensors of the same bits; out-of-table slots are inert."""

    slots: torch.Tensor  # int32[N]
    hits: torch.Tensor  # int32[N], u32 bits
    limits: torch.Tensor  # int32[N], u32 bits (requests_per_unit)
    fresh: torch.Tensor  # bool[N] first sighting of a newly assigned slot
    shadow: torch.Tensor  # bool[N] rule-level shadow mode


class DeviceDecisions(NamedTuple):
    """Per-descriptor outcomes + stat deltas: codes int32, the u32
    counters as int32 bits, set_local_cache bool."""

    codes: torch.Tensor
    limit_remaining: torch.Tensor
    befores: torch.Tensor
    afters: torch.Tensor
    over_limit: torch.Tensor
    near_limit: torch.Tensor
    within_limit: torch.Tensor
    shadow_mode: torch.Tensor
    set_local_cache: torch.Tensor


def resolve_device(device) -> torch.device:
    """torch.device for `device`; CUDA must exist when asked for."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def state_from_numpy(counts_u32: np.ndarray, device="cuda") -> torch.Tensor:
    """A JAX model's uint32 state -> the port's int32-bits tensor on
    `device`: fixed-window's uint32[num_slots] table (flattened), or an
    algorithm bank's uint32[rows, num_slots] table (sliding window 3
    rows, GCRA 2; shape kept)."""
    arr = np.ascontiguousarray(counts_u32, dtype=np.uint32)
    if arr.ndim != 2:
        arr = arr.reshape(-1)
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))


def state_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of state_from_numpy: a uint32 numpy copy of the table,
    same shape.  From the card the copy lands in pinned memory on the
    current stream, and only that stream is waited for: CUDA
    stages a copy to pageable memory, and one queued behind a stalled
    kernel held up every other bank's pageable copy until the stall
    ended (scripts/torch_snapshot_stall.py)."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.numpy().view(np.uint32).copy()
    return t.detach().cpu().numpy().view(np.uint32).copy()


def slot_index(slots: torch.Tensor, num_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's index semantics for slot ids (gather mode="fill", scatter
    mode="drop"): an id in [-num_slots, -1] addresses id + num_slots,
    numpy-style; any other id outside [0, num_slots) is inert.  Returns
    (int64 table index, 0 where inert; bool live mask)."""
    s = slots.to(torch.int64)
    s = torch.where(s < 0, s + num_slots, s)
    live = (s >= 0) & (s < num_slots)
    return torch.where(live, s, torch.zeros_like(s)), live


def _check_table(counts: torch.Tensor) -> None:
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise TypeError(
            f"counts must be a 1-D int32 tensor, got {counts.dtype} "
            f"{tuple(counts.shape)}"
        )
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")


def _require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")


def _check_lanes(device: torch.device, n: int, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or t.shape != (n,):
            raise TypeError(
                f"{name} must be {dtype}[{n}], got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# -- K1: unique-slot serving step ---------------------------------------

#: The most lanes a launch carries by value, for every serving kernel
#: (K1/K6: 16 B a lane, K4/K5: 20 B; each parameter struct fits the 4 KB
#: every CUDA version accepts): kMaxLanes in csrc/by_value.cuh.
MAX_LANES = 128


def lanes_by_value(banks: int, padded: int) -> bool:
    """Whether a served batch of `banks` x `padded` lanes goes by value
    (the by-value form of K1, K4, K5 or K6) or not: past it each
    takes its mapped form.  The batch's shape alone decides, never a
    failure."""
    return banks * padded <= MAX_LANES


def _unique_step_plain(
    counts: torch.Tensor, packed: torch.Tensor, out_dtype: str
) -> torch.Tensor:
    """Plain version of K1 (updates `counts` in place, returns afters)."""
    idx, live = slot_index(packed[0], counts.shape[0])
    hits = widen(packed[1])
    limits = widen(packed[2])
    fresh = packed[3] != 0
    before = torch.where(live & ~fresh, widen(counts[idx]), torch.zeros_like(hits))
    after = torch.clamp(before + hits, max=U32_MASK)  # saturating
    counts[idx[live]] = narrow(after[live])
    return readback_plain(after, hits, limits, out_dtype)


def readback_plain(
    after: torch.Tensor, hits: torch.Tensor, limits: torch.Tensor, out_dtype: str
) -> torch.Tensor:
    """The serving readback from int64 u32 values: the afters as int32
    bits (""), or min(after, limit + hits) -- the cap modular, as the
    reference's -- truncated to uint8 or to uint16 (int16 storage)."""
    if out_dtype == "":
        return narrow(after)
    sat = torch.minimum(after & U32_MASK, (limits + hits) & U32_MASK)
    if out_dtype == "uint8":
        return (sat & 0xFF).to(torch.uint8)
    return narrow16(sat)


def fw_unique_step(
    counts: torch.Tensor, packed: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K1: fresh-zero, gather, saturating u32 add and unique scatter-set
    of one packed int32[4, N] batch (rows: slots, hits bits, limit
    bits, fresh); returns the afters as int32 u32 bits ("") or the
    saturated narrow readback ("uint8" -> uint8, "uint16" -> int16
    storage).  Updates `counts` in place.  Every live slot must be
    distinct (the engine dedups on the host)."""
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype must be one of {sorted(_OUT_KIND)}")
    _check_table(counts)
    if packed.dtype != torch.int32 or packed.dim() != 2 or packed.shape[0] != 4:
        raise TypeError(
            f"packed must be int32[4, N], got {packed.dtype} {tuple(packed.shape)}"
        )
    if packed.device != counts.device:
        raise ValueError("packed and counts must be on one device")
    if counts.device.type == "cpu":
        return _unique_step_plain(counts, packed, out_dtype)
    _require_cuda(counts.device)
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    n = packed.shape[1]
    out = torch.empty(n, dtype=OUT_DTYPES[out_dtype], device=counts.device)
    if n == 0:
        return out
    kernels.launch(
        "rl_fw_unique_step",
        K1,
        (counts, packed, out),
        counts.data_ptr(),
        counts.shape[0],
        packed.data_ptr(),
        n,
        out.data_ptr(),
        _OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    return out


def check_lanes_out(
    words: torch.Tensor, rows: int, out: torch.Tensor, dtype: torch.dtype, shape,
    by_value: bool = True,
) -> None:
    """The arguments of a by-value launch: host int32 words [..., rows,
    N] of at most MAX_LANES lanes, and `out` dtype[shape], contiguous,
    on the host (pinned, where the table is on the card: the kernel
    writes it through its device alias).  A mapped launch
    (`by_value` False) takes any width; its words must be pinned on the
    card too, since the kernel reads them through their alias."""
    if words.dtype != torch.int32 or words.dim() < 2 or words.shape[-2] != rows:
        raise TypeError(
            f"words must be int32[..., {rows}, N], got {words.dtype} "
            f"{tuple(words.shape)}"
        )
    if words.device.type != "cpu" or not words.is_contiguous():
        raise ValueError("words must be a contiguous host tensor")
    lanes = words.numel() // rows
    if by_value and lanes > MAX_LANES:
        raise ValueError(
            f"{lanes} lanes exceed the {MAX_LANES} a launch carries by value: "
            "use the device form"
        )
    if out.dtype != dtype or tuple(out.shape) != tuple(shape):
        raise TypeError(
            f"out must be {dtype}{list(shape)}, got {out.dtype} {tuple(out.shape)}"
        )
    if out.device.type != "cpu" or not out.is_contiguous():
        raise ValueError("out must be a contiguous host tensor")


def _check_unique_lanes(
    words: torch.Tensor, out: torch.Tensor, out_dtype: str, by_value: bool = True
) -> None:
    """check_lanes_out for K1/K6: int32[..., 4, N] words, readback
    OUT_DTYPES[out_dtype][..., N]."""
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype must be one of {sorted(_OUT_KIND)}")
    shape = tuple(words.shape[:-2]) + tuple(words.shape[-1:])
    check_lanes_out(words, 4, out, OUT_DTYPES[out_dtype], shape, by_value)


def fw_unique_step_lanes(
    counts: torch.Tensor, words: torch.Tensor, out: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K1's by-value form: the same step as fw_unique_step on a packed
    int32[4, N] batch held in HOST memory (N <= 128), whose values the
    launch carries as parameters, so no upload precedes the kernel.
    The readback goes into `out` (OUT_DTYPES[out_dtype][N]), host memory
    that must be pinned on a CUDA table: the kernel writes it through its
    device alias, and a KernelError is raised where there is none.  Only
    enqueued on a CUDA table: wait on the stream (an event) before
    reading `out`.  Returns `out`."""
    _check_table(counts)
    _check_unique_lanes(words, out, out_dtype)
    if counts.device.type == "cpu":
        return out.copy_(_unique_step_plain(counts, words, out_dtype))
    _require_cuda(counts.device)
    n = words.shape[1]
    if n == 0:
        return out
    kernels.launch(
        "rl_fw_unique_step_lanes",
        K1_LANES,
        (counts,),  # words and out are host memory
        counts.data_ptr(),
        counts.shape[0],
        words.data_ptr(),
        n,
        out.data_ptr(),
        _OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    return out


def fw_unique_step_mapped(
    counts: torch.Tensor, words: torch.Tensor, out: torch.Tensor, out_dtype: str = ""
) -> torch.Tensor:
    """K1's mapped form: the same step as fw_unique_step on a packed
    int32[4, N] batch held in PINNED host memory, of any width, which
    the kernel reads through its device alias while it runs, so no
    upload, no device buffer and no readback copy surround it.  The
    readback goes into `out` (OUT_DTYPES[out_dtype][N]), pinned host
    memory written the same way.  On a CUDA table, pageable `words` or
    `out` raise KernelError and a device tensor ValueError; there is no
    fallback.  Only enqueued: keep `words` and wait on the stream (an
    event) before reading `out` or reusing either.  Returns `out`."""
    _check_table(counts)
    _check_unique_lanes(words, out, out_dtype, by_value=False)
    if words.dim() != 2:
        raise TypeError(f"words must be int32[4, N], got {tuple(words.shape)}")
    if counts.device.type == "cpu":
        return out.copy_(_unique_step_plain(counts, words, out_dtype))
    _require_cuda(counts.device)
    n = words.shape[1]
    if n == 0:
        return out
    kernels.launch(
        "rl_fw_unique_step_mapped",
        K1_MAPPED,
        (counts,),  # words and out are pinned host memory
        counts.data_ptr(),
        counts.shape[0],
        words.data_ptr(),
        n,
        out.data_ptr(),
        _OUT_KIND[out_dtype],
        kernels.stream_ptr(counts.device),
    )
    return out


# -- K3: duplicate-tolerant update + decision block ---------------------


def _update_plain(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    out_dtype: str = "",
) -> torch.Tensor:
    """Plain version of fw_general_update (in place; returns the afters
    or their narrow readback)."""
    ns = counts.shape[0]
    idx, live = slot_index(slots, ns)
    counts[idx[live & fresh]] = 0
    before = torch.where(live, widen(counts[idx]), torch.zeros_like(idx))
    # The prefix compares raw ids (as JAX's does): -1 and ns - 1 share
    # a table slot but not a prefix.
    incl = widen(per_slot_inclusive_prefix(slots, hits))
    afters = before + incl
    # Modular scatter-add: every lane of a slot writes the same total.
    total = torch.zeros(ns, dtype=torch.int64, device=counts.device)
    touched = idx[live]
    total.index_add_(0, touched, widen(hits)[live])
    counts[touched] = narrow(widen(counts[touched]) + total[touched])
    if out_dtype == "":
        return narrow(afters)
    return readback_plain(afters, widen(hits), widen(limits), out_dtype)


def check_general_lanes(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    out_dtype: str = "",
    shadow: Optional[torch.Tensor] = None,
) -> None:
    """The lanes of a general step on `counts`: int32 slots and hits,
    bool fresh, and int32 limits (needed by a narrow readback) and bool
    shadow where given, all [N], contiguous, on the table's device."""
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype must be one of {sorted(_OUT_KIND)}")
    lanes = dict(
        slots=(slots, torch.int32), hits=(hits, torch.int32), fresh=(fresh, torch.bool)
    )
    if out_dtype and limits is None:
        raise ValueError(f"out_dtype {out_dtype!r} needs the limits")
    if limits is not None:
        lanes["limits"] = (limits, torch.int32)
    if shadow is not None:
        lanes["shadow"] = (shadow, torch.bool)
    _check_lanes(counts.device, slots.shape[0], **lanes)


def launch_general_step(
    entry: str,
    table: Tuple[int, ...],
    kernel: str,
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    out_dtype: str = "",
    shadow: Optional[torch.Tensor] = None,
    near_ratio: Optional[float] = None,
):
    """One cooperative launch of the fused general step through the C
    entry `entry` (its table's shape `table` after `counts`), counted as
    `kernel`.  With a `near_ratio` (and the `shadow` lanes) the epilogue
    is the decision block and the result DeviceDecisions; else the afters
    (int32 u32 bits) or their narrow readback (`out_dtype`).  The
    outputs and the prefix scratch come from torch.empty; the kernel
    allocates nothing.  A refused launch raises KernelError."""
    _require_cuda(counts.device)
    n = slots.shape[0]
    dev = counts.device
    set_lc = None
    if near_ratio is not None:
        # Rows 0-7: the decision fields (row 3 the afters); row 8: the
        # prefix scratch.
        buf = torch.empty((9, n), dtype=torch.int32, device=dev)
        afters, incl, out = buf[3], buf[8], buf
        set_lc = torch.empty(n, dtype=torch.bool, device=dev)
        epilogue = _DECIDE
        result = DeviceDecisions(*buf[:8].unbind(0), set_lc)
    else:
        buf = torch.empty((2, n), dtype=torch.int32, device=dev)
        afters, incl = buf[0], buf[1]
        out = torch.empty(n, dtype=OUT_DTYPES[out_dtype], device=dev) if out_dtype else afters
        epilogue = _OUT_KIND[out_dtype]
        result = out
    if n == 0:
        return result
    given = [t for t in (limits, shadow) if t is not None]
    kernels.launch(
        entry, kernel, (counts, slots, hits, fresh, *given, buf, out),
        counts.data_ptr(), *table, slots.data_ptr(), hits.data_ptr(), fresh.data_ptr(),
        None if limits is None else limits.data_ptr(),
        None if shadow is None else shadow.data_ptr(),
        float(near_ratio or 0.0), afters.data_ptr(), incl.data_ptr(), out.data_ptr(),
        None if set_lc is None else set_lc.data_ptr(), epilogue, n,
        kernels.stream_ptr(dev),
    )
    return result


def fw_general_update(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: Optional[torch.Tensor] = None,
    out_dtype: str = "",
) -> torch.Tensor:
    """K3 update: zero fresh slots, gather 'before', add the in-batch
    per-slot prefix, modular scatter-add of hits -- one launch of the
    fused general step.  Returns the per-lane afters (int32 u32 bits),
    or with out_dtype "uint8" / "uint16" min(after, limit + hits)
    narrowed (`limits` then required); updates `counts` in place.
    Duplicate slots are allowed."""
    _check_table(counts)
    check_general_lanes(counts, slots, hits, fresh, limits, out_dtype)
    if counts.device.type == "cpu":
        return _update_plain(counts, slots, hits, fresh, limits, out_dtype)
    return launch_general_step(
        "rl_fw_general_step", (counts.shape[0],), K3_UPDATE,
        counts, slots, hits, fresh, limits, out_dtype,
    )


def fw_general_step(
    counts: torch.Tensor,
    slots: torch.Tensor,
    hits: torch.Tensor,
    fresh: torch.Tensor,
    limits: torch.Tensor,
    shadow: torch.Tensor,
    near_ratio: float,
) -> DeviceDecisions:
    """K3 whole: the update of fw_general_update and the decision block
    of fw_decision_block on its afters, in ONE cooperative launch (the
    fused general step with its decision epilogue).  Updates `counts`
    in place."""
    _check_table(counts)
    check_general_lanes(counts, slots, hits, fresh, limits, shadow=shadow)
    if counts.device.type == "cpu":
        afters = _update_plain(counts, slots, hits, fresh)
        return _decision_block_plain(afters, hits, limits, shadow, near_ratio)
    return launch_general_step(
        "rl_fw_general_step", (counts.shape[0],), K3_STEP,
        counts, slots, hits, fresh, limits, shadow=shadow, near_ratio=near_ratio,
    )


def _decision_block_plain(
    afters: torch.Tensor,
    hits: torch.Tensor,
    limits: torch.Tensor,
    shadow: torch.Tensor,
    near_ratio: float,
) -> DeviceDecisions:
    """Plain version of fw_decision_block (limiter/base.py formulas)."""
    a = widen(afters)
    h = widen(hits)
    lim = widen(limits)
    zero = torch.zeros_like(a)
    befores = (a - h) & U32_MASK
    near_f = torch.floor(
        limits.to(torch.int64).bitwise_and(U32_MASK).to(torch.float32)
        * torch.tensor(near_ratio, dtype=torch.float32)
    )
    near = near_f.clamp(min=0.0, max=4294967296.0).to(torch.int64)
    near = near.clamp(max=U32_MASK)

    over = a > lim
    ok = ~over
    fully_over = over & (befores >= lim)
    partly_over = over & ~fully_over
    over_delta = torch.where(
        fully_over, h, torch.where(partly_over, a - lim, zero)
    )
    near_from_over = torch.where(
        partly_over, lim - torch.maximum(near, befores), zero
    )
    near_ok = ok & (a > near)
    near_from_ok = torch.where(
        near_ok & (befores >= near), h, torch.where(near_ok, a - near, zero)
    )
    shadowed = over & shadow
    codes = torch.where(
        over & ~shadowed,
        torch.full_like(a, CODE_OVER_LIMIT),
        torch.full_like(a, CODE_OK),
    )
    return DeviceDecisions(
        codes=codes.to(torch.int32),
        limit_remaining=narrow(torch.where(ok, lim - a, zero)),
        befores=narrow(befores),
        afters=narrow(a),
        over_limit=narrow(over_delta),
        near_limit=narrow(near_from_over + near_from_ok),
        within_limit=narrow(torch.where(ok, h, zero)),
        shadow_mode=narrow(torch.where(shadowed, h, zero)),
        set_local_cache=over,
    )


def fw_decision_block(
    afters: torch.Tensor,
    hits: torch.Tensor,
    limits: torch.Tensor,
    shadow: torch.Tensor,
    near_ratio: float,
) -> DeviceDecisions:
    """K3 decisions: the branch-free threshold state machine
    (limiter/base.py formulas; reference base_limiter.go:76-179) over
    u32 afters/hits/limits (int32 bits) and bool shadow."""
    n = afters.shape[0]
    device = afters.device
    _check_lanes(
        device,
        n,
        afters=(afters, torch.int32),
        hits=(hits, torch.int32),
        limits=(limits, torch.int32),
        shadow=(shadow, torch.bool),
    )
    if device.type == "cpu":
        return _decision_block_plain(afters, hits, limits, shadow, near_ratio)
    _require_cuda(device)
    out = torch.empty((8, n), dtype=torch.int32, device=device)
    set_lc = torch.empty(n, dtype=torch.bool, device=device)
    if n > 0:
        kernels.launch(
            "rl_fw_decision_block", K3_DECIDE, (afters, hits, limits, shadow, out),
            afters.data_ptr(), hits.data_ptr(), limits.data_ptr(),
            shadow.data_ptr(), float(near_ratio), n, out.data_ptr(),
            set_lc.data_ptr(), kernels.stream_ptr(device),
        )
    return DeviceDecisions(*out.unbind(0), set_lc)


class FixedWindowModel:
    """Configuration + steps for the counter table.

    `num_slots` is the table capacity (one u32 per slot in device
    memory, so 2**24 slots = 64 MiB).  `near_ratio` is the
    NEAR_LIMIT_RATIO knob (settings.go:48, default 0.8).  `device`
    defaults to the GPU; only an explicit "cpu" runs the plain
    versions on the CPU.
    """

    def __init__(self, num_slots: int, near_ratio: float = 0.8, device="cuda"):
        self.num_slots = int(num_slots)
        self.near_ratio = float(near_ratio)
        self.device = resolve_device(device)

    def init_state(self) -> torch.Tensor:
        """Fresh counter table (all windows empty)."""
        return torch.zeros(self.num_slots, dtype=torch.int32, device=self.device)

    def step_counters_unique_packed(
        self, counts: torch.Tensor, out_dtype: str, packed: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serving step (K1) fed by ONE packed int32[4, N] transfer:
        returns (counts, afters) with `counts` updated in place.  See
        ratelimit_tpu FixedWindowModel.step_counters_compact for why
        the saturated narrow readback loses no information."""
        return counts, fw_unique_step(counts, packed, out_dtype)

    def step_counters_unique_lanes(
        self, counts: torch.Tensor, out_dtype: str, words: torch.Tensor, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K1's by-value form: the same batch as
        step_counters_unique_packed, held in host memory, with the
        readback into `out` (pinned host memory on the card).  Returns
        (counts, out); wait on the stream before reading `out`."""
        return counts, fw_unique_step_lanes(counts, words, out, out_dtype)

    def step_counters_unique_mapped(
        self, counts: torch.Tensor, out_dtype: str, words: torch.Tensor, out: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving step in K1's mapped form: the batch of
        step_counters_unique_packed in pinned host memory, of any width,
        read by the kernel through its device alias, the readback into
        `out` (pinned).  Returns (counts, out); wait on the stream before
        reading `out` or reusing `words`."""
        return counts, fw_unique_step_mapped(counts, words, out, out_dtype)

    def step_counters_unique(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Counter update for a batch whose live slots are unique (K1):
        returns (counts, afters as int32 u32 bits).  Pads use distinct
        out-of-table ids (num_slots + i)."""
        return self.step_counters_unique_compact(counts, "", batch)

    def step_counters_unique_compact(
        self, counts: torch.Tensor, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1 with the saturated narrow readback min(after, limit + hits)
        as "uint8" or "uint16" (int16 storage); "" gives the raw
        afters.  The batch's rows are stacked into one int32[4, N]."""
        packed = torch.stack(
            [batch.slots, batch.hits, batch.limits, batch.fresh.to(torch.int32)]
        )
        return self.step_counters_unique_packed(counts, out_dtype, packed)

    def step_counters(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX model's name for `update`: (counts, afters)."""
        return self.update(counts, batch)

    def step_counters_compact(
        self, counts: torch.Tensor, out_dtype: str, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The duplicate-tolerant update (K3) with the saturated narrow
        readback min(after, limit + hits) as "uint8" or "uint16" (int16
        storage), written by the fused step's epilogue."""
        return counts, fw_general_update(
            counts, batch.slots, batch.hits, batch.fresh, batch.limits, out_dtype
        )

    def step(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, DeviceDecisions]:
        """The JAX model's name for `forward`: update + decision block."""
        return self.forward(counts, batch)

    def update(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Duplicate-tolerant counter update (K3): returns
        (counts, afters).  MODULAR u32 arithmetic, like the reference's
        scatter-add; serving never reaches it."""
        return counts, fw_general_update(counts, batch.slots, batch.hits, batch.fresh)

    def forward(
        self, counts: torch.Tensor, batch: DeviceBatch
    ) -> Tuple[torch.Tensor, DeviceDecisions]:
        """The flagship forward step: update + decision block, one launch
        (fw_general_step)."""
        return counts, fw_general_step(
            counts, batch.slots, batch.hits, batch.fresh, batch.limits,
            batch.shadow, self.near_ratio,
        )
