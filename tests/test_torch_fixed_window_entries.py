"""The single-table model's JAX-named entries against the jitted JAX ones.

ratelimit_tpu/models/fixed_window.py jits five entries besides the
packed serving step: ``step`` (the forward step), ``step_counters``
(the update), ``step_counters_compact`` (the update with the saturated
narrow readback), ``step_counters_unique`` and
``step_counters_unique_compact`` (the unique-slot step on an unpacked
batch).  The same seeded numpy inputs go through each of them and
through the port's entry of the same name (device="cpu": the kernels'
plain versions), several steps from one table, in u32, u8 and u16
readback, with ids in [-num_slots, -1], ids past the table on both
sides, duplicates (the general entries) and totals that saturate (the
unique entries).  Integer arithmetic and one IEEE f32 multiply:
the tolerance is 0.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxBatch
from ratelimit_tpu.models.fixed_window import FixedWindowModel as JaxModel
from ratelimit_tpu_torch.models.fixed_window import (
    DeviceBatch,
    FixedWindowModel,
    fw_general_update,
    state_from_numpy,
    state_to_numpy,
)

NS = 256  # a multiple of 128: JAX's unique step takes its row gather
U32 = 0xFFFFFFFF
FIELDS = (
    "codes",
    "limit_remaining",
    "befores",
    "afters",
    "over_limit",
    "near_limit",
    "within_limit",
    "shadow_mode",
    "set_local_cache",
)


def _host(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the numpy array JAX returns: u32 bits as uint32,
    u16 (int16 storage) as uint16."""
    a = t.numpy()
    return {np.int32: a.view(np.uint32), np.int16: a.view(np.uint16)}.get(a.dtype.type, a)


def _start_table(rng) -> np.ndarray:
    """Small counts, with 40 slots a few hits short of u32 max."""
    start = rng.integers(0, 60, NS).astype(np.uint32)
    start[rng.choice(NS, 40, replace=False)] = U32 - rng.integers(0, 4, 40).astype(np.uint32)
    return start


def _general_batch(rng, n=96):
    """Duplicate ids over a few slots, their aliases id - NS, and ids past
    the table on both sides."""
    slots = rng.choice(np.arange(-NS, NS), 24, replace=False)[rng.integers(0, 24, n)]
    slots[:6] = [NS, NS + 3, -NS - 1, -NS - 9, -(2**31), 2**31 - 1]
    return dict(
        slots=slots.astype(np.int32),
        hits=rng.integers(1, 6, n).astype(np.uint32),
        limits=rng.integers(1, 400, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.3,
    )


def _unique_batch(rng, n=48):
    """Distinct table positions, about a third as their alias id - NS;
    some lanes with hits near 2^32 (saturating on a warm table); then
    distinct inert ids past either end of the table."""
    live = n - 8
    pos = rng.choice(NS, live, replace=False).astype(np.int64)
    pos[rng.random(live) < 0.35] -= NS
    slots = np.concatenate([pos, NS + np.arange(4), -NS - 1 - np.arange(4)])
    hits = rng.integers(0, 9, n).astype(np.uint32)
    hits[: live // 4] = U32 - rng.integers(0, 16, live // 4).astype(np.uint32)
    hits[live:] = 0
    limits = rng.integers(1, 300, n).astype(np.uint32)
    limits[live:] = 1
    fresh = rng.random(n) < 0.2
    fresh[live:] = False
    return dict(
        slots=slots.astype(np.int32), hits=hits, limits=limits, fresh=fresh,
        shadow=np.zeros(n, bool),
    )


def _jax(raw):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()})


def _port(raw):
    return DeviceBatch(
        slots=torch.from_numpy(raw["slots"]),
        hits=torch.from_numpy(raw["hits"].view(np.int32)),
        limits=torch.from_numpy(raw["limits"].view(np.int32)),
        fresh=torch.from_numpy(raw["fresh"]),
        shadow=torch.from_numpy(raw["shadow"]),
    )


def _compare(got, want, what):
    if isinstance(want, tuple):  # DeviceDecisions
        for f in FIELDS:
            np.testing.assert_array_equal(
                _host(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f"{what} {f}"
            )
        return
    np.testing.assert_array_equal(_host(got), np.asarray(want), err_msg=what)


ENTRIES = [
    ("step", None, _general_batch),
    ("step_counters", None, _general_batch),
    ("step_counters_compact", "uint8", _general_batch),
    ("step_counters_compact", "uint16", _general_batch),
    ("step_counters_unique", None, _unique_batch),
    ("step_counters_unique_compact", "uint8", _unique_batch),
    ("step_counters_unique_compact", "uint16", _unique_batch),
]


@pytest.mark.parametrize(
    "entry,out_dtype,make", ENTRIES, ids=[f"{e}-{d or 'u32'}" for e, d, _ in ENTRIES]
)
def test_entry_matches_jitted_jax(entry, out_dtype, make):
    rng = np.random.default_rng(zlib.crc32(f"{entry} {out_dtype}".encode()))
    jmodel, tmodel = JaxModel(NS), FixedWindowModel(NS, device="cpu")
    start = _start_table(rng)
    jc = jnp.asarray(start)
    tc = state_from_numpy(start, device="cpu")
    for step in range(4):
        raw = make(rng)
        args = () if out_dtype is None else (out_dtype,)
        jc, jout = getattr(jmodel, entry)(jc, *args, _jax(raw))
        tc2, tout = getattr(tmodel, entry)(tc, *args, _port(raw))
        assert tc2 is tc  # updated in place
        _compare(tout, jout, f"{entry} step {step}")
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc), err_msg=f"step {step}")
    if make is _unique_batch:
        assert (state_to_numpy(tc) == U32).any()  # some totals saturated


def test_compact_update_is_the_narrowed_update():
    """step_counters_compact's readback is min(after, limit + hits) of
    step_counters' afters, truncated, on the same table."""
    rng = np.random.default_rng(31)
    raw = _general_batch(rng)
    start = _start_table(rng)
    model = FixedWindowModel(NS, device="cpu")
    _, afters = model.step_counters(state_from_numpy(start, "cpu"), _port(raw))
    cap = (raw["limits"].astype(np.int64) + raw["hits"]) & U32
    sat = np.minimum(afters.numpy().view(np.uint32), cap)
    for out_dtype, np_type in (("uint8", np.uint8), ("uint16", np.uint16)):
        _, out = model.step_counters_compact(state_from_numpy(start, "cpu"), out_dtype, _port(raw))
        np.testing.assert_array_equal(_host(out), sat.astype(np_type))


def test_compact_update_needs_the_limits():
    lanes = torch.zeros(8, dtype=torch.int32)
    counts = torch.zeros(NS, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs the limits"):
        fw_general_update(counts, lanes, lanes, torch.zeros(8, dtype=torch.bool), None, "uint8")
    with pytest.raises(ValueError, match="out_dtype"):
        fw_general_update(counts, lanes, lanes, torch.zeros(8, dtype=torch.bool), lanes, "u4")
