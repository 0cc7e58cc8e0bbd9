"""The port's fixed-window model against the JAX model, on the CPU.

The same seeded numpy inputs go through
ratelimit_tpu.models.fixed_window and ratelimit_tpu_torch.models
.fixed_window (device="cpu": the kernels' plain versions): the unique
packed serving step (K1) for each readback type, with saturation, pad
and fresh lanes; the duplicate-tolerant forward step (K3 + K2) on a
graft-like batch; slot ids in [-num_slots, -1], which JAX's gather
and scatter address numpy-style; and the state conversion helpers.  All
of it is integer arithmetic plus one IEEE f32 multiply, so equality is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxBatch
from ratelimit_tpu.models.fixed_window import FixedWindowModel as JaxModel
from ratelimit_tpu_torch.models.fixed_window import (
    DeviceBatch,
    FixedWindowModel,
    fw_decision_block,
    state_from_numpy,
    state_to_numpy,
)

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


def _packed(rng, n, num_slots, pad, hits_hi=6, limit_hi=300):
    """int32[4, n+pad] unique-slot batch + distinct out-of-table pads."""
    g = n
    slots = rng.choice(num_slots, size=g, replace=False).astype(np.int64)
    slots = np.concatenate([slots, np.arange(num_slots, num_slots + pad)])
    hits = np.concatenate(
        [rng.integers(1, hits_hi, g), np.zeros(pad, np.int64)]
    ).astype(np.uint32)
    limits = np.concatenate(
        [rng.integers(1, limit_hi, g), np.ones(pad, np.int64)]
    ).astype(np.uint32)
    fresh = np.concatenate([rng.random(g) < 0.2, np.zeros(pad, bool)])
    pk = np.empty((4, g + pad), dtype=np.int32)
    pk[0] = slots
    pk[1] = hits.view(np.int32)
    pk[2] = limits.view(np.int32)
    pk[3] = fresh
    return pk


def _as_u32(t):
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    if t.dtype == torch.int16:
        return t.numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
def test_unique_packed_step_matches_jax(out_dtype):
    num_slots = 200
    rng = np.random.default_rng(7)
    jmodel = JaxModel(num_slots)
    tmodel = FixedWindowModel(num_slots, device="cpu")
    # Start both from one table holding values near 2^32 - 1 so the
    # saturating add engages.
    start = rng.integers(0, 50, num_slots).astype(np.uint32)
    start[rng.choice(num_slots, 40, replace=False)] = 0xFFFFFFFF - rng.integers(
        0, 4, 40
    ).astype(np.uint32)
    jc = jnp.asarray(start)
    tc = state_from_numpy(start, device="cpu")
    for step in range(5):
        pk = _packed(rng, 24, num_slots, pad=8)
        jc, ja = jmodel.step_counters_unique_packed(jc, out_dtype, jnp.asarray(pk))
        tc2, ta = tmodel.step_counters_unique_packed(
            tc, out_dtype, torch.from_numpy(pk)
        )
        assert tc2 is tc  # in place
        np.testing.assert_array_equal(_as_u32(ta), np.asarray(ja))
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))
    assert (state_to_numpy(tc) == 0xFFFFFFFF).any()


def test_unique_packed_step_large_hits_saturate():
    """Group totals near 2^32 lap a counter: both clamp at u32 max."""
    num_slots = 16
    pk = np.zeros((4, 8), dtype=np.int32)
    pk[0] = np.arange(8)
    pk[1] = np.full(8, 0xFFFFFFF0, dtype=np.uint32).view(np.int32)
    pk[2] = np.full(8, 7, dtype=np.uint32).view(np.int32)
    jmodel, tmodel = JaxModel(num_slots), FixedWindowModel(num_slots, device="cpu")
    jc, tc = jmodel.init_state(), tmodel.init_state()
    for _ in range(2):
        jc, ja = jmodel.step_counters_unique_packed(jc, "", jnp.asarray(pk))
        tc, ta = tmodel.step_counters_unique_packed(tc, "", torch.from_numpy(pk))
        np.testing.assert_array_equal(_as_u32(ta), np.asarray(ja))
    np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))
    assert (np.asarray(jc)[:8] == 0xFFFFFFFF).all()


def _graft_batch(num_slots, n, seed=0):
    """The __graft_entry__.entry() batch recipe, at any size."""
    rng = np.random.default_rng(seed)
    return dict(
        slots=rng.integers(0, num_slots, n).astype(np.int32),
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(1, 1000, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=np.zeros(n, dtype=bool),
    )


def _torch_batch(raw):
    return DeviceBatch(
        slots=torch.from_numpy(raw["slots"]),
        hits=torch.from_numpy(raw["hits"].view(np.int32)),
        limits=torch.from_numpy(raw["limits"].view(np.int32)),
        fresh=torch.from_numpy(raw["fresh"]),
        shadow=torch.from_numpy(raw["shadow"]),
    )


def _compare_decisions(td, jd):
    for f in FIELDS:
        got = getattr(td, f).numpy()
        want = np.asarray(getattr(jd, f))
        if got.dtype == np.int32 and want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_forward_matches_jax_on_graft_batch():
    """The flagship forward step at 2^12 slots and 512 lanes, three
    steps so duplicates meet non-empty counters and fresh resets."""
    num_slots, n = 1 << 12, 512
    jmodel = JaxModel(num_slots)
    tmodel = FixedWindowModel(num_slots, device="cpu")
    jc, tc = jmodel.init_state(), tmodel.init_state()
    for seed in range(3):
        raw = _graft_batch(num_slots // 16, n, seed)  # many duplicates
        raw["shadow"] = np.random.default_rng(seed + 9).random(n) < 0.3
        jc, jd = jmodel.forward(jc, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}))
        tc, td = tmodel.forward(tc, _torch_batch(raw))
        _compare_decisions(td, jd)
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))
    assert (np.asarray(jd.codes) == 2).any() and (np.asarray(jd.codes) == 1).any()


def test_forward_pad_lanes_inert():
    num_slots = 64
    raw = _graft_batch(num_slots, 16, seed=3)
    raw["slots"][-4:] = num_slots + np.arange(4)
    jmodel, tmodel = JaxModel(num_slots), FixedWindowModel(num_slots, device="cpu")
    jc, jd = jmodel.forward(
        jmodel.init_state(), JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()})
    )
    tc, td = tmodel.forward(tmodel.init_state(), _torch_batch(raw))
    _compare_decisions(td, jd)
    np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))


@pytest.mark.parametrize("near_ratio", [0.8, 0.5, 1.0])
def test_decision_block_matches_jax_full_u32_range(near_ratio):
    """Threshold machine over the full u32 range (limits and afters at
    and above 2^31, where signed compares would go wrong)."""
    from ratelimit_tpu.models.fixed_window import decision_block

    rng = np.random.default_rng(11)
    n = 512
    limits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hits = rng.integers(0, 1 << 20, n).astype(np.uint32)
    afters = (limits.astype(np.int64) + rng.integers(-(1 << 21), 1 << 21, n)) & 0xFFFFFFFF
    afters = afters.astype(np.uint32)
    shadow = rng.random(n) < 0.5
    jd = decision_block(
        jnp.asarray(afters), jnp.asarray(hits), jnp.asarray(limits),
        jnp.asarray(shadow), near_ratio,
    )
    td = fw_decision_block(
        torch.from_numpy(afters.view(np.int32)),
        torch.from_numpy(hits.view(np.int32)),
        torch.from_numpy(limits.view(np.int32)),
        torch.from_numpy(shadow),
        near_ratio,
    )
    _compare_decisions(td, jd)


@pytest.mark.parametrize("num_slots", [200, 256])  # 256: JAX's row gather
def test_unique_step_negative_slot_ids_match_jax(num_slots):
    """Ids in [-ns, -1] address id + ns; ids below -ns or at/above ns
    are inert, in K1's plain version as in the JAX step."""
    ns = num_slots
    rng = np.random.default_rng(ns)
    start = rng.integers(0, 100, ns).astype(np.uint32)
    slots = np.array([-1, -ns, -ns - 1, 3, ns, -(ns // 2), 7, -(2**31)], np.int64)
    pk = np.zeros((4, len(slots)), np.int32)
    pk[0] = slots
    pk[1] = rng.integers(1, 9, len(slots))
    pk[2] = 10
    pk[3] = [0, 1, 0, 0, 0, 0, 1, 0]
    for out_dtype in ("", "uint8", "uint16"):
        jc, ja = JaxModel(ns).step_counters_unique_packed(
            jnp.asarray(start), out_dtype, jnp.asarray(pk)
        )
        tc = state_from_numpy(start, device="cpu")
        _, ta = FixedWindowModel(ns, device="cpu").step_counters_unique_packed(
            tc, out_dtype, torch.from_numpy(pk)
        )
        np.testing.assert_array_equal(_as_u32(ta), np.asarray(ja))
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))
    assert state_to_numpy(tc)[ns - 1] != start[ns - 1]  # -1 wrote slot ns-1


def test_forward_negative_slot_ids_match_jax():
    """K3's zero, gather and scatter-add normalise negative ids like
    JAX; the prefix (K2) compares raw ids, so -1 and ns - 1 share a
    slot but not a prefix, in both packages."""
    ns = 64
    rng = np.random.default_rng(4)
    jmodel, tmodel = JaxModel(ns), FixedWindowModel(ns, device="cpu")
    jc = jnp.asarray(rng.integers(0, 50, ns).astype(np.uint32))
    tc = state_from_numpy(np.asarray(jc), device="cpu")
    for seed in range(3):
        raw = _graft_batch(ns, 96, seed)
        raw["slots"] = rng.integers(-ns - 4, ns + 4, 96).astype(np.int32)
        jc, jd = jmodel.forward(jc, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}))
        tc, td = tmodel.forward(tc, _torch_batch(raw))
        _compare_decisions(td, jd)
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))


def test_state_round_trip():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    arr[:3] = [0, 0x7FFFFFFF, 0xFFFFFFFF]
    t = state_from_numpy(arr, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (1000,)
    np.testing.assert_array_equal(state_to_numpy(t), arr)
    # The JAX model's own table round-trips too.
    jstate = np.asarray(JaxModel(1000).init_state())
    np.testing.assert_array_equal(
        state_to_numpy(state_from_numpy(jstate, device="cpu")), jstate
    )


def test_model_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FixedWindowModel(16)
