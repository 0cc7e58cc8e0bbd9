"""The served unique-slot step's by-value form, on the CPU.

A served chunk of at most 128 padded lanes (banks x cap) goes to K1 /
K6 by value: the host words ride in the launch and the kernel writes the
readback into pinned host memory, so the engine makes no upload and no
readback copy.  The batch's shape alone picks the form
(``lanes_by_value``).  On the CPU the by-value wrappers run the same
plain versions as the device form, into the caller's `out`, so these
tests hold:

- the form choice at every default bucket and at 8 banks x cap 8, 16
  and 32, and its lane count against the kernels' kMaxLanes;
- each by-value wrapper against its device-form wrapper on the same
  inputs, in u32, u8 and u16;
- CounterEngine and ShardedCounterEngine (device="cpu") against the JAX
  engines over a served sequence that crosses a window and saturates,
  with every chunk taking the by-value form, and a wide chunk the
  device form;
- two submissions in flight completed out of order, each reading its
  own readback.
"""

import os
import re

import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.dispatcher import Lane as JaxLane
from ratelimit_tpu.backends.dispatcher import LanePack as JaxLanePack
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch.backends.dispatcher import Lane, LanePack
from ratelimit_tpu_torch.backends.engine import DEFAULT_BUCKETS, CounterEngine, HostBatch
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.parallel import sharded

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
CSRC = os.path.join(os.path.dirname(__file__), "..", "ratelimit_tpu_torch", "csrc")


def _assert_same(dj, dt, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(dt, f)).astype(np.int64),
            np.asarray(getattr(dj, f)).astype(np.int64),
            err_msg=f"{what} {f}",
        )


# -- the form choice -------------------------------------------------------

FORMS = [(1, b, b <= 128) for b in DEFAULT_BUCKETS] + [
    (8, 8, True),
    (8, 16, True),
    (8, 32, False),
]


@pytest.mark.parametrize("banks,padded,by_value", FORMS)
def test_form_is_chosen_by_shape(banks, padded, by_value):
    assert fw.lanes_by_value(banks, padded) is by_value


def test_budget_matches_the_kernel():
    """MAX_LANES is the kernels' kMaxLanes, and each by-value parameter
    struct -- K1/K6's LaneBatch, K4/K5's AlgoLanes, both at kMaxLanes
    records -- is checked against 4 KB at compile time."""
    src = {}
    for name in ("by_value.cuh", "counter_update.cuh", "algorithms.cu"):
        with open(os.path.join(CSRC, name)) as f:
            src[name] = f.read()
    head = src["by_value.cuh"]
    max_lanes = int(re.search(r"constexpr int kMaxLanes = (\d+);", head).group(1))
    assert fw.MAX_LANES == max_lanes
    assert "constexpr int kParamBytes = 4096;" in head
    assert "int4 lane[kMaxLanes];" in src["counter_update.cuh"]
    assert "static_assert(sizeof(LaneBatch) <= kParamBytes" in src["counter_update.cuh"]
    assert "int4 lane[kMaxLanes];" in src["algorithms.cu"]
    assert "uint32_t divider[kMaxLanes];" in src["algorithms.cu"]
    assert "static_assert(sizeof(AlgoLanes) <= kParamBytes" in src["algorithms.cu"]
    assert fw.lanes_by_value(1, max_lanes) and not fw.lanes_by_value(1, max_lanes + 1)
    assert fw.lanes_by_value(8, max_lanes // 8) and not fw.lanes_by_value(8, max_lanes // 4)


# -- the by-value wrappers against the device-form wrappers ----------------


def _unique_words(rng, n, ns):
    """int32[4, n]: distinct slots (some as their alias id - ns, some
    near u32 max with large hits), distinct pads past the table."""
    pad = n // 4
    g = n - pad
    slots = rng.choice(ns, g, replace=False).astype(np.int64)
    slots[rng.random(g) < 0.35] -= ns
    slots = np.concatenate([slots, ns + np.arange(pad)])
    hits = rng.integers(0, 30, n).astype(np.uint32)
    hits[: max(1, g // 4)] = U32 - rng.integers(0, 4, max(1, g // 4)).astype(np.uint32)
    limits = rng.integers(1, 200, n).astype(np.uint32)
    fresh = rng.random(n) < 0.2
    hits[g:], limits[g:], fresh[g:] = 0, 1, False
    return np.stack(
        [slots.astype(np.int32), hits.view(np.int32), limits.view(np.int32), fresh]
    ).astype(np.int32)


def _warm_table(rng, ns):
    start = rng.integers(0, 100, ns).astype(np.uint32)
    start[rng.choice(ns, ns // 4, replace=False)] = U32 - 2
    return torch.from_numpy(start.view(np.int32))


@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
@pytest.mark.parametrize("n", [1, 8, 13, 128])
def test_k1_lanes_equals_device_form(n, out_dtype):
    rng = np.random.default_rng(n)
    ns = 512
    base = _warm_table(rng, ns)
    for _ in range(3):
        words = torch.from_numpy(_unique_words(rng, n, ns))
        ck, cd = base.clone(), base.clone()
        out = torch.full((n,), 7, dtype=fw.OUT_DTYPES[out_dtype])
        got = fw.fw_unique_step_lanes(ck, words, out, out_dtype)
        assert got is out
        want = fw.fw_unique_step(cd, words.clone(), out_dtype)
        assert torch.equal(out, want)
        assert torch.equal(ck, cd)
        base = ck


@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "one-bank"])
def test_k6_lanes_equals_device_form(skew, out_dtype):
    """8 banks x cap 16, the widest routed batch that goes by value."""
    rng = np.random.default_rng(int(skew))
    nb, spb, cap = 8, 64, 16
    base = _warm_table(rng, nb * spb).view(nb, spb)
    words = np.zeros((nb, 4, cap), np.int32)
    words[:, 0] = spb + np.arange(cap)
    words[:, 2] = 1
    for b in ([0] if skew else range(nb)):
        live = cap if skew else int(rng.integers(1, cap))
        local = rng.choice(spb, live, replace=False).astype(np.int64)
        local[rng.random(live) < 0.35] -= spb
        words[b, 0, :live] = local
        hits = rng.integers(0, 30, live).astype(np.uint32)
        hits[: live // 3] = U32 - 1
        words[b, 1, :live] = hits.view(np.int32)
        words[b, 2, :live] = rng.integers(1, 200, live)
        words[b, 3, :live] = rng.random(live) < 0.2
    words = torch.from_numpy(words)
    ck, cd = base.clone(), base.clone()
    out = torch.zeros((nb, cap), dtype=fw.OUT_DTYPES[out_dtype])
    sharded.sharded_routed_step_lanes(ck, words, out, out_dtype)
    assert torch.equal(out, sharded.sharded_routed_step(cd, words.clone(), out_dtype))
    assert torch.equal(ck, cd)


def test_lanes_wrappers_refuse_what_the_kernel_does_not_take():
    counts = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="device form"):
        fw.fw_unique_step_lanes(
            counts, torch.zeros((4, 129), dtype=torch.int32), torch.zeros(129, dtype=torch.int32)
        )
    with pytest.raises(TypeError, match="out must be"):
        fw.fw_unique_step_lanes(
            counts, torch.zeros((4, 8), dtype=torch.int32), torch.zeros(8, dtype=torch.int32), "uint8"
        )
    with pytest.raises(TypeError, match="words must be"):
        sharded.sharded_routed_step_lanes(
            torch.zeros((8, 8), dtype=torch.int32),
            torch.zeros((4, 4, 8), dtype=torch.int32),
            torch.zeros((4, 8), dtype=torch.int32),
        )
    # The kernel writes the readback into host memory through its device
    # alias: a readback buffer on a device is refused.
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        fw.fw_unique_step_lanes(
            counts, torch.zeros((4, 8), dtype=torch.int32), torch.zeros(8, dtype=torch.int32, device="meta")
        )
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        sharded.sharded_routed_step_lanes(
            torch.zeros((8, 8), dtype=torch.int32),
            torch.zeros((8, 4, 8), dtype=torch.int32),
            torch.zeros((8, 8), dtype=torch.int32, device="meta"),
        )
    # No fallback: a table on a device without a kernel is refused.
    with pytest.raises(ValueError, match="unsupported device"):
        fw.fw_unique_step_lanes(
            torch.zeros(64, dtype=torch.int32, device="meta"),
            torch.zeros((4, 8), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32),
        )


# -- the engines ------------------------------------------------------------


def _count_forms(engine, lanes_name, packed_name):
    """Wrap the model's two serving entries to count the chunks each
    form served."""
    forms = {"lanes": 0, "device": 0}
    m = engine.model
    for form, name in (("lanes", lanes_name), ("device", packed_name)):
        orig = getattr(m, name)

        def spy(*args, _orig=orig, _form=form):
            forms[_form] += 1
            return _orig(*args)

        setattr(m, name, spy)
    return forms


def _served_lanes(rng, now, step):
    """One coalesced chunk of a served sequence: a 5/min key hit once or
    twice per step (its window key changes at the minute), a key that
    laps u32 with huge hits_addend, and a few other keys."""
    window = now // 60
    lanes = [Lane(f"rl_foo_x_{window}", (window + 1) * 60, 5, False, 1)]
    lanes += [Lane(f"rl_foo_x_{window}", (window + 1) * 60, 5, step % 3 == 0, 1)] * (step % 2)
    lanes.append(Lane(f"rl_big_y_{window}", (window + 1) * 60, 1000, False, 0xFFFFFFF0))
    for _ in range(int(rng.integers(0, 10))):
        k = int(rng.integers(0, 30))
        lanes.append(Lane(f"rl_k_{k}_{window}", (window + 1) * 60, 3, False, int(rng.integers(1, 3))))
    return lanes


def _jax_pack(lanes):
    return JaxLanePack.from_lanes([JaxLane(*vars(x).values()) for x in lanes])


def test_engine_serves_by_value_like_jax():
    """A served sequence through both CounterEngines: the 5/min key goes
    OVER_LIMIT, its next window starts at 1 again, the lapping key
    saturates; every chunk takes the by-value form."""
    je = JaxEngine(num_slots=64, buckets=(8, 16, 32))
    te = CounterEngine(num_slots=64, buckets=(8, 16, 32), device="cpu")
    forms = _count_forms(te, "step_counters_unique_lanes", "step_counters_unique_packed")
    rng = np.random.default_rng(12)
    now = 1_700_000_000 - 50  # crosses a minute boundary on the way
    codes = []
    for step in range(14):
        lanes = _served_lanes(rng, now, step)
        tp, jp = LanePack.from_lanes(lanes), _jax_pack(lanes)
        dj = je.step_complete(je.submit_packed(now, jp.key_blob, jp.meta))
        dt = te.step_complete(te.submit_packed(now, tp.key_blob, tp.meta))
        _assert_same(dj, dt, f"step {step}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
        codes.append(int(dt.codes[0]))
        now += 7
    assert forms == {"lanes": 14, "device": 0}
    assert 2 in codes and codes[-1] == 1  # over in one window, fresh in the next
    assert (te.export_counts() == U32).any()


def test_wide_chunk_takes_the_device_form():
    """200 distinct lanes pad to 256, past the by-value budget: upload,
    kernel, readback copy -- the same answers."""
    je = JaxEngine(num_slots=512, buckets=(8, 128, 256))
    te = CounterEngine(num_slots=512, buckets=(8, 128, 256), device="cpu")
    forms = _count_forms(te, "step_counters_unique_lanes", "step_counters_unique_packed")
    rng = np.random.default_rng(2)
    for n in (200, 100):
        raw = dict(
            slots=rng.choice(512, n, replace=False).astype(np.int32),
            hits=rng.integers(1, 5, n).astype(np.uint32),
            limits=rng.integers(1, 90_000, n).astype(np.uint32),
            fresh=rng.random(n) < 0.1,
            shadow=np.zeros(n, bool),
        )
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)), f"n={n}")
    assert forms == {"lanes": 1, "device": 1}
    np.testing.assert_array_equal(te.export_counts(), je.export_counts())


def _sharded_batch(rng, step, ns):
    """Lanes over all 8 banks with duplicates, fresh slots at the first
    step and after a window change (step 3), hits that lap u32."""
    n = int(rng.integers(4, 40))
    slots = rng.integers(0, ns, n).astype(np.int32)
    slots[:3] = 5
    fresh = np.zeros(n, bool)
    if step in (0, 3):
        fresh[np.unique(slots, return_index=True)[1]] = True
    hits = rng.integers(1, 4, n).astype(np.uint32)
    hits[:3] = 0x7FFFFFFF  # slot 5 laps u32 in every batch
    return dict(
        slots=slots, hits=hits, limits=rng.integers(1, 10, n).astype(np.uint32),
        fresh=fresh, shadow=rng.random(n) < 0.2,
    )


def test_sharded_engine_serves_by_value_like_jax():
    je = JaxShardedEngine(jax_make_mesh(8), num_slots=128, buckets=(8, 16, 32))
    te = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=128, buckets=(8, 16, 32))
    forms = _count_forms(
        te, "step_counters_unique_routed_lanes", "step_counters_unique_routed_packed"
    )
    rng = np.random.default_rng(8)
    for step in range(6):
        raw = _sharded_batch(rng, step, 128)
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)), f"step {step}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
    # 8 banks x cap 8 or 16: every chunk by value (a batch past
    # max_batch is two chunks).
    assert forms["lanes"] >= 6 and forms["device"] == 0
    assert (te.export_counts() == U32).any()


@pytest.mark.parametrize("kind", ["one table", "8 banks"])
def test_in_flight_submits_complete_out_of_order(kind):
    """Two submissions in flight, completed newest first (step_complete
    may run on another thread than the submit): each reads back its own
    readback, and both staging objects return to the free list."""
    if kind == "one table":
        je = JaxEngine(num_slots=64, buckets=(8, 16, 32))
        te = CounterEngine(num_slots=64, buckets=(8, 16, 32), device="cpu")
    else:
        je = JaxShardedEngine(jax_make_mesh(8), num_slots=128, buckets=(8, 16, 32))
        te = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=128, buckets=(8, 16, 32))
    rng = np.random.default_rng(40)
    raws = [_sharded_batch(rng, 1, 64) for _ in range(2)]
    tokens = [te.step_submit(HostBatch(**r)) for r in raws]
    st_a, st_b = tokens[0][3][0][0][0], tokens[1][3][0][0][0]
    assert st_a is not st_b
    out_b = te.step_complete(tokens[1])
    out_a = te.step_complete(tokens[0])
    _assert_same(je.step(JaxHostBatch(**raws[0])), out_a, "first")
    _assert_same(je.step(JaxHostBatch(**raws[1])), out_b, "second")
    assert {id(s) for s in te._free_staging} == {id(st_a), id(st_b)}
