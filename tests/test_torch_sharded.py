"""The port's bank-sharded table against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, one bank per
device; the port puts the same number of banks on the CPU
(``make_mesh(n, "cpu")``), where every kernel wrapper takes its plain
version.  The same numpy-seeded inputs go through both, and every
decision field, readback and the (num_banks, slots_per_bank) table must
be equal (tolerance 0): duplicates, fresh and shadow lanes, ids past the
table and negative ids -- which the sharded model treats as out of the
table while the single-table model wraps them -- in all three readback
types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.engine import CounterEngine as JaxCounterEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxDeviceBatch
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import HostBatch
from ratelimit_tpu_torch.models.fixed_window import (
    DeviceBatch,
    FixedWindowModel,
    state_from_numpy,
    state_to_numpy,
)
from ratelimit_tpu_torch.parallel import (
    ShardedCounterEngine,
    ShardedFixedWindowModel,
    make_mesh,
)
from ratelimit_tpu_torch.parallel import sharded

NUM_SLOTS = 64
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
_HOST = {
    torch.int32: np.uint32,
    torch.int16: np.uint16,
    torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def _u(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the unsigned numpy values JAX returns."""
    return t.numpy().view(_HOST[t.dtype])


def _raw_batch(rng, n, num_slots):
    """Duplicates (a small id range), fresh and shadow lanes, ids past
    the table and negative ids down to -num_slots - 4."""
    slots = rng.integers(-num_slots - 4, num_slots + 6, size=n).astype(np.int32)
    return dict(
        slots=slots,
        hits=rng.integers(1, 5, size=n).astype(np.uint32),
        limits=rng.integers(1, 12, size=n).astype(np.uint32),
        fresh=rng.random(n) < 0.15,
        shadow=rng.random(n) < 0.2,
    )


def _jax_batch(raw):
    return JaxDeviceBatch(**{k: jnp.asarray(v) for k, v in raw.items()})


def _port_batch(raw):
    return DeviceBatch(
        slots=torch.from_numpy(raw["slots"]),
        hits=torch.from_numpy(raw["hits"].view(np.int32)),
        limits=torch.from_numpy(raw["limits"].view(np.int32)),
        fresh=torch.from_numpy(raw["fresh"]),
        shadow=torch.from_numpy(raw["shadow"]),
    )


@pytest.mark.parametrize("n_banks", [1, 4, 8])
@pytest.mark.parametrize("variant", ["step", "step_counters", "uint8", "uint16"])
def test_model_matches_jax(n_banks, variant):
    """Six batches through both sharded models: step's nine decision
    fields, step_counters' afters or step_counters_compact's narrow
    readback, and the (num_banks, slots_per_bank) table."""
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(n_banks))
    tm = ShardedFixedWindowModel(NUM_SLOTS, make_mesh(n_banks, "cpu"))
    assert (tm.num_banks, tm.slots_per_bank) == (jm.num_banks, jm.slots_per_bank)
    jc, tc = jm.init_state(), tm.init_state()
    assert tuple(tc.shape) == (n_banks, NUM_SLOTS // n_banks)
    rng = np.random.default_rng(7 + n_banks)
    for step in range(6):
        raw = _raw_batch(rng, 32, NUM_SLOTS)
        jb, tb = _jax_batch(raw), _port_batch(raw)
        if variant == "step":
            jc, jd = jm.step(jc, jb)
            tc, td = tm.step(tc, tb)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    _u(getattr(td, f)).astype(np.int64),
                    np.asarray(getattr(jd, f)).astype(np.int64),
                    err_msg=f"step {step} {f}",
                )
        else:
            if variant == "step_counters":
                jc, ja = jm.step_counters(jc, jb)
                tc, ta = tm.step_counters(tc, tb)
            else:
                jc, ja = jm.step_counters_compact(jc, variant, jb)
                tc, ta = tm.step_counters_compact(tc, variant, tb)
            assert _u(ta).dtype == np.asarray(ja).dtype
            np.testing.assert_array_equal(_u(ta), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc), err_msg=f"step {step}")


def test_negative_ids_are_out_of_table_unlike_one_table():
    """Id -1 addresses the last slot of one table (JAX's index
    semantics) but is out of a sharded table (the JAX sharded model
    masks ids to [0, num_slots)): the two models part ways, in both
    packages alike."""
    raw = dict(
        slots=np.array([-1, -1, NUM_SLOTS - 1], np.int32),
        hits=np.array([2, 3, 4], np.uint32),
        limits=np.full(3, 100, np.uint32),
        fresh=np.zeros(3, bool),
        shadow=np.zeros(3, bool),
    )
    one = FixedWindowModel(NUM_SLOTS, device="cpu")
    oc = one.init_state()
    tm = ShardedFixedWindowModel(NUM_SLOTS, make_mesh(8, "cpu"))
    tc = tm.init_state()
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(8))
    jc = jm.init_state()
    for _ in range(2):  # the second step reads what the first wrote
        oc, one_afters = one.update(oc, _port_batch(raw))
        tc, t_afters = tm.step_counters(tc, _port_batch(raw))
        jc, j_afters = jm.step_counters(jc, _jax_batch(raw))
    # One table: -1 and 63 share slot 63 (the prefix keeps raw ids apart).
    assert _u(one_afters).tolist() == [11, 14, 13]
    assert int(state_to_numpy(oc)[NUM_SLOTS - 1]) == 18
    # Sharded: -1 reads a zero counter and scatters nowhere.
    assert _u(t_afters).tolist() == np.asarray(j_afters).tolist() == [2, 5, 8]
    np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc))
    assert int(state_to_numpy(tc).sum()) == 8


def _routed_raw(rng, nb, spb, cap, table):
    """int32[nb, 4, cap] routed rows: per bank distinct live local ids
    (about a third as their alias id - spb), fresh lanes, lanes whose
    add saturates, then padding ids spb + i."""
    pk = np.zeros((nb, 4, cap), np.int32)
    pk[:, 0] = spb + np.arange(cap)
    pk[:, 2] = 1
    for b in range(nb):
        live = int(rng.integers(0, min(cap, spb) + 1))
        ids = rng.choice(spb, live, replace=False).astype(np.int64)
        alias = rng.random(live) < 0.35
        ids[alias] -= spb
        hits = rng.integers(0, 40, live).astype(np.uint32)
        hot = table[b, ids % spb] > U32 - 64
        hits[hot] = rng.integers(60, 200, int(hot.sum()))
        pk[b, 0, :live] = ids
        pk[b, 1, :live] = hits.view(np.int32)
        pk[b, 2, :live] = rng.integers(1, 300, live).astype(np.uint32).view(np.int32)
        pk[b, 3, :live] = rng.random(live) < 0.2
    return pk


def _seeded_table(rng, nb, spb):
    table = rng.integers(0, 300, (nb, spb)).astype(np.uint32)
    table[rng.random((nb, spb)) < 0.2] = U32 - 10
    return table


@pytest.mark.parametrize("variant", ["packed", "unpacked"])
@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
def test_routed_step_matches_jax(out_dtype, variant):
    """step_counters_unique_routed[_packed] (K6's plain version) against
    the JAX routed step over several batches: local ids in [-spb, -1],
    padding, fresh and saturating lanes, all three readback types."""
    nb = 8
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(nb))
    tm = ShardedFixedWindowModel(NUM_SLOTS, make_mesh(nb, "cpu"))
    spb = tm.slots_per_bank
    rng = np.random.default_rng(11)
    table = _seeded_table(rng, nb, spb)
    jc = jnp.asarray(table)
    tc = state_from_numpy(table, "cpu")
    for step, cap in enumerate((8, 16, 8, 32)):
        pk = _routed_raw(rng, nb, spb, cap, state_to_numpy(tc))
        if variant == "packed":
            jc, ja = jm.step_counters_unique_routed_packed(jc, out_dtype, pk)
            tc, ta = tm.step_counters_unique_routed_packed(tc, out_dtype, torch.from_numpy(pk))
        else:
            jb = JaxDeviceBatch(
                slots=jnp.asarray(pk[:, 0]),
                hits=jnp.asarray(pk[:, 1].view(np.uint32)),
                limits=jnp.asarray(pk[:, 2].view(np.uint32)),
                fresh=jnp.asarray(pk[:, 3] != 0),
                shadow=jnp.zeros((nb, cap), bool),
            )
            jc, ja = jm.step_counters_unique_routed(jc, out_dtype, jb)
            tb = DeviceBatch(
                *(torch.from_numpy(pk[:, r].copy()) for r in range(3)),
                fresh=torch.from_numpy(pk[:, 3] != 0),
                shadow=torch.zeros((nb, cap), dtype=torch.bool),
            )
            tc, ta = tm.step_counters_unique_routed(tc, out_dtype, tb)
        assert tuple(ta.shape) == (nb, cap)
        assert _u(ta).dtype == np.asarray(ja).dtype
        np.testing.assert_array_equal(_u(ta), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc), err_msg=f"step {step}")
    assert (state_to_numpy(tc) == U32).any()  # some lanes saturated


# -- the engine --------------------------------------------------------


def _engines(n_banks=8, num_slots=NUM_SLOTS, buckets=(8, 32)):
    return (
        JaxShardedEngine(jax_make_mesh(n_banks), num_slots=num_slots, buckets=buckets),
        ShardedCounterEngine(make_mesh(n_banks, "cpu"), num_slots=num_slots, buckets=buckets),
    )


def _assert_same(dj, dt, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(dt, f)).astype(np.int64),
            np.asarray(getattr(dj, f)).astype(np.int64),
            err_msg=f"{what} {f}",
        )


def _uniform(rng, step, nb, spb, ns):
    n = int(rng.integers(1, 70))  # crosses the max_batch chunking
    return dict(
        slots=rng.integers(0, ns, n).astype(np.int32),
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(1, 10, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.3,
    )


def _skewed(rng, step, nb, spb, ns):
    """Every lane in bank 0 (multiples of num_banks), few distinct ids:
    heavy duplicates; first sightings fresh on the first step."""
    n = 40
    slots = (rng.integers(0, max(spb // 2, 2), n) * nb).astype(np.int32)
    fresh = np.zeros(n, bool)
    if step == 0:
        fresh[np.unique(slots, return_index=True)[1]] = True
    return dict(
        slots=slots,
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=np.full(n, 9, np.uint32),
        fresh=fresh,
        shadow=rng.random(n) < 0.2,
    )


def _probes(rng, step, nb, spb, ns):
    """Warmup-style lanes: distinct ids past the table, hits 0, beside
    live lanes with u16 and u32 limits."""
    n = 8
    return dict(
        slots=np.concatenate([np.arange(ns, ns + n), rng.integers(0, ns, n)]).astype(np.int32),
        hits=np.concatenate([np.zeros(n), rng.integers(1, 4, n)]).astype(np.uint32),
        limits=np.array([100, 60_000, 3_000_000_000, 7] * 4, np.uint32),
        fresh=np.zeros(2 * n, bool),
        shadow=np.zeros(2 * n, bool),
    )


@pytest.mark.parametrize("case", [_uniform, _skewed, _probes], ids=["uniform", "skew", "probes"])
def test_engine_matches_jax(case):
    """The routed serving engine (K6 on the CPU) against the JAX sharded
    engine: every decision field and export_counts() in global order."""
    je, te = _engines()
    m = te.model
    rng = np.random.default_rng(21)
    for step in range(5):
        raw = case(rng, step, m.num_banks, m.slots_per_bank, m.num_slots)
        dj = je.step(JaxHostBatch(**raw))
        dt = te.step(HostBatch(**raw))
        _assert_same(dj, dt, f"step {step}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
        assert te.stat_bank_lane_counts == je.stat_bank_lane_counts
    assert te.stat_window_rollovers == je.stat_window_rollovers


def test_slot_count_rounds_up_to_the_banks():
    m = ShardedFixedWindowModel(100, make_mesh(8, "cpu"))
    assert (m.num_slots, m.slots_per_bank) == (104, 13)
    assert tuple(m.init_state().shape) == (8, 13)
    assert ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=100).slot_table.num_slots == 104


def test_routed_width_is_below_the_batch():
    """256 distinct lanes over 8 banks: each bank gets its share (cap
    bucket below 256), and the readback is unrouted on the host."""
    te = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=1 << 10, buckets=(8, 32, 128, 256))
    rng = np.random.default_rng(9)
    n = 256
    hb = HostBatch(
        slots=rng.choice(1 << 10, n, replace=False).astype(np.int32),
        hits=np.ones(n, np.uint32),
        limits=np.full(n, 10, np.uint32),
        fresh=np.zeros(n, bool),
        shadow=np.zeros(n, bool),
    )
    token = te.step_submit(hb)
    (_, readback), _start, _count, _dedup, reassemble = token[3][0]
    assert readback.shape[0] == 8 and readback.shape[1] < n
    assert reassemble is not None
    assert sum(te.stat_bank_lane_counts) == n
    np.testing.assert_array_equal(te.step_complete(token).afters, np.ones(n))


def test_warmup_reaches_every_routed_shape():
    """The cache's warmup drives every (bucket, readback type) routed
    shape through the all-one-bank probes -- 8 banks x cap 8 in K6's
    by-value form, cap 32 in its mapped form -- and leaves the counters
    and the slot table untouched."""
    buckets = (8, 32)
    te = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=1 << 10, buckets=buckets)
    cache = CudaRateLimitCache(te)
    seen = []
    m = te.model
    by_value, mapped = m.step_counters_unique_routed_lanes, m.step_counters_unique_routed_mapped
    packed_step = m.step_counters_unique_routed_packed

    def spy_lanes(counts, out_dtype, words, out):
        seen.append((out_dtype, words.shape[2], "lanes"))
        return by_value(counts, out_dtype, words, out)

    def spy_mapped(counts, out_dtype, words, out):
        seen.append((out_dtype, words.shape[2], "mapped"))
        return mapped(counts, out_dtype, words, out)

    def spy_packed(counts, out_dtype, packed):
        seen.append((out_dtype, packed.shape[2], "device"))
        return packed_step(counts, out_dtype, packed)

    m.step_counters_unique_routed_lanes = spy_lanes
    m.step_counters_unique_routed_mapped = spy_mapped
    m.step_counters_unique_routed_packed = spy_packed
    try:
        cache.warmup()
    finally:
        cache.close()
    for bucket, form in zip(buckets, ("lanes", "mapped")):
        for dt in ("uint8", "uint16", ""):
            assert (dt, bucket, form) in seen, sorted(set(seen))
    assert not [s for s in seen if s[2] == "device"], sorted(set(seen))
    assert not te.export_counts().any()
    assert len(te.slot_table) == 0
    # Staging sized for the widest routed shape: num_banks x 4 x cap.
    assert te._staging_size() == (8 * 4 * 32, 8 * 4 * 32)


def test_checkpoints_cross_between_packages():
    """export_counts/import_counts in global slot order both ways, then
    the same batch through both engines gives the same decisions; a
    JAX (nb, spb) table becomes the port's table as is."""
    je, te = _engines()
    rng = np.random.default_rng(5)
    m = te.model
    for _ in range(2):
        je.step(JaxHostBatch(**_uniform(rng, 0, m.num_banks, m.slots_per_bank, m.num_slots)))
    te.import_counts(je.export_counts())
    np.testing.assert_array_equal(te.export_counts(), je.export_counts())
    np.testing.assert_array_equal(state_to_numpy(te._counts), np.asarray(je._counts))
    np.testing.assert_array_equal(
        state_to_numpy(state_from_numpy(np.asarray(je._counts), "cpu")), np.asarray(je._counts)
    )
    raw = _skewed(rng, 1, m.num_banks, m.slots_per_bank, m.num_slots)
    _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)))
    # ...and back: advance the port, import into a fresh JAX engine.
    raw = _uniform(rng, 2, m.num_banks, m.slots_per_bank, m.num_slots)
    te.step(HostBatch(**raw))
    je2 = JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=(8, 32))
    je2.import_counts(te.export_counts())
    je.step(JaxHostBatch(**raw))
    np.testing.assert_array_equal(je2.export_counts(), je.export_counts())
    with pytest.raises(ValueError):
        te.import_counts(np.zeros(10, np.uint32))


def test_sharded_engine_matches_one_table_engine():
    """With only in-table ids the sharded engine answers as the
    single-table engine of the JAX package does."""
    _, te = _engines()
    je = JaxCounterEngine(num_slots=NUM_SLOTS, buckets=(8, 32))
    rng = np.random.default_rng(3)
    for step in range(4):
        raw = _uniform(rng, step, 8, 8, NUM_SLOTS)
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)), f"step {step}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())


# -- the mesh and the wrappers -------------------------------------------


def _fake_cards(monkeypatch, cards):
    """A host with `cards` visible CUDA cards, each able to map every
    other's memory, as make_mesh asks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(kernels, "enable_peer", lambda device, peer: True)


@pytest.mark.parametrize("cards", [2, 4])
def test_default_mesh_is_one_bank_per_card(monkeypatch, cards):
    """One bank per visible card, one group each, as JAX's make_mesh()
    takes every local device; the home device is the first card."""
    _fake_cards(monkeypatch, cards)
    for mesh in (make_mesh(), make_mesh(device="cuda")):
        assert mesh.num_banks == mesh.groups == cards
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(cards))
        assert (mesh.banks_per_group, mesh.device) == (1, torch.device("cuda", 0))
    # A named card is one bank there, as before.
    assert make_mesh(device="cuda:1").devices == (torch.device("cuda", 1),)


@pytest.mark.parametrize("cards", [2, 4])
def test_default_mesh_sizes_the_default_engine(monkeypatch, cards):
    """The runner's default mesh for cuda-sharded (make_mesh(device=
    "cuda")) is the mesh above: a model on it has one group per card."""
    _fake_cards(monkeypatch, cards)
    mesh = make_mesh(device="cuda")
    m = ShardedFixedWindowModel(1 << 10, mesh)
    assert (m.num_banks, m.groups, m.banks_per_group) == (cards, cards, 1)
    assert m.slots_per_bank * cards == m.num_slots >= 1 << 10


def test_mesh_of_groups_validates_devices_and_banks(monkeypatch):
    mesh = make_mesh(8, devices=("cpu",) * 4)
    assert (mesh.num_banks, mesh.groups, mesh.banks_per_group) == (8, 4, 2)
    assert mesh.device == torch.device("cpu")
    assert make_mesh(devices=("cpu", "cpu")).num_banks == 2
    with pytest.raises(ValueError, match="split evenly"):
        make_mesh(8, devices=("cpu",) * 3)
    with pytest.raises(ValueError, match="at least one bank"):
        make_mesh(0, devices=("cpu",) * 2)
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(8, devices=())
    with pytest.raises(ValueError, match="not both"):
        make_mesh(8, "cpu", devices=("cpu",))
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(8, devices=("meta",))
    _fake_cards(monkeypatch, 2)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(2, devices=("cpu", "cuda:0"))
    # One card may hold several groups.
    assert make_mesh(8, devices=("cuda:0",) * 4).devices == (torch.device("cuda", 0),) * 4


def test_mesh_banks_on_one_device():
    assert make_mesh(device="cpu").num_banks == 1
    mesh = make_mesh(8, "cpu")
    assert (mesh.num_banks, mesh.device) == (8, torch.device("cpu"))
    assert mesh.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="at least one bank"):
        make_mesh(0, "cpu")


def test_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal needs a CUDA-less host")
    for kwargs in (dict(), dict(n_banks=8), dict(n_banks=8, device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(**kwargs)


def test_wrappers_refuse_devices_without_a_kernel():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA
    card is refused, never handed to the plain version."""
    counts = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sharded.sharded_routed_step(
            counts, torch.zeros((2, 4, 8), dtype=torch.int32, device="meta")
        )
    lanes = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sharded.sharded_general_update(
            counts, lanes, lanes, torch.zeros(8, dtype=torch.bool, device="meta")
        )
    with pytest.raises(ValueError, match="needs the limits"):
        sharded.sharded_general_update(
            torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.bool),
            out_dtype="uint8",
        )
