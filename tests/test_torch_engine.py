"""The port's CounterEngine against the JAX engine, on the CPU.

The same HostBatch sequences and the same submit_packed blobs go
through ratelimit_tpu.backends.engine.CounterEngine and
ratelimit_tpu_torch.backends.engine.CounterEngine(device="cpu"), and
every HostDecisions field and the exported counter table must be
equal: duplicates (host dedup + pipeline-order reconstruction), u8 /
u16 / u32 readback, u32 saturation, fresh slots, batches wider than
max_batch, and checkpoints exported by one engine imported into the
other.  The generic algorithm protocol (sliding-window and GCRA banks)
runs the same duplicate-laden streams through both packages' engines.
"""

import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.dispatcher import LanePack as JaxLanePack
from ratelimit_tpu.backends.dispatcher import Lane as JaxLane
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu_torch.backends.dispatcher import Lane, LanePack
from ratelimit_tpu_torch.backends.engine import CounterEngine, HostBatch
from ratelimit_tpu_torch.models.registry import get_algorithm

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
BUCKETS = (8, 16, 32)


def _engines(num_slots=256, native_table=None):
    return (
        JaxEngine(num_slots=num_slots, buckets=BUCKETS, native_table=native_table),
        CounterEngine(
            num_slots=num_slots,
            buckets=BUCKETS,
            device="cpu",
            native_table=native_table,
        ),
    )


def _assert_same(dj, dt):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(dt, f)), np.asarray(getattr(dj, f)), err_msg=f
        )


def _host_batch(rng, n, num_slots, max_limit, max_hits):
    return dict(
        slots=rng.integers(0, num_slots // 4, n).astype(np.int32),
        hits=rng.integers(1, max_hits, n).astype(np.uint32),
        limits=rng.integers(1, max_limit, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.2,
    )


@pytest.mark.parametrize(
    "max_limit,max_hits",
    [(50, 4), (5_000, 40), (3_000_000_000, 1_000_000)],  # u8, u16, u32
)
def test_host_batches_match_jax(max_limit, max_hits):
    je, te = _engines()
    rng = np.random.default_rng(max_limit)
    for n in (5, 32, 80):  # 80 > max_batch: three chunks
        raw = _host_batch(rng, n, 256, max_limit, max_hits)
        dj = je.step(JaxHostBatch(**raw))
        dt = te.step(HostBatch(**raw))
        _assert_same(dj, dt)
        np.testing.assert_array_equal(
            te.export_state()["counts"], je.export_state()["counts"]
        )
    assert te.stat_window_rollovers == je.stat_window_rollovers


def test_group_totals_past_u32_saturate_identically():
    je, te = _engines()
    n = 12
    raw = dict(
        slots=np.array([3] * 6 + [9] * 6, dtype=np.int32),
        hits=np.full(n, 0x7FFFFFFF, dtype=np.uint32),
        limits=np.full(n, 1000, dtype=np.uint32),
        fresh=np.zeros(n, dtype=bool),
        shadow=np.zeros(n, dtype=bool),
    )
    for _ in range(2):
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)))
    counts = te.export_counts()
    assert counts[3] == counts[9] == 0xFFFFFFFF
    np.testing.assert_array_equal(counts, je.export_counts())


def _lanes(rng, n, keys, max_limit):
    return [
        (
            f"dom_k_{int(rng.integers(0, keys))}_{100 + int(rng.integers(0, 2))}",
            int(rng.integers(1, max_limit)),
            bool(rng.random() < 0.2),
            int(rng.integers(1, 4)),
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("native_table", [None, False])
def test_submit_packed_blobs_match_jax(native_table):
    """The serving entry: the same LANE_DTYPE packs (built from the
    same lanes by each package's LanePack) through both engines, with
    slot assignment, expiry and fresh-slot reuse across windows."""
    je, te = _engines(num_slots=64, native_table=native_table)
    rng = np.random.default_rng(3)
    for step, n in enumerate((4, 30, 100, 7, 64)):  # 100 > max_batch
        now = 1000 + 30 * step
        spec = _lanes(rng, n, keys=40, max_limit=20)
        jpack = JaxLanePack.from_lanes(
            [JaxLane(k, now + 60, lim, sh, h) for k, lim, sh, h in spec]
        )
        tpack = LanePack.from_lanes(
            [Lane(k, now + 60, lim, sh, h) for k, lim, sh, h in spec]
        )
        assert tpack.key_blob == jpack.key_blob
        assert tpack.meta.tobytes() == jpack.meta.tobytes()
        dj = je.step_complete(je.submit_packed(now, jpack.key_blob, jpack.meta))
        dt = te.step_complete(te.submit_packed(now, tpack.key_blob, tpack.meta))
        _assert_same(dj, dt)
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
        assert te.stat_live_keys == je.stat_live_keys
        assert te.stat_dedup_groups == je.stat_dedup_groups


def test_pipelined_submissions_keep_separate_staging():
    """Two submissions in flight before either completes (the
    dispatcher's launch-N+1-during-readback-N) each read back their
    own afters."""
    je, te = _engines()
    rng = np.random.default_rng(21)
    raws = [_host_batch(rng, 20, 256, 50, 4) for _ in range(3)]
    tokens = [te.step_submit(HostBatch(**r)) for r in raws]
    outs = [te.step_complete(t) for t in tokens]
    for raw, dt in zip(raws, outs):
        _assert_same(je.step(JaxHostBatch(**raw)), dt)


def test_checkpoints_cross_between_packages():
    je, te = _engines()
    rng = np.random.default_rng(8)
    raw = _host_batch(rng, 32, 256, 100, 5)
    je.step(JaxHostBatch(**raw))
    te.import_state(je.export_state())
    np.testing.assert_array_equal(te.export_counts(), je.export_counts())
    # ...and back: advance the port, import into a fresh JAX engine.
    raw2 = _host_batch(rng, 32, 256, 100, 5)
    te.step(HostBatch(**raw2))
    je2 = JaxEngine(num_slots=256, buckets=BUCKETS)
    je2.import_state(te.export_state())
    je.step(JaxHostBatch(**raw2))
    np.testing.assert_array_equal(je2.export_counts(), je.export_counts())
    with pytest.raises(ValueError):
        te.import_counts(np.zeros(10, dtype=np.uint32))
    with pytest.raises(ValueError):
        te.import_state({"counts": je.export_counts(), "prev": je.export_counts()})


def _generic_engines(name, num_slots=256):
    return (
        JaxEngine(buckets=BUCKETS, model=jax_algorithm(name).make_model(num_slots, 0.8)),
        CounterEngine(
            buckets=BUCKETS,
            device="cpu",
            model=get_algorithm(name).make_model(num_slots, 0.8, device="cpu"),
        ),
    )


@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_generic_engine_matches_jax(name):
    """Duplicate-laden HostBatch streams (wider than max_batch, with
    fresh slots, shadow lanes, mixed dividers and a clock that crosses
    windows) through both generic engines: every decision field and
    the exported state rows are equal."""
    je, te = _generic_engines(name)
    assert te.slot_table.refresh_expiry
    rng = np.random.default_rng(17)
    now = 1_700_000_000
    for n in (5, 40, 80, 1, 33, 64, 12, 70):  # 80 > max_batch
        raw = _host_batch(rng, n, 160, 20, 4)
        if name == "gcra":
            # Emission intervals divider/limit exact in f32: the jitted
            # JAX step may fuse v + adm * T into an FMA, which moves a
            # TAT by one ulp only where T is inexact.
            raw["limits"] = rng.choice([1, 2, 3, 4, 5, 6, 10, 12, 15, 20], n)
            raw["limits"] = raw["limits"].astype(np.uint32)
            raw["dividers"] = rng.choice([60, 3600], n).astype(np.uint32)
        else:
            raw["dividers"] = rng.choice([1, 60, 3600], n).astype(np.uint32)
        _assert_same(je.step(JaxHostBatch(**raw), now), te.step(HostBatch(**raw), now))
        for row, arr in je.export_state().items():
            np.testing.assert_array_equal(te.export_state()[row], arr, err_msg=row)
        now += int(rng.integers(0, 50))
    assert te.stat_window_rollovers == je.stat_window_rollovers
    assert not te.step(HostBatch(**raw), now).set_local_cache.any()


@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_generic_submit_packed_matches_jax(name):
    """The serving entry of an algorithm bank: stable-stem keys with a
    two-window lease and the rule's divider in each LANE_DTYPE record."""
    je, te = _generic_engines(name, num_slots=64)
    rng = np.random.default_rng(5)
    for step, n in enumerate((4, 30, 100, 7, 64)):
        now = 1_700_000_000 + 25 * step
        lanes = [
            (f"dom_k_{int(rng.integers(0, 20))}", int(rng.integers(1, 12)),
             bool(rng.random() < 0.2), int(rng.integers(1, 3)))
            for _ in range(n)
        ]
        packs = []
        for pack_cls, lane_cls in ((JaxLanePack, JaxLane), (LanePack, Lane)):
            pack = pack_cls.from_lanes(
                [lane_cls(k, now + 120, lim, sh, h) for k, lim, sh, h in lanes]
            )
            pack.meta["divider"] = 60
            pack.meta["algo"] = get_algorithm(name).algo_id
            packs.append(pack)
        dj = je.step_complete(je.submit_packed(now, packs[0].key_blob, packs[0].meta))
        dt = te.step_complete(te.submit_packed(now, packs[1].key_blob, packs[1].meta))
        _assert_same(dj, dt)
        for row, arr in je.export_state().items():
            np.testing.assert_array_equal(te.export_state()[row], arr, err_msg=row)
        assert te.stat_live_keys == je.stat_live_keys


def test_engine_without_device_needs_cuda():
    """Entry points default to the GPU and never fall back silently."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CounterEngine(num_slots=64)
