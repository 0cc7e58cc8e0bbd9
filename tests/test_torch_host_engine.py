"""The port's host mirror (ratelimit_tpu_torch/backends/host_engine.py)
against the JAX package's, on the CPU.

The same seeded packs go through ratelimit_tpu's HostEngine and the
port's, for fixed window, sliding window and GCRA: every decision
field, the befores/afters, the state table and the slot table after
each step must be equal (tolerance 0: both are numpy in the same
order).  The same packs then go through the port's HostEngine and its
CounterEngine(device="cpu"), whose kernels' plain versions stand in
for K1, K4 and K5.  The mirror must reach no torch op at all.
"""

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from ratelimit_tpu.backends.dispatcher import LANE_DTYPE as JAX_LANE_DTYPE
from ratelimit_tpu.backends.host_engine import HostEngine as JaxHostEngine
from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.host_engine import (
    STATIC_ALLOW,
    STATIC_DENY,
    HostEngine,
    StaticFallbackEngine,
    host_fixed_window_step,
)
from ratelimit_tpu_torch.models import fixed_window, gcra, sliding_window
from ratelimit_tpu_torch.models.registry import get_algorithm

ALGOS = ("fixed_window", "sliding_window", "gcra")
DECISION_FIELDS = (
    "codes",
    "limit_remaining",
    "over_limit",
    "near_limit",
    "within_limit",
    "shadow_mode",
    "set_local_cache",
)
ALL_FIELDS = DECISION_FIELDS + ("befores", "afters")
NUM_SLOTS = 128
NOW0 = 1_700_000_040
#: GCRA limits whose emission interval is f32-exact at divider 60, and
#: two near 2^32 (the emission interval underflows toward 0 and the
#: budget clamps).
GCRA_LIMITS = (2, 3, 4, 5, 6, 10, 12, 15, 20, 30, 60, 0xFFFFFF00, 0xFFFFFFFF)


def _pack(rows, now):
    """rows: [(key, hits, limit, shadow, divider, algo_id)] -> (blob, meta)
    with the lane expiry one window past `now`."""
    enc = [k.encode() for k, *_ in rows]
    meta = np.zeros(len(rows), LANE_DTYPE)
    for j, ((_k, hits, limit, shadow, divider, algo), b) in enumerate(zip(rows, enc)):
        expiry = now - now % 60 + 60
        meta[j] = (expiry, hits, limit, len(b), shadow, divider, algo)
    return b"".join(enc), meta


def _seeded_rows(rng, algo, n=30, keys=12):
    spec = get_algorithm(algo)
    generic = algo != "fixed_window"
    rows = []
    for _ in range(n):
        if generic:
            limit = int(GCRA_LIMITS[rng.integers(0, len(GCRA_LIMITS))]) if algo == "gcra" else int(
                rng.integers(1, 40)
            )
        else:
            # Limits and hits near u32 max drive the saturating add.
            limit = int(rng.choice([rng.integers(1, 25), 0xFFFFFFFF - rng.integers(0, 4)]))
        hits = int(rng.choice([rng.integers(1, 4), 0x7FFFFFFF])) if not generic else int(
            rng.integers(1, 3)
        )
        shadow = int(rng.integers(0, 2)) if not generic else 0
        rows.append(
            (f"k{rng.integers(0, keys)}", hits, limit, shadow, 60 if generic else 0, spec.algo_id)
        )
    return rows


def _run(engine, now, blob, meta):
    return engine.step_complete(engine.submit_packed(now, blob, meta.copy()))


def _assert_fields(a, b, fields, what):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f"{what} {f}"
        )


def _per_key_state(engine):
    """{key: tuple of state rows at its slot} (layout-free comparison)."""
    state = engine.export_state()
    return {
        k: tuple(int(np.asarray(state[name]).reshape(-1)[s]) for name in sorted(state))
        for k, s, _e in engine.slot_table.entries()
    }


def _clock_steps(algo):
    # Same window, the next window, two windows on, and later.
    return [NOW0 + d for d in (0, 13, 31, 65, 130, 200, 201, 400)]


@pytest.mark.parametrize("algo", ALGOS)
def test_host_engine_equals_jax_host_engine(algo):
    rng = np.random.default_rng(20260417)
    jax_host = JaxHostEngine(num_slots=NUM_SLOTS, algorithm=algo)
    host = HostEngine(num_slots=NUM_SLOTS, algorithm=algo)
    assert JAX_LANE_DTYPE == LANE_DTYPE
    for step, now in enumerate(_clock_steps(algo)):
        blob, meta = _pack(_seeded_rows(rng, algo), now)
        dj = _run(jax_host, now, blob, meta)
        dt = _run(host, now, blob, meta)
        _assert_fields(dj, dt, ALL_FIELDS, f"{algo} step {step}")
        np.testing.assert_array_equal(host.state, jax_host.state, err_msg=f"step {step}")
        assert host.slot_table.entries() == jax_host.slot_table.entries()
    assert host.stat_decisions == jax_host.stat_decisions
    assert host.stat_window_rollovers == jax_host.stat_window_rollovers


@pytest.mark.parametrize("algo", ALGOS)
def test_host_engine_equals_counter_engine(algo):
    """The mirror against the port's engine on the CPU, whose kernels
    run their plain versions: all fields for the generic kernels, the
    decision fields for fixed window (its narrow readback may clamp raw
    befores, which no decision reads), and the per-key state."""
    rng = np.random.default_rng(7 + ALGOS.index(algo))
    spec = get_algorithm(algo)
    dev = CounterEngine(
        num_slots=NUM_SLOTS,
        buckets=(32,),
        device="cpu",
        model=spec.make_model(NUM_SLOTS, 0.8, device="cpu"),
    )
    host = HostEngine(num_slots=NUM_SLOTS, algorithm=algo)
    fields = DECISION_FIELDS if algo == "fixed_window" else ALL_FIELDS
    for step, now in enumerate(_clock_steps(algo)):
        blob, meta = _pack(_seeded_rows(rng, algo), now)
        _assert_fields(_run(dev, now, blob, meta), _run(host, now, blob, meta), fields, step)
        assert _per_key_state(host) == _per_key_state(dev), step


def test_gcra_limit_near_u32_max():
    """Limits near 2^32: the emission interval underflows toward 0,
    the budget clamps to 2^31 - 128; mirror, JAX mirror and the port's
    engine agree lane for lane."""
    spec = get_algorithm("gcra")
    rows = [("big", 1, 0xFFFFFFFF, 0, 60, spec.algo_id)] * 5 + [
        ("near", 7, 0xFFFFFF00, 0, 60, spec.algo_id),
        ("zero", 1, 0, 0, 60, spec.algo_id),
    ]
    engines = (
        JaxHostEngine(num_slots=16, algorithm="gcra"),
        HostEngine(num_slots=16, algorithm="gcra"),
        CounterEngine(
            num_slots=16, buckets=(8,), device="cpu", model=spec.make_model(16, 0.8, device="cpu")
        ),
    )
    for now in (NOW0, NOW0 + 1, NOW0 + 59):
        blob, meta = _pack(rows, now)
        out = [_run(e, now, blob, meta) for e in engines]
        for d in out[1:]:
            _assert_fields(out[0], d, ALL_FIELDS, now)
        assert list(out[0].codes[:6]) == [1] * 6  # OK
        assert out[0].codes[6] == 2  # limit 0: OVER_LIMIT
    np.testing.assert_array_equal(engines[0].state, engines[1].state)


def test_host_fixed_window_step_saturates():
    counts = np.array([0, 0xFFFFFFF0, 5, 9], np.uint32)
    after = host_fixed_window_step(
        counts,
        np.array([1, 2, 3]),
        np.array([0x20, 0xFFFFFFFF, 1], np.uint32),
        np.array([False, False, True]),
    )
    assert after.tolist() == [0xFFFFFFFF, 0xFFFFFFFF, 1]
    assert counts.tolist() == [0, 0xFFFFFFFF, 0xFFFFFFFF, 1]


class _NoTorchOps(TorchDispatchMode):
    """Fails on any torch operator dispatched while it is active."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the host mirror ran torch op {func}")


def test_host_mirror_runs_no_torch_op(monkeypatch):
    """Serving, snapshot seeding and the key handoff of the mirror run
    numpy only: no torch operator is dispatched and no plain kernel
    version is called."""

    def refuse(*_a, **_k):
        raise AssertionError("the host mirror called a plain kernel version")

    monkeypatch.setattr(fixed_window, "_unique_step_plain", refuse)
    monkeypatch.setattr(fixed_window, "_update_plain", refuse)
    monkeypatch.setattr(sliding_window, "_sw_step_plain", refuse)
    monkeypatch.setattr(gcra, "_gcra_step_plain", refuse)
    rng = np.random.default_rng(3)
    with _NoTorchOps():
        for algo in ALGOS:
            src = HostEngine(num_slots=64, algorithm=algo)
            for now in _clock_steps(algo)[:3]:
                blob, meta = _pack(_seeded_rows(rng, algo, keys=6), now)
                _run(src, now, blob, meta)
            mirror = HostEngine(num_slots=64, algorithm=algo)
            mirror.import_snapshot(src.export_state(), src.slot_table.entries())
            state, entries = mirror.export_keys(lambda _k: True, drop=True)
            HostEngine(num_slots=64, algorithm=algo).import_keys(state, entries, NOW0)
            blob, meta = _pack([("x", 1, 5, 1, 0, 0)], NOW0)
            for static in (STATIC_ALLOW, STATIC_DENY):
                _run(static, NOW0, blob, meta)


def test_mirror_counters_import_into_device_engine():
    """The warm-restart merge: counts accumulated on the mirror keep
    limiting after export_keys -> the engine's import_keys."""
    host = HostEngine(num_slots=64)
    blob, meta = _pack([("hot", 1, 10, 0, 0, 0)] * 7, 1000)
    _run(host, 1000, blob, meta)  # 7 hits on "hot"
    state, entries = host.export_keys(lambda _k: True, drop=True)
    assert len(entries) == 1 and len(host.slot_table) == 0
    dev = CounterEngine(num_slots=64, buckets=(8,), device="cpu")
    assert dev.import_keys(state, entries, now=1000) == {
        "imported": 1,
        "merged": 0,
        "dropped": 0,
    }
    blob, meta = _pack([("hot", 1, 10, 0, 0, 0)] * 4, 1000)
    assert list(_run(dev, 1000, blob, meta).codes) == [1, 1, 1, 2]


@pytest.mark.parametrize("algo", ALGOS)
def test_import_snapshot_seeds_mirror(algo):
    """A mirror seeded from a bank's snapshot answers as the bank would
    have, and as the JAX mirror seeded from the same snapshot."""
    rng = np.random.default_rng(11)
    spec = get_algorithm(algo)
    dev = CounterEngine(
        num_slots=64, buckets=(32,), device="cpu", model=spec.make_model(64, 0.8, device="cpu")
    )
    steps = _clock_steps(algo)
    for now in steps[:3]:
        blob, meta = _pack(_seeded_rows(rng, algo, keys=8), now)
        _run(dev, now, blob, meta)
    snap = (dev.export_state(), dev.slot_table.entries())
    mirror = HostEngine(num_slots=64, algorithm=algo)
    jax_mirror = JaxHostEngine(num_slots=64, algorithm=algo)
    assert mirror.import_snapshot(*snap) == jax_mirror.import_snapshot(*snap) == len(snap[1])
    for now in steps[3:5]:
        blob, meta = _pack(_seeded_rows(rng, algo, keys=8), now)
        dd = _run(dev, now, blob, meta)
        dm = _run(mirror, now, blob, meta)
        _assert_fields(dd, dm, DECISION_FIELDS, now)
        _assert_fields(_run(jax_mirror, now, blob, meta), dm, ALL_FIELDS, now)


def test_snapshot_num_slots_mismatch_refused():
    src = HostEngine(num_slots=64)
    mirror = HostEngine(num_slots=32)
    with pytest.raises(ValueError, match="num_slots"):
        mirror.import_snapshot(src.export_state(), [])


def test_static_allow_answers_ok_with_zero_stats():
    blob, meta = _pack([("x", 1, 42, 0, 0, 0), ("y", 3, 7, 1, 0, 0)], NOW0)
    d = _run(STATIC_ALLOW, 0, blob, meta)
    assert list(d.codes) == [1, 1]
    assert list(d.limit_remaining) == [42, 7]
    for f in ("over_limit", "near_limit", "within_limit", "shadow_mode", "set_local_cache"):
        assert not np.asarray(getattr(d, f)).any(), f


def test_static_deny_answers_over_limit_except_shadow():
    blob, meta = _pack([("x", 1, 42, 0, 0, 0), ("y", 1, 7, 1, 0, 0)], NOW0)
    d = _run(STATIC_DENY, 0, blob, meta)
    # Shadow rules never enforce, even under a fail-closed deny.
    assert list(d.codes) == [2, 1]
    assert list(d.limit_remaining) == [0, 0]
    for f in ("over_limit", "near_limit", "within_limit", "shadow_mode"):
        assert not np.asarray(getattr(d, f)).any(), f


def test_static_engines_are_stateless():
    eng = StaticFallbackEngine(allow=False)
    blob, meta = _pack([("x", 1, 5, 0, 0, 0)], NOW0)
    for _ in range(3):
        assert list(_run(eng, 0, blob, meta).codes) == [2]
    assert eng.stat_decisions == 3
