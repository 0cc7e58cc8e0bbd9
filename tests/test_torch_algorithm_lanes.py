"""The algorithm kernels' by-value form (K4 sliding window, K5 GCRA) and
the algorithm engines' choice of form, on the CPU.

A served algorithm chunk of at most 128 padded lanes goes to K4 / K5 by
value: the host words ride in the launch and the kernel writes the
readback into pinned host memory, so the engine makes no upload and no
readback copy.  The batch's shape alone picks the form
(``lanes_by_value``).  On the CPU the by-value wrappers run the same
plain versions as the device form, into the caller's `out`.  Inputs come
from a numpy seed, at 2^12 to 2^18 slots:

- each by-value wrapper against its device-form wrapper and the JAX
  package's step over several clock steps, N in {1, 8, 13, 64, 128},
  with ids in [-ns, -1], out-of-table pads, fresh lanes, saturated
  counts, limit 0 and limits near 2^32.  K4 is exact against the jitted
  JAX step; K5 exact against the numpy ``reference_step`` and within
  one cell of the jitted JAX step (XLA may fuse a multiply and an add);
- what the wrappers refuse: words or readback off the host, 129 lanes,
  a 4-row batch;
- both algorithm engines against the JAX engine with the same model,
  every chunk of at most 128 padded lanes through the by-value wrapper
  and a 256-lane chunk through the mapped form (never the device form),
  and two submissions in flight completed out of order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu_torch.backends.engine import CounterEngine, HostBatch
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models import gcra
from ratelimit_tpu_torch.models import sliding_window as sw
from ratelimit_tpu_torch.models.fixed_window import state_from_numpy, state_to_numpy
from ratelimit_tpu_torch.models.registry import get_algorithm

U32 = 0xFFFFFFFF
NOW = 1_699_999_200  # aligned to every divider (1, 60, 3600 s)
STEPS = (0, 30, 45, 70, 4000)  # same, adjacent and older windows
WIDTHS = [(1, 1 << 12), (8, 1 << 12), (13, 1 << 16), (64, 1 << 12), (128, 1 << 18)]
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


def _start(rng, algo, ns, pool):
    """A table that is zero but for the `pool` slots: sliding-window
    windows current, adjacent or older, some counts saturated; GCRA
    TATs around the clock."""
    k = len(pool)
    if algo == "sw":
        state = np.zeros((3, ns), np.uint32)
        state[0, pool] = NOW - rng.choice([0, 60, 3600, 7200, 120], k)
        state[1, pool] = rng.integers(0, 60, k)
        state[2, pool] = rng.integers(0, 60, k)
        state[1, pool[rng.random(k) < 0.15]] = U32
        state[2, pool[rng.random(k) < 0.15]] = U32
    else:
        state = np.zeros((2, ns), np.uint32)
        state[0, pool] = NOW + rng.integers(-200, 200, k)
        state[1, pool] = rng.integers(0, 1 << 32, k, dtype=np.uint64)
    return state


def _words(rng, n, ns, pool):
    """int32[5, n] as the engine builds it: unique slots from `pool`
    (about a third as their alias id - ns), fresh lanes, saturating
    hits, limit 0 and limits near 2^32, then distinct out-of-table pads
    (hits 0, limit 1, divider 1).  Returns (words, live lane count)."""
    pad = n // 4
    g = n - pad
    slots = rng.choice(pool, g, replace=False).astype(np.int64)
    slots[rng.random(g) < 0.35] -= ns
    hits = rng.integers(1, 40, g).astype(np.uint32)
    hits[: max(1, g // 8)] = U32 - rng.integers(0, 3, max(1, g // 8)).astype(np.uint32)
    limits = rng.integers(1, 200, g).astype(np.uint32)
    limits[rng.random(g) < 0.15] = 0
    near = rng.random(g) < 0.15
    limits[near] = U32 - rng.integers(0, 1 << 20, int(near.sum())).astype(np.uint32)
    fresh = rng.random(g) < 0.2
    divider = rng.choice([1, 60, 3600], g).astype(np.uint32)
    words = np.empty((5, n), np.int32)
    words[0] = np.concatenate([slots, ns + np.arange(pad)])
    words[1] = np.concatenate([hits, np.zeros(pad, np.uint32)]).view(np.int32)
    words[2] = np.concatenate([limits, np.ones(pad, np.uint32)]).view(np.int32)
    words[3] = np.concatenate([fresh, np.zeros(pad, bool)])
    words[4] = np.concatenate([divider, np.ones(pad, np.uint32)]).view(np.int32)
    return words, g


# -- the by-value wrappers --------------------------------------------------


@pytest.mark.parametrize("n,ns", WIDTHS)
def test_sw_lanes_equals_device_form_and_jax_step(n, ns):
    rng = np.random.default_rng(n)
    pool = rng.choice(ns, 2 * n, replace=False)
    start = _start(rng, "sw", ns, pool)
    jmodel = jax_algorithm("sliding_window").make_model(ns, 0.8)
    jstate = jnp.asarray(start)
    lanes, device = state_from_numpy(start, "cpu"), state_from_numpy(start, "cpu")
    for dt in STEPS:
        words, _ = _words(rng, n, ns, pool)
        out = torch.full((2, n), 7, dtype=torch.int32)
        assert sw.sw_serve_step_lanes(lanes, torch.from_numpy(words), NOW + dt, out) is out
        want = sw.sw_serve_step(device, torch.from_numpy(words.copy()), NOW + dt)
        jstate, jout = jmodel.step_serve_packed(
            jstate, jnp.asarray(words), jnp.asarray(NOW + dt, jnp.int32)
        )
        assert torch.equal(out, want)
        assert torch.equal(lanes, device)
        np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(jout))
        np.testing.assert_array_equal(state_to_numpy(lanes), np.asarray(jstate))
    assert (state_to_numpy(lanes)[1:] == U32).any()


@pytest.mark.parametrize("n,ns", WIDTHS)
def test_gcra_lanes_equals_device_form_and_reference(n, ns):
    """Exact against the device form and the numpy reference_step; the
    jitted JAX step, run from the same state each step, within one cell
    (tests/test_torch_algorithms.py's tolerance; one f32 ulp for budgets
    past 2^24), >= 90 % of budgets exact, and TAT seconds within 1 s
    (plus one emission interval where the budgets differ)."""
    rng = np.random.default_rng(100 + n)
    pool = rng.choice(ns, 2 * n, replace=False)
    ref = _start(rng, "gcra", ns, pool)
    jmodel = jax_algorithm("gcra").make_model(ns, 0.8)
    lanes, device = state_from_numpy(ref, "cpu"), state_from_numpy(ref, "cpu")
    exact = total = 0
    for dt in STEPS:
        words, g = _words(rng, n, ns, pool)
        before = ref.copy()
        out = torch.full((n,), 7, dtype=torch.int32)
        gcra.gcra_serve_step_lanes(lanes, torch.from_numpy(words), NOW + dt, out)
        want = gcra.gcra_serve_step(device, torch.from_numpy(words.copy()), NOW + dt)
        assert torch.equal(out, want)
        assert torch.equal(lanes, device)
        w = words[:, :g]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            budgets = jmodel.reference_step(
                ref, w[0], w[1].view(np.uint32), w[2].view(np.uint32), w[3] != 0,
                w[4].view(np.uint32), NOW + dt,
            )
        np.testing.assert_array_equal(out.numpy()[:g], budgets)
        np.testing.assert_array_equal(state_to_numpy(lanes), ref)
        jstate, jout = jmodel.step_serve_packed(
            jnp.asarray(before), jnp.asarray(words), jnp.asarray(NOW + dt, jnp.int32)
        )
        b_jax = np.asarray(jout)[:g].astype(np.int64)
        b_port = out.numpy()[:g].astype(np.int64)
        # One cell, or one f32 ulp where the budget is past 2^24 cells
        # (limits near 2^32): the budget is an f32, exact only to 2^24.
        ulp = np.spacing(b_port.astype(np.float32)).astype(np.int64)
        assert (np.abs(b_jax - b_port) <= np.maximum(ulp, 1)).all()
        exact += int((b_jax == b_port).sum())
        total += g
        # TAT seconds within 1 s; a lane whose budget differs admits one
        # cell more or less, and its TAT moves by one emission interval.
        tol = np.ones(ns, np.int64)
        with np.errstate(divide="ignore"):
            interval = np.ceil(w[4].view(np.uint32) / w[2].view(np.uint32).astype(np.float64))
        moved = b_jax != b_port
        tol[w[0][moved] % ns] += interval[moved].astype(np.int64)
        sec_delta = (np.asarray(jstate)[0] - ref[0]).view(np.int32)
        assert (np.abs(sec_delta) <= tol).all()
    assert exact >= total * 0.9, (exact, total)


LANE_STEPS = [
    (sw.sw_serve_step_lanes, 3, (2,)),
    (gcra.gcra_serve_step_lanes, 2, ()),
]


@pytest.mark.parametrize("step,rows,out_rows", LANE_STEPS, ids=["K4", "K5"])
def test_lanes_wrappers_refuse_what_the_kernel_does_not_take(step, rows, out_rows):
    state = torch.zeros((rows, 64), dtype=torch.int32)
    words = torch.zeros((5, 8), dtype=torch.int32)
    out = torch.zeros((*out_rows, 8), dtype=torch.int32)
    # The launcher reads the words on the host: words on a device are refused.
    with pytest.raises(ValueError, match="words must be a contiguous host tensor"):
        step(state, torch.zeros((5, 8), dtype=torch.int32, device="meta"), 0, out)
    # The kernel writes the readback into host memory through its alias.
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        step(state, words, 0, torch.zeros((*out_rows, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="129 lanes exceed the 128 .* device form"):
        step(state, torch.zeros((5, 129), dtype=torch.int32), 0,
             torch.zeros((*out_rows, 129), dtype=torch.int32))
    with pytest.raises(TypeError, match=r"words must be int32\[\.\.\., 5, N\]"):
        step(state, torch.zeros((4, 8), dtype=torch.int32), 0, out)
    with pytest.raises(TypeError, match=r"words must be int32\[5, N\]"):
        step(state, torch.zeros((2, 5, 8), dtype=torch.int32), 0, out)
    with pytest.raises(TypeError, match="out must be"):
        step(state, words, 0, torch.zeros((*out_rows, 9), dtype=torch.int32))
    with pytest.raises(TypeError, match="state must be int32"):
        step(torch.zeros((rows + 1, 64), dtype=torch.int32), words, 0, out)
    # No fallback: a table on a device without a kernel is refused.
    with pytest.raises(ValueError, match="unsupported device"):
        step(torch.zeros((rows, 64), dtype=torch.int32, device="meta"), words, 0, out)


# -- the engines --------------------------------------------------------------


def _engines(name, ns, buckets=(8, 16, 32, 64, 128, 256)):
    return (
        JaxEngine(buckets=buckets, model=jax_algorithm(name).make_model(ns, 0.8)),
        CounterEngine(
            buckets=buckets, device="cpu", model=get_algorithm(name).make_model(ns, 0.8, "cpu")
        ),
    )


def _spy_forms(monkeypatch, name):
    """Count the chunks each wrapper of the model's kernel served."""
    mod, lanes, mapped, device = {
        "sliding_window": (sw, "sw_serve_step_lanes", "sw_serve_step_mapped", "sw_serve_step"),
        "gcra": (gcra, "gcra_serve_step_lanes", "gcra_serve_step_mapped", "gcra_serve_step"),
    }[name]
    forms = {"lanes": [], "mapped": [], "device": []}
    for form, attr in (("lanes", lanes), ("mapped", mapped), ("device", device)):
        orig = getattr(mod, attr)

        def spy(state, batch, *rest, _orig=orig, _form=form):
            forms[_form].append(batch.shape[1])
            return _orig(state, batch, *rest)

        monkeypatch.setattr(mod, attr, spy)
    return forms


def _batch(rng, n, ns, name):
    """n lanes over n // 2 + 1 keys (duplicates), fresh first sightings,
    dividers of 60 and 3600 s.  GCRA limits keep divider / limit exact
    in f32, where the jitted JAX step equals the port (an inexact one may
    move a TAT by one ulp, tests/test_torch_engine.py)."""
    slots = rng.choice(ns, n // 2 + 1, replace=False)[rng.integers(0, n // 2 + 1, n)]
    fresh = np.zeros(n, bool)
    fresh[np.unique(slots, return_index=True)[1][rng.random(len(np.unique(slots))) < 0.3]] = True
    limits = rng.choice([1, 2, 3, 4, 5, 6, 10, 12, 15, 20], n).astype(np.uint32)
    return dict(
        slots=slots.astype(np.int32),
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=limits,
        fresh=fresh,
        shadow=rng.random(n) < 0.2,
        dividers=rng.choice([60, 3600], n).astype(np.uint32),
    )


def _assert_same(dj, dt, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(dt, f)).astype(np.int64),
            np.asarray(getattr(dj, f)).astype(np.int64),
            err_msg=f"{what} {f}",
        )


@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_engine_serves_by_value_like_jax(monkeypatch, name):
    """Chunks of 1-128 padded lanes go to the by-value wrapper, a chunk of
    200 distinct slots (256 padded) to the mapped form and none to the
    device form; every decision field and state row equals the JAX
    engine's."""
    forms = _spy_forms(monkeypatch, name)
    je, te = _engines(name, 1024)
    rng = np.random.default_rng(23)
    now = NOW
    padded = []  # each chunk's bucket of distinct slots
    for n in (1, 5, 13, 30, 100, 250, 7):
        raw = _batch(rng, n, 1024, name)
        if n == 250:  # 200 distinct slots: one chunk of 256 padded lanes
            raw["slots"] = rng.choice(1024, 200, replace=False)[np.arange(n) % 200]
            raw["slots"] = raw["slots"].astype(np.int32)
        padded.append(te._bucket(len(np.unique(raw["slots"]))))
        _assert_same(je.step(JaxHostBatch(**raw), now), te.step(HostBatch(**raw), now), f"n={n}")
        for row, arr in je.export_state().items():
            np.testing.assert_array_equal(te.export_state()[row], arr, err_msg=row)
        now += int(rng.integers(0, 50))
    assert forms["lanes"] == [p for p in padded if p <= fw.MAX_LANES]
    assert forms["mapped"] == [256]
    assert forms["device"] == []


@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_generic_in_flight_submits_complete_out_of_order(name):
    """Two submissions in flight, completed newest first: each reads its
    own readback (the by-value form writes it into the staging buffer of
    its submission), and both staging objects return to the free list."""
    je, te = _engines(name, 256)
    rng = np.random.default_rng(41)
    raws = [_batch(rng, 20, 256, name) for _ in range(2)]
    tokens = [te.step_submit(HostBatch(**r), NOW + 10 * i) for i, r in enumerate(raws)]
    st_a, st_b = tokens[0][3][0][0][0], tokens[1][3][0][0][0]
    assert st_a is not st_b
    out_b = te.step_complete(tokens[1])
    out_a = te.step_complete(tokens[0])
    _assert_same(je.step(JaxHostBatch(**raws[0]), NOW), out_a, "first")
    _assert_same(je.step(JaxHostBatch(**raws[1]), NOW + 10), out_b, "second")
    assert {id(s) for s in te._free_staging} == {id(st_a), id(st_b)}


class _WithoutLanes:
    """The generic protocol (lane_counts) without its by-value step."""

    lane_counts = sw.SlidingWindowModel.lane_counts
    step_serve_mapped = sw.SlidingWindowModel.step_serve_mapped
    readback_shape = sw.SlidingWindowModel.readback_shape


class _WithoutMapped:
    """The generic protocol with the device-tensor and by-value steps but
    not the mapped one."""

    lane_counts = sw.SlidingWindowModel.lane_counts
    step_serve_packed = sw.SlidingWindowModel.step_serve_packed
    step_serve_lanes = sw.SlidingWindowModel.step_serve_lanes
    readback_shape = sw.SlidingWindowModel.readback_shape


def test_generic_model_needs_both_forms():
    """A generic model without the by-value or the mapped step is refused
    up front, not at its first chunk of that width."""
    with pytest.raises(TypeError, match="step_serve_lanes"):
        CounterEngine(device="cpu", model=_WithoutLanes())
    with pytest.raises(TypeError, match="step_serve_mapped"):
        CounterEngine(device="cpu", model=_WithoutMapped())
