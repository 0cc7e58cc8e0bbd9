"""The port's algorithm banks (sliding window, GCRA) against the JAX
package, on the CPU.

The same seeded numpy inputs go through ratelimit_tpu and
ratelimit_tpu_torch (device="cpu": the kernels' plain versions):

- sliding window: the plain version of K4 equals the jitted JAX step,
  state and readback, over 20 random steps with saturated counters and
  negative slot ids -- including the saturated-prev case where JAX's
  saturating f32->u32 conversion and the numpy oracle part;
- GCRA: the plain version of K5 equals the numpy ``reference_step`` bit
  for bit, and the jitted JAX step within one cell, >= 90 % of budgets
  exact, TAT seconds within 1 s (the JAX package's own tolerances: XLA
  may fuse a multiply and an add);
- the cache scenarios of tests/test_algorithms.py (edge burst, GCRA
  steady rate, sliding decay, shadow enforcement and tallies, the
  missing-bank fold-back, refresh-on-touch slots, state crossing the
  packages), each run through both services with equal transcripts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimit_tpu.api import Descriptor as JaxDescriptor
from ratelimit_tpu.api import RateLimitRequest as JaxRequest
from ratelimit_tpu.backends import CounterEngine as JaxEngine
from ratelimit_tpu.backends import TpuRateLimitCache
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu.service import RateLimitService as JaxService
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.api import Code, Descriptor, RateLimitRequest
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.models.fixed_window import state_from_numpy, state_to_numpy
from ratelimit_tpu_torch.models.gcra import GcraModel, gcra_serve_step
from ratelimit_tpu_torch.models.registry import get_algorithm
from ratelimit_tpu_torch.models.sliding_window import (
    SlidingWindowModel,
    sw_serve_step,
)
from ratelimit_tpu_torch.service import RateLimitService
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

OK, OVER = int(Code.OK), int(Code.OVER_LIMIT)
U32 = 0xFFFFFFFF

# -- kernels' plain versions against the JAX steps ----------------------


def _packed(slots, hits, limits, fresh, divider, padded, ns):
    """int32[5, padded] as the engine builds it: distinct out-of-table
    pads with hits 0, limit 1, divider 1."""
    g = len(slots)
    pk = np.empty((5, padded), np.int32)
    pk[0, :g] = slots
    pk[0, g:] = ns + np.arange(padded - g)
    pk[1, :g] = np.asarray(hits, np.uint32).view(np.int32)
    pk[1, g:] = 0
    pk[2, :g] = np.asarray(limits, np.uint32).view(np.int32)
    pk[2, g:] = 1
    pk[3, :g] = np.asarray(fresh, np.int32)
    pk[3, g:] = 0
    pk[4, :g] = np.asarray(divider, np.uint32).view(np.int32)
    pk[4, g:] = 1
    return pk


def _lanes(rng, ns, seen, neg=False):
    """One step's unique slots (some as their negative alias) and lanes."""
    g = int(rng.integers(1, 9))
    table = rng.choice(ns, size=g, replace=False)
    slots = table.astype(np.int32)
    if neg:
        flip = rng.random(g) < 0.4
        slots[flip] -= ns  # id - ns addresses the same slot
    fresh = np.array([int(s) not in seen for s in table], bool)
    seen.update(int(s) for s in table)
    hits = rng.integers(1, 5, g).astype(np.uint32)
    limits = rng.integers(1, 30, g).astype(np.uint32)
    return slots, hits, limits, fresh


def test_sliding_window_plain_matches_jax_step():
    ns = 256
    jmodel = jax_algorithm("sliding_window").make_model(ns, 0.8)
    start = np.zeros((3, ns), np.uint32)
    # Saturated counters on some slots, as a lapped key leaves them.
    hot = np.arange(0, ns, 17)
    start[1, hot] = U32
    start[2, hot] = U32
    start[0, hot] = 1_700_000_000 - 1_700_000_000 % 60
    jstate = jnp.asarray(start)
    tstate = state_from_numpy(start, device="cpu")
    rng = np.random.default_rng(7)
    now = 1_700_000_000
    seen = set(int(s) for s in hot)
    for step in range(20):
        slots, hits, limits, fresh = _lanes(rng, ns, seen, neg=True)
        if step % 4 == 0:
            slots[0] = hot[step // 4]
            fresh[0] = False
        if step == 5:
            hits[:] = U32 - 1  # saturating add
        divider = rng.choice([1, 60, 3600], len(slots)).astype(np.uint32)
        pk = _packed(slots, hits, limits, fresh, divider, 8, ns)
        jstate, jout = jmodel.step_serve_packed(
            jstate, jnp.asarray(pk), jnp.asarray(now, jnp.int32)
        )
        tout = sw_serve_step(tstate, torch.from_numpy(pk), now)
        np.testing.assert_array_equal(tout.numpy().view(np.uint32), np.asarray(jout))
        np.testing.assert_array_equal(state_to_numpy(tstate), np.asarray(jstate))
        now += int(rng.integers(0, 45))
    assert (state_to_numpy(tstate)[1] == U32).any()


def test_sliding_window_saturated_prev_follows_jax_not_numpy():
    """prev saturated at u32 max and elapsed == 0: wprev is f32(2^32).
    JAX converts it saturating (4294967295), the numpy oracle wraps it
    to 0; the port follows the JAX step."""
    ns = 16
    w = 1_700_000_040
    start = np.zeros((3, ns), np.uint32)
    start[:, 5] = (w - 60, U32, 0)  # adjacent window: prev <- curr
    pk = _packed(np.array([5], np.int32), [1], [10], [False], [60], 8, ns)
    jmodel = jax_algorithm("sliding_window").make_model(ns, 0.8)
    _, jout = jmodel.step_serve_packed(
        jnp.asarray(start), jnp.asarray(pk), jnp.asarray(w, jnp.int32)
    )
    tout = sw_serve_step(state_from_numpy(start, device="cpu"), torch.from_numpy(pk), w)
    ref = start.copy()
    ref_wprev, _ = jmodel.reference_step(
        ref, np.array([5]), np.array([1], np.uint32), np.array([10], np.uint32),
        np.array([False]), np.array([60], np.uint32), w,
    )
    assert int(np.asarray(jout)[0, 0]) == U32
    assert int(tout.numpy().view(np.uint32)[0, 0]) == U32
    assert int(ref_wprev[0]) == 0


def _gcra_lanes(rng, ns, seen):
    slots, hits, limits, fresh = _lanes(rng, ns, seen, neg=True)
    limits[rng.random(len(slots)) < 0.1] = 0  # limit 0: budget 0
    divider = rng.choice([1, 60, 3600], len(slots)).astype(np.uint32)
    return slots, hits, limits, fresh, divider


def test_gcra_plain_matches_numpy_reference_exactly():
    ns = 256
    jmodel = jax_algorithm("gcra").make_model(ns, 0.8)
    ref = np.zeros((2, ns), np.uint32)
    tstate = GcraModel(ns, device="cpu").init_state()
    rng = np.random.default_rng(11)
    now = 1_700_000_000
    seen = set()
    for _ in range(40):
        slots, hits, limits, fresh, divider = _gcra_lanes(rng, ns, seen)
        pk = _packed(slots, hits, limits, fresh, divider, 8, ns)
        with np.errstate(divide="ignore", invalid="ignore"):
            want = jmodel.reference_step(ref, slots, hits, limits, fresh, divider, now)
        got = gcra_serve_step(tstate, torch.from_numpy(pk), now)
        np.testing.assert_array_equal(got.numpy()[: len(slots)], want)
        np.testing.assert_array_equal(state_to_numpy(tstate), ref)
        now += int(rng.integers(0, 45))
    assert (ref[0] != 0).any()


def test_gcra_plain_within_one_cell_of_jax_step():
    """tests/test_algorithms.py's tolerances for the jitted step: each
    step runs from the same state, budgets within one cell and >= 90 %
    exact, TAT seconds within 1 s."""
    ns = 256
    jmodel = jax_algorithm("gcra").make_model(ns, 0.8)
    state = np.zeros((2, ns), np.uint32)
    rng = np.random.default_rng(7)
    now = 1_700_000_000
    seen = set()
    exact = total = 0
    for _ in range(30):
        slots, hits, limits, fresh = _lanes(rng, ns, seen)
        divider = np.full(len(slots), 60, np.uint32)
        pk = _packed(slots, hits, limits, fresh, divider, 8, ns)
        jstate, jout = jmodel.step_serve_packed(
            jnp.asarray(state.copy()), jnp.asarray(pk), jnp.asarray(now, jnp.int32)
        )
        tstate = state_from_numpy(state, device="cpu")
        tout = gcra_serve_step(tstate, torch.from_numpy(pk), now)
        g = len(slots)
        b_jax = np.asarray(jout)[:g].astype(np.int64)
        b_port = tout.numpy()[:g].astype(np.int64)
        assert np.abs(b_jax - b_port).max(initial=0) <= 1
        exact += int((b_jax == b_port).sum())
        total += g
        sec_delta = (np.asarray(jstate)[0] - state_to_numpy(tstate)[0]).view(np.int32)
        assert np.abs(sec_delta).max(initial=0) <= 1
        state = state_to_numpy(tstate)
        now += int(rng.integers(0, 45))
    assert exact >= total * 0.9, (exact, total)


@pytest.mark.parametrize("name,rows", [("sliding_window", 3), ("gcra", 2)])
def test_algorithm_state_round_trips_through_numpy(name, rows):
    model = get_algorithm(name).make_model(100, 0.8, device="cpu")
    jstate = np.asarray(jax_algorithm(name).make_model(100, 0.8).init_state())
    t = model.init_state()
    assert t.shape == (rows, 100) and t.dtype == torch.int32
    assert state_to_numpy(t).shape == jstate.shape
    arr = np.random.default_rng(1).integers(0, 1 << 32, (rows, 100), dtype=np.uint64)
    arr = arr.astype(np.uint32)
    np.testing.assert_array_equal(state_to_numpy(state_from_numpy(arr, device="cpu")), arr)


@pytest.mark.parametrize("step", [sw_serve_step, gcra_serve_step])
def test_algorithm_wrappers_check_inputs(step):
    rows = 3 if step is sw_serve_step else 2
    state = torch.zeros((rows, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="packed must be int32"):
        step(state, torch.zeros((4, 8), dtype=torch.int32), 0)
    with pytest.raises(TypeError, match="state must be int32"):
        step(torch.zeros(8, dtype=torch.int32), torch.zeros((5, 8), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="int32 clock"):
        step(state, torch.zeros((5, 8), dtype=torch.int32), 1 << 31)
    meta = torch.zeros((rows, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        step(meta, torch.zeros((5, 8), dtype=torch.int32, device="meta"), 0)


# -- the cache scenarios, through both services ------------------------

ALGO_YAML = """
domain: algo
descriptors:
  - key: fx
    rate_limit: {unit: minute, requests_per_unit: 10}
  - key: slide
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: sliding_window}
  - key: tb
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: gcra}
  - key: shady
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: sliding_window, shadow: true}
  - key: shady_tb
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: gcra, shadow: true}
"""

# A minute boundary with room on both sides.
EDGE = 1_700_000_040 - (1_700_000_040 % 60) + 60


class FakeRuntime:
    def __init__(self, files):
        self.files = dict(files)
        self.callbacks = []

    def snapshot(self):
        data = dict(self.files)

        class Snap:
            def keys(self):
                return sorted(data)

            def get(self, key):
                return data.get(key, "")

        return Snap()

    def add_update_callback(self, fn):
        self.callbacks.append(fn)


class Stack:
    """One package's service + cache + clock, driven by key bursts."""

    def __init__(self, port: bool, start: int, yaml=ALGO_YAML, banks=True):
        self.port = port
        if port:
            self.clock = PinnedTimeSource(start)
            algo = {
                name: CounterEngine(
                    buckets=(8, 32),
                    device="cpu",
                    model=get_algorithm(name).make_model(1 << 10, 0.8, device="cpu"),
                )
                for name in ("sliding_window", "gcra")
            }
            self.cache = CudaRateLimitCache(
                CounterEngine(num_slots=1 << 10, buckets=(8, 32), device="cpu"),
                self.clock,
                algorithm_banks=algo if banks else None,
            )
            self.svc = RateLimitService(
                FakeRuntime({"config.algo": yaml}), self.cache, Manager(),
                clock=self.clock,
            )
        else:
            self.clock = JaxPinned(start)
            algo = {
                name: JaxEngine(
                    buckets=(8, 32),
                    model=jax_algorithm(name).make_model(1 << 10, 0.8),
                )
                for name in ("sliding_window", "gcra")
            }
            self.cache = TpuRateLimitCache(
                JaxEngine(num_slots=1 << 10, buckets=(8, 32)),
                self.clock,
                algorithm_banks=algo if banks else None,
            )
            self.svc = JaxService(
                FakeRuntime({"config.algo": yaml}), self.cache, JaxManager(),
                clock=self.clock,
            )

    def burst(self, key, n):
        """(overall code, code, limit_remaining, reset) per request."""
        out = []
        for _ in range(n):
            if self.port:
                req = RateLimitRequest("algo", [Descriptor.of((key, "u"))], 0)
            else:
                req = JaxRequest("algo", [JaxDescriptor.of((key, "u"))], 0)
            resp = self.svc.should_rate_limit(req)
            st = resp.statuses[0]
            out.append(
                (int(resp.overall_code), int(st.code), st.limit_remaining,
                 st.duration_until_reset)
            )
        return out


def _both(start, **kw):
    return Stack(False, start, **kw), Stack(True, start, **kw)


def _codes(transcript):
    return [t[1] for t in transcript]


def _burst_both(stacks, key, n):
    """Burst both stacks; the transcripts must be equal."""
    jax_t, port_t = (s.burst(key, n) for s in stacks)
    assert port_t == jax_t, key
    return _codes(port_t)


def _advance(stacks, seconds):
    for s in stacks:
        s.clock.advance(seconds)


def test_fixed_window_admits_2x_at_edge_new_algorithms_hold():
    stacks = _both(EDGE - 5)
    for key in ("fx", "slide", "tb"):
        assert _burst_both(stacks, key, 10) == [OK] * 10, key
    _advance(stacks, 10)  # 5 s into the next window
    admitted = {
        key: _burst_both(stacks, key, 10).count(OK) for key in ("fx", "slide", "tb")
    }
    # Fixed window re-opens: 20 admitted inside 15 s.  Sliding window
    # still weighs floor(10 * 55/60) = 9; GCRA refilled one 6-s cell.
    assert admitted == {"fx": 10, "slide": 1, "tb": 1}
    _advance(stacks, 7)
    assert _burst_both(stacks, "tb", 2) == [OK, OVER]


def test_gcra_steady_rate_between_windows():
    stacks = _both(EDGE)
    assert _burst_both(stacks, "tb", 11).count(OK) == 10
    _advance(stacks, 120)  # two idle periods: the full burst is back
    assert _burst_both(stacks, "tb", 11).count(OK) == 10


def test_sliding_window_decay_readmits_gradually():
    stacks = _both(EDGE - 1)
    assert _burst_both(stacks, "slide", 10) == [OK] * 10
    _advance(stacks, 31)  # 30 s into the next window: wprev = 5
    assert _burst_both(stacks, "slide", 6).count(OK) == 5


def test_shadow_enforcement_byte_identical_to_fixed_window():
    """A shadowed rule answers exactly as a plain fixed-window rule --
    across bursts, window edges and the local-cache path -- while the
    candidate kernels run on the side."""
    plain_yaml = ALGO_YAML.replace(
        ", algorithm: sliding_window, shadow: true", ""
    ).replace(", algorithm: gcra, shadow: true", "")
    shadowed = Stack(True, EDGE - 5)
    plain = Stack(True, EDGE - 5, yaml=plain_yaml, banks=False)
    reference = Stack(False, EDGE - 5)
    transcripts = []
    for stack in (shadowed, plain, reference):
        t = []
        for _ in range(3):
            for key in ("shady", "shady_tb"):
                t += stack.burst(key, 8)
            stack.clock.advance(7)
        transcripts.append(t)
    assert transcripts[0] == transcripts[1] == transcripts[2]
    counts = shadowed.cache._shadow_counts
    assert sum(a + d for a, d in counts.values()) == 48, counts
    assert counts == {k: list(v) for k, v in reference.cache._shadow_counts.items()}


def test_shadow_divergence_counters():
    stacks = _both(EDGE - 5)
    _burst_both(stacks, "shady", 10)
    _burst_both(stacks, "shady_tb", 10)
    port = stacks[1].cache
    assert port._shadow_counts == {"gcra": [10, 0], "sliding_window": [10, 0]}
    _advance(stacks, 10)  # across the edge: fixed admits, candidates refuse
    assert _burst_both(stacks, "shady", 10) == [OK] * 10
    assert port._shadow_counts["sliding_window"] == [11, 9]
    assert _burst_both(stacks, "shady_tb", 10) == [OK] * 10
    assert port._shadow_counts["gcra"] == [11, 9]
    assert port._shadow_counts == {
        k: list(v) for k, v in stacks[0].cache._shadow_counts.items()
    }
    # ...and the counters are exported under the reference's names.
    mgr = Manager()
    port.register_stats(mgr.store)
    values = mgr.store.counter_fn_values()
    assert values["ratelimit.tpu.shadow.sliding_window.agree"] == 11
    assert values["ratelimit.tpu.shadow.gcra.diverge"] == 9


def test_missing_bank_folds_to_fixed_window():
    stacks = _both(EDGE - 5, banks=False)
    assert _burst_both(stacks, "slide", 11).count(OK) == 10
    _advance(stacks, 10)
    assert _burst_both(stacks, "slide", 10) == [OK] * 10
    assert stacks[1].cache._shadow_counts == {}


def test_algorithm_bank_uses_refresh_table_and_survives_windows():
    stacks = _both(EDGE)
    bank = stacks[1].cache.algorithm_banks["gcra"]
    assert bank.slot_table.refresh_expiry
    _burst_both(stacks, "tb", 10)
    for _ in range(40):  # 240 s = 4 windows, touched every 6 s
        _advance(stacks, 6)
        assert _burst_both(stacks, "tb", 1) == [OK]  # exactly the refill
        assert _burst_both(stacks, "tb", 1) == [OVER]  # ...and no more
    assert bank.stat_evictions == 0


@pytest.mark.parametrize("name", ["gcra", "sliding_window"])
def test_algorithm_state_crosses_packages(name):
    """A bank's state exported by either package imports into the
    other and gives the same next decisions."""
    key = {"gcra": "tb", "sliding_window": "slide"}[name]
    jax_stack, port_stack = _both(EDGE)
    _burst_both((jax_stack, port_stack), key, 7)
    jbank = jax_stack.cache.algorithm_banks[name]
    tbank = port_stack.cache.algorithm_banks[name]
    assert tbank.algorithm == jbank.algorithm == name
    exported = jbank.export_state()
    assert set(exported) == set(get_algorithm(name).state_rows)
    for row, arr in tbank.export_state().items():
        np.testing.assert_array_equal(arr, np.asarray(exported[row]), err_msg=row)

    # JAX -> port: a fresh port stack takes the JAX bank's state and slots.
    fresh_port = Stack(True, EDGE + 3)
    fresh_port.cache.algorithm_banks[name].import_state(exported)
    fresh_port.cache.algorithm_banks[name].slot_table = type(tbank.slot_table).from_entries(
        tbank.model.num_slots, jbank.slot_table.entries(), refresh_expiry=True
    )
    # port -> JAX, the same way.
    fresh_jax = Stack(False, EDGE + 3)
    jb2 = fresh_jax.cache.algorithm_banks[name]
    jb2.import_state(tbank.export_state())
    jb2.slot_table = type(jb2.slot_table).from_entries(
        jb2.model.num_slots, tbank.slot_table.entries(), refresh_expiry=True
    )
    _advance((jax_stack, port_stack), 3)
    want = jax_stack.burst(key, 5)
    assert fresh_port.burst(key, 5) == want
    assert fresh_jax.burst(key, 5) == want
    assert port_stack.burst(key, 5) == want
    with pytest.raises(ValueError):
        tbank.import_state({"counts": np.zeros(1 << 10, np.uint32)})


def test_generic_engine_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal needs a CUDA-less host")
    for cls in (SlidingWindowModel, GcraModel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(16)
