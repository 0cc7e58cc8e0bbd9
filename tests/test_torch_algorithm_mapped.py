"""The algorithm kernels' mapped form (K4 sliding window, K5 GCRA), on the
CPU.

A served algorithm chunk past the by-value budget (more than 128 padded
lanes) goes to K4 / K5 in their mapped form: the kernel reads the packed
int32[5, N] batch straight from the engine's pinned staging through its
device alias and writes the readback there the same way, so a wide
chunk is one launch with no upload, no device buffer and no readback
copy.  On the CPU the mapped wrappers run the same plain versions as the
device form, into the caller's `out`.  Inputs come from a numpy seed, at
2^12 to 2^18 slots:

- each mapped wrapper (and the model's ``step_serve_mapped``) against
  the device form's plain version and the JAX package's step over the
  clock steps of tests/test_torch_algorithm_lanes.py, N in {129, 130,
  256, 1024, 4096} (129 and 130 take the kernel's scalar path), with ids
  in [-ns, -1], out-of-table pads, fresh lanes, saturated counts, limit
  0 and limits near 2^32.  K4 is exact against the jitted JAX step; K5
  exact against the numpy ``reference_step`` and within one cell of the
  jitted JAX step (XLA may fuse a multiply and an add);
- both algorithm engines serving a 256-lane and a 4096-lane chunk as the
  JAX engine does, every decision field and state row equal, the chunk
  ONE mapped call handed the submission's own staging, with no
  ``Tensor.to`` and no ``copy_`` in the engine and no device-form call;
- what the mapped wrappers refuse;
- the C entries against ``kernels.SIGNATURES`` both ways, and the mapped
  layout's constants shared through ``csrc/mapped.cuh``.
"""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.analysis.cparse import parse_source, parse_sources
from ratelimit_tpu_torch.backends.engine import DEFAULT_BUCKETS, CounterEngine, HostBatch
from ratelimit_tpu_torch.models import gcra
from ratelimit_tpu_torch.models import sliding_window as sw
from ratelimit_tpu_torch.models.fixed_window import state_from_numpy, state_to_numpy
from ratelimit_tpu_torch.models.registry import get_algorithm
from test_torch_algorithm_lanes import NOW, STEPS, U32, _assert_same, _batch, _start, _words

CSRC = Path(__file__).resolve().parent.parent / "ratelimit_tpu_torch" / "csrc"
#: (lanes, slots): one lane past the by-value budget and one more (the
#: scalar path), then the engine's wide buckets.
WIDE = [(129, 1 << 12), (130, 1 << 13), (256, 1 << 14), (1024, 1 << 16), (4096, 1 << 18)]


# -- the mapped wrappers against the device form and JAX --------------------


@pytest.mark.parametrize("n,ns", WIDE)
def test_sw_mapped_equals_device_form_and_jax_step(n, ns):
    rng = np.random.default_rng(300 + n)
    pool = rng.choice(ns, 2 * n, replace=False)
    start = _start(rng, "sw", ns, pool)
    jmodel = jax_algorithm("sliding_window").make_model(ns, 0.8)
    model = sw.SlidingWindowModel(ns, device="cpu")
    jstate = jnp.asarray(start)
    mapped, device = state_from_numpy(start, "cpu"), state_from_numpy(start, "cpu")
    for step, dt in enumerate(STEPS):
        words, _ = _words(rng, n, ns, pool)
        out = torch.full((2, n), 7, dtype=torch.int32)
        if step % 2:
            assert sw.sw_serve_step_mapped(mapped, torch.from_numpy(words), NOW + dt, out) is out
        else:
            state, got = model.step_serve_mapped(mapped, torch.from_numpy(words), NOW + dt, out)
            assert state is mapped and got is out
        want = sw.sw_serve_step(device, torch.from_numpy(words.copy()), NOW + dt)
        jstate, jout = jmodel.step_serve_packed(
            jstate, jnp.asarray(words), jnp.asarray(NOW + dt, jnp.int32)
        )
        assert torch.equal(out, want)
        assert torch.equal(mapped, device)
        np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(jout))
        np.testing.assert_array_equal(state_to_numpy(mapped), np.asarray(jstate))
    assert (state_to_numpy(mapped)[1:] == U32).any()


@pytest.mark.parametrize("n,ns", WIDE)
def test_gcra_mapped_equals_device_form_and_reference(n, ns):
    """Exact against the device form and the numpy reference_step; the
    jitted JAX step, run from the same state each step, within one cell
    (one f32 ulp for budgets past 2^24) and >= 90 % of budgets exact,
    tests/test_torch_algorithm_lanes.py's tolerance."""
    rng = np.random.default_rng(400 + n)
    pool = rng.choice(ns, 2 * n, replace=False)
    ref = _start(rng, "gcra", ns, pool)
    jmodel = jax_algorithm("gcra").make_model(ns, 0.8)
    model = gcra.GcraModel(ns, device="cpu")
    mapped, device = state_from_numpy(ref, "cpu"), state_from_numpy(ref, "cpu")
    exact = total = 0
    for step, dt in enumerate(STEPS):
        words, g = _words(rng, n, ns, pool)
        before = ref.copy()
        out = torch.full((n,), 7, dtype=torch.int32)
        if step % 2:
            assert gcra.gcra_serve_step_mapped(mapped, torch.from_numpy(words), NOW + dt, out) is out
        else:
            state, got = model.step_serve_mapped(mapped, torch.from_numpy(words), NOW + dt, out)
            assert state is mapped and got is out
        want = gcra.gcra_serve_step(device, torch.from_numpy(words.copy()), NOW + dt)
        assert torch.equal(out, want)
        assert torch.equal(mapped, device)
        w = words[:, :g]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            budgets = jmodel.reference_step(
                ref, w[0], w[1].view(np.uint32), w[2].view(np.uint32), w[3] != 0,
                w[4].view(np.uint32), NOW + dt,
            )
        np.testing.assert_array_equal(out.numpy()[:g], budgets)
        np.testing.assert_array_equal(state_to_numpy(mapped), ref)
        _, jout = jmodel.step_serve_packed(
            jnp.asarray(before), jnp.asarray(words), jnp.asarray(NOW + dt, jnp.int32)
        )
        b_jax = np.asarray(jout)[:g].astype(np.int64)
        b_port = out.numpy()[:g].astype(np.int64)
        ulp = np.spacing(b_port.astype(np.float32)).astype(np.int64)
        assert (np.abs(b_jax - b_port) <= np.maximum(ulp, 1)).all()
        exact += int((b_jax == b_port).sum())
        total += g
    assert exact >= total * 0.9, (exact, total)


# -- the engines against JAX ------------------------------------------------


def _no_copies(monkeypatch, module, names):
    """Record Tensor.to and Tensor.copy_ calls made outside the wrapper
    functions `names` of `module` (their plain versions copy on the
    CPU), and the calls of those wrappers with their arguments."""
    seen = dict(to=0, copy_=0, calls=[])
    inside = [0]
    for method in ("to", "copy_"):
        real = getattr(torch.Tensor, method)

        def spy(self, *args, _real=real, _m=method, **kwargs):
            if not inside[0]:
                seen[_m] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, method, spy)
    for name in names:
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            seen["calls"].append((_name, args))
            inside[0] += 1
            try:
                return _real(*args, **kwargs)
            finally:
                inside[0] -= 1

        monkeypatch.setattr(module, name, wrapper)
    return seen


#: name -> (module, mapped wrapper, by-value wrapper, device form).
WRAPPERS = {
    "sliding_window": (sw, "sw_serve_step_mapped", "sw_serve_step_lanes", "sw_serve_step"),
    "gcra": (gcra, "gcra_serve_step_mapped", "gcra_serve_step_lanes", "gcra_serve_step"),
}


@pytest.mark.parametrize("padded,distinct", [(256, 200), (4096, 3000)])
@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_engine_serves_a_wide_chunk_like_jax(monkeypatch, name, padded, distinct):
    """A chunk of `distinct` slots (duplicates beside them) pads to
    `padded` lanes: every decision field and state row equals the JAX
    engine's, and the chunk is ONE call of the mapped wrapper, handed
    views of the submission's own staging (the words of its packed
    buffer, the readback of its readback buffer), with no Tensor.to and
    no copy_ in the engine, no by-value and no device-form call."""
    ns = 1 << 14
    je = JaxEngine(buckets=DEFAULT_BUCKETS, model=jax_algorithm(name).make_model(ns, 0.8))
    te = CounterEngine(
        buckets=DEFAULT_BUCKETS, device="cpu", model=get_algorithm(name).make_model(ns, 0.8, "cpu")
    )
    rng = np.random.default_rng(padded + len(name))
    now = NOW
    for step in range(2):
        raw = _batch(rng, distinct + distinct // 4, ns, name)
        raw["slots"] = rng.choice(ns, distinct, replace=False)[np.arange(len(raw["slots"])) % distinct]
        raw["slots"] = raw["slots"].astype(np.int32)
        module, mapped, lanes, device = WRAPPERS[name]
        with monkeypatch.context() as m:
            seen = _no_copies(m, module, (mapped, lanes, device))
            token = te.step_submit(HostBatch(**raw), now)
            (st, readback), *_ = token[3][0]
            assert (seen["to"], seen["copy_"]) == (0, 0)
            ((called, (state, words, when, out)),) = seen["calls"]
            assert called == mapped and when == now
            assert tuple(words.shape) == (5, padded)
            assert words.data_ptr() == st.packed.data_ptr()
            assert out is readback and out.data_ptr() == st.readback.data_ptr()
        got = te.step_complete(token)
        _assert_same(je.step(JaxHostBatch(**raw), now), got, f"step {step}")
        for row, arr in je.export_state().items():
            np.testing.assert_array_equal(te.export_state()[row], arr, err_msg=row)
        now += 45


# -- refusals ----------------------------------------------------------------


MAPPED_STEPS = [
    (sw.sw_serve_step_mapped, 3, (2,)),
    (gcra.gcra_serve_step_mapped, 2, ()),
]


@pytest.mark.parametrize("step,rows,out_rows", MAPPED_STEPS, ids=["K4", "K5"])
def test_mapped_wrappers_refuse_what_the_kernel_does_not_take(step, rows, out_rows):
    state = torch.zeros((rows, 64), dtype=torch.int32)
    words = torch.zeros((5, 256), dtype=torch.int32)
    words[0] = 64 + torch.arange(256, dtype=torch.int32)  # inert: past the table
    words[4] = 1
    out = torch.full((*out_rows, 256), 7, dtype=torch.int32)
    # Any width: 256 and 129 lanes are past the by-value budget, not the
    # mapped one; nothing is read or written past the table.
    assert step(state, words, 0, out) is out and not state.any()
    odd = torch.zeros((*out_rows, 129), dtype=torch.int32)
    assert step(state, words[:, :129].contiguous(), 0, odd) is odd
    empty = torch.zeros((*out_rows, 0), dtype=torch.int32)
    assert step(state, torch.zeros((5, 0), dtype=torch.int32), 0, empty) is empty
    # The kernel reads the words and writes the readback in host memory:
    # tensors on a device are refused, and so are strided ones.
    with pytest.raises(ValueError, match="words must be a contiguous host tensor"):
        step(state, words.to("meta"), 0, out)
    with pytest.raises(ValueError, match="words must be a contiguous host tensor"):
        step(state, torch.zeros((5, 512), dtype=torch.int32)[:, ::2], 0, out)
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        step(state, words, 0, out.to("meta"))
    with pytest.raises(TypeError, match=r"words must be int32\[\.\.\., 5, N\]"):
        step(state, torch.zeros((4, 256), dtype=torch.int32), 0, out)
    with pytest.raises(TypeError, match=r"words must be int32\[\.\.\., 5, N\]"):
        step(state, words.to(torch.int64), 0, out)
    with pytest.raises(TypeError, match=r"words must be int32\[5, N\]"):
        step(state, torch.zeros((2, 5, 256), dtype=torch.int32), 0, out)
    with pytest.raises(TypeError, match="out must be"):
        step(state, words, 0, torch.zeros((*out_rows, 255), dtype=torch.int32))
    with pytest.raises(TypeError, match="out must be"):
        step(state, words, 0, torch.zeros((*out_rows, 256), dtype=torch.int64))
    with pytest.raises(TypeError, match="state must be int32"):
        step(torch.zeros((rows + 1, 64), dtype=torch.int32), words, 0, out)
    with pytest.raises(ValueError, match="state must be contiguous"):
        step(torch.zeros((64, rows), dtype=torch.int32).t(), words, 0, out)
    with pytest.raises(ValueError, match="does not fit the kernels' int32 clock"):
        step(state, words, 1 << 31, out)
    # No fallback: a table on a device without a kernel is refused.
    with pytest.raises(ValueError, match="unsupported device"):
        step(torch.zeros((rows, 64), dtype=torch.int32, device="meta"), words, 0, out)


# -- the C entries ----------------------------------------------------------------

_CTYPE = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_longlong, "int32_t": ctypes.c_int,
          "float": ctypes.c_float}


@pytest.mark.parametrize("algo", ["sw", "gcra"])
def test_signatures_match_the_extern_c_sources_both_ways(algo):
    """Every extern "C" entry of csrc/*.cu has a SIGNATURES row and every
    row an entry; the mapped entry's parameters read as its ctypes
    argtypes, the same as its by-value twin's and its device form's, in
    the algorithms library."""
    model = parse_sources([str(p) for p in sorted(CSRC.glob("*.cu"))])
    assert set(model.functions) == set(kernels.SIGNATURES)
    entry = f"rl_{algo}_serve_step_mapped"
    params = [_CTYPE[p.ctype.describe()] for p in model.functions[entry].params]
    assert params == kernels.SIGNATURES[entry][1]
    for twin in (f"rl_{algo}_serve_step_lanes", f"rl_{algo}_serve_step"):
        assert kernels.SIGNATURES[twin] == kernels.SIGNATURES[entry] == ("algorithms", params)
    assert [p.name for p in model.functions[entry].params][2] == "words"


def test_the_mapped_layout_is_shared():
    """kMappedLanes and kMappedThreads live in csrc/mapped.cuh alone, which
    the fixed-window and the algorithm kernels both include; the one-lane
    algorithm kernels are gone, so each algorithm has one rows kernel
    for its device and mapped forms."""
    consts = parse_source(str(CSRC / "mapped.cuh")).constants
    assert (consts["kMappedLanes"], consts["kMappedThreads"]) == (4, 32)
    sources = {p.name: p.read_text() for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for name in ("counter_update.cuh", "algorithms.cu"):
        assert '#include "mapped.cuh"' in sources[name], name
    for name, text in sources.items():
        if name != "mapped.cuh":
            assert "constexpr int kMappedLanes" not in text, name
            assert "constexpr int kMappedThreads" not in text, name
    algorithms = sources["algorithms.cu"]
    for kernel in ("sw_serve_step_kernel", "gcra_serve_step_kernel"):
        assert kernel + "(" not in algorithms
    for kernel in ("sw_serve_step_rows_kernel", "gcra_serve_step_rows_kernel"):
        assert algorithms.count(f"__global__ void {kernel}(") == 1, kernel
        assert algorithms.count(f"({kernel}, state") == 2, kernel  # device and mapped entries
