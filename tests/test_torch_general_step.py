"""The fused general step (K3 on one table, K7 on 8 banks) against JAX.

On the card the duplicate-tolerant step -- zero fresh slots, gather, the
per-slot prefix, modular scatter-add, and the afters, their narrow
readback or the decision block -- is one cooperative launch
(csrc/counter_update.cuh, general_step_kernel).  Here, on the CPU, every
wrapper takes its plain version, so these tests hold the port's entries
against the jitted JAX ones on the batches where the fused kernel's
three ordering hazards and its index policies matter:

- all lanes on one slot;
- a fresh flag only on the last duplicate of a slot (its zero must reach
  the earlier duplicates too);
- -1 beside ns - 1 (one table: one counter, two prefixes; 8 banks: -1 is
  out of the table);
- a running sum that wraps u32 inside a segment.  The wrapping segment
  has the smallest slot and wraps on its last lane, where JAX's XLA
  prefix (a segment_min of the sorted exclusive cumsum) is right too;
  where that prefix is wrong, tests/test_torch_prefix.py holds the port
  to the running sum instead;
- N in {1, 127, 129, 300} (tile edges) with duplicates, negative and
  out-of-table ids.

Each batch runs twice from an empty table, so the second pass starts
from the first's counts.  Integer arithmetic and one IEEE f32 multiply:
the tolerance is 0.  The single-table entries run against JaxModel, the
8-bank ones against the JAX sharded model on the conftest's 8 virtual
CPU devices.  Also: the C entries match ``kernels.SIGNATURES`` (every
row an ``extern "C"`` function of its library's source with the same
parameters, and every such function a row), the fused kernel is launched
only cooperatively, one step is one ctypes call, a refused launch raises
KernelError, and the forward steps route through the fused wrapper and
never through ``fw_decision_block``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxBatch
from ratelimit_tpu.models.fixed_window import FixedWindowModel as JaxModel
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models.fixed_window import (
    DeviceBatch,
    FixedWindowModel,
    state_to_numpy,
)
from ratelimit_tpu_torch.parallel import ShardedFixedWindowModel, make_mesh
from ratelimit_tpu_torch.parallel import sharded as sh

NS = 256
BANKS = 8
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
CSRC = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "csrc")
BATCHES = (
    "one_slot",
    "fresh_last_duplicate",
    "minus_one_beside_last",
    "u32_wrap",
    "n1",
    "n127",
    "n129",
    "n300",
)


def _limits(rng, n):
    """Small limits (lanes go over), and some near 2^32, where the narrow
    readback's cap limit + hits wraps."""
    limits = rng.integers(1, 40, n).astype(np.uint32)
    big = rng.random(n) < 0.15
    limits[big] = U32 - rng.integers(0, 4, int(big.sum())).astype(np.uint32)
    return limits


def _batch(kind):
    """The numpy batch `kind` (see the module docstring)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    n = int(kind[1:]) if kind[0] == "n" and kind[1:].isdigit() else 64
    hits = rng.integers(1, 6, n).astype(np.uint32)
    fresh = np.zeros(n, bool)
    if kind == "one_slot":
        slots = np.full(n, 17)
        fresh[20] = True
    elif kind == "fresh_last_duplicate":
        pool = rng.choice(NS, 8, replace=False)
        slots = pool[rng.integers(0, 8, n)]
        for s in pool[:3]:
            fresh[np.nonzero(slots == s)[0][-1]] = True
    elif kind == "minus_one_beside_last":
        slots = rng.choice([-1, NS - 1, 9], n)
        fresh[np.nonzero(slots == -1)[0][n // 8]] = True
    elif kind == "u32_wrap":
        # Slot 0 sorts first; its running sum 0xFFFFFFF0, 0xFFFFFFF8 wraps
        # to 0x8 on its last lane.
        slots = rng.integers(1, NS, n)
        slots[[3, 30, 60]] = 0
        hits[[3, 30, 60]] = [0xFFFFFFF0, 8, 16]
    else:
        # Duplicates over a pool of ids in the table, negative ones and
        # ids past either end.
        pool = rng.choice(np.arange(-NS - 4, NS + 6), max(2, n // 4), replace=False)
        slots = pool[rng.integers(0, len(pool), n)]
        fresh = rng.random(n) < 0.15
    return dict(
        slots=np.asarray(slots, np.int32),
        hits=hits,
        limits=_limits(rng, n),
        fresh=fresh,
        shadow=rng.random(n) < 0.3,
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the numpy array JAX returns: u32 bits as uint32,
    u16 (int16 storage) as uint16."""
    a = t.numpy()
    unsigned = {np.int32: np.uint32, np.int16: np.uint16}.get(a.dtype.type)
    return a if unsigned is None else a.view(unsigned)


def _step(jmodel, tmodel, jc, tc, entry, raw):
    """One step of `entry` on both models: (jc, jout, tout); the port
    updates `tc` in place."""
    jb, tb = _jax(raw), _port(raw)
    if entry in ("forward", "step"):
        jc, jout = jmodel.step(jc, jb)
        tc2, tout = getattr(tmodel, entry)(tc, tb)
    elif entry in ("update", "step_counters"):
        jc, jout = jmodel.step_counters(jc, jb)
        tc2, tout = getattr(tmodel, entry)(tc, tb)
    else:
        dt = entry.split("_")[-1]
        jc, jout = jmodel.step_counters_compact(jc, dt, jb)
        tc2, tout = tmodel.step_counters_compact(tc, dt, tb)
    assert tc2 is tc  # updated in place
    return jc, jout, tout


def _compare(tout, jout, what):
    if isinstance(tout, fw.DeviceDecisions):
        for f in FIELDS:
            np.testing.assert_array_equal(
                _host(getattr(tout, f)), np.asarray(getattr(jout, f)), err_msg=f"{what} {f}"
            )
        return
    assert _host(tout).dtype == np.asarray(jout).dtype
    np.testing.assert_array_equal(_host(tout), np.asarray(jout), err_msg=what)


def _run_twice(jmodel, tmodel, entry, kind):
    raw = _batch(kind)
    jc, tc = jmodel.init_state(), tmodel.init_state()
    for rep in range(2):
        jc, jout, tout = _step(jmodel, tmodel, jc, tc, entry, raw)
        _compare(tout, jout, f"{entry} {kind} pass {rep}")
        np.testing.assert_array_equal(
            state_to_numpy(tc), np.asarray(jc), err_msg=f"{entry} {kind} table, pass {rep}"
        )


@pytest.mark.parametrize(
    "entry", ["forward", "step", "update", "compact_uint8", "compact_uint16"]
)
@pytest.mark.parametrize("kind", BATCHES)
def test_single_table_matches_jitted_jax(entry, kind):
    _run_twice(JaxModel(NS), FixedWindowModel(NS, device="cpu"), entry, kind)


@pytest.mark.parametrize(
    "entry", ["step", "step_counters", "compact_uint8", "compact_uint16"]
)
@pytest.mark.parametrize("kind", BATCHES)
def test_sharded_matches_jitted_jax(entry, kind):
    _run_twice(
        JaxShardedModel(NS, jax_make_mesh(BANKS)),
        ShardedFixedWindowModel(NS, make_mesh(BANKS, "cpu")),
        entry,
        kind,
    )


def test_the_batches_hit_their_cases():
    """Each edge batch holds what it is named for."""
    one = _batch("one_slot")
    assert len(set(one["slots"].tolist())) == 1 and one["fresh"].sum() == 1
    last = _batch("fresh_last_duplicate")
    for i in np.nonzero(last["fresh"])[0]:
        dups = np.nonzero(last["slots"] == last["slots"][i])[0]
        assert len(dups) > 1 and dups[-1] == i
    pair = _batch("minus_one_beside_last")["slots"]
    assert {-1, NS - 1} <= set(pair.tolist())
    wrap = _batch("u32_wrap")
    running = np.cumsum(wrap["hits"][wrap["slots"] == 0].astype(np.uint64))
    assert running[-2] < 2**32 <= running[-1]
    assert all(len(_batch(f"n{n}")["slots"]) == n for n in (1, 127, 129, 300))


# -- routing and the launch ---------------------------------------------


@pytest.mark.parametrize("which", ["forward", "step", "sharded step"])
def test_forward_steps_take_the_fused_step_once(monkeypatch, which):
    """forward / step and the sharded step each call their fused wrapper
    once, and never the standalone decision block or update."""
    calls = []

    def spy(name, real):
        def call(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        return call

    def refuse(*args, **kwargs):
        raise AssertionError("the forward step left the fused general step")

    monkeypatch.setattr(fw, "fw_general_step", spy("fw", fw.fw_general_step))
    monkeypatch.setattr(sh, "sharded_general_step", spy("sharded", sh.sharded_general_step))
    for module, name in ((fw, "fw_decision_block"), (fw, "fw_general_update"),
                         (sh, "sharded_general_update")):
        monkeypatch.setattr(module, name, refuse)
    batch = _port(_batch("n127"))
    if which == "sharded step":
        model = ShardedFixedWindowModel(NS, make_mesh(BANKS, "cpu"))
        model.step(model.init_state(), batch)
        assert calls == ["sharded"]
    else:
        model = FixedWindowModel(NS, device="cpu")
        getattr(model, which)(model.init_state(), batch)
        assert calls == ["fw"]


def _fake_card(monkeypatch, rc=0):
    """kernels.function as a recorder of (entry, args) returning `rc`,
    and a CPU tensor taken for a card's: the launch path runs on the
    CPU up to the ctypes call."""
    calls = []

    def function(name):
        def call(*args):
            calls.append((name, args))
            return rc

        return call

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(fw, "_require_cuda", lambda device: None)
    return calls


def _launch(table, epilogue, n=40):
    rng = np.random.default_rng(n)
    raw = _batch("n127")
    b = _port({k: v[:n] for k, v in raw.items()})
    if table == "one table":
        entry, shape, kernel, counts = "rl_fw_general_step", (NS,), fw.K3_STEP, torch.zeros(NS, dtype=torch.int32)
    else:
        entry, shape, kernel = "rl_sharded_group_step", (BANKS, 0, BANKS, NS // BANKS), sh.K7_STEP
        counts = torch.zeros(shape, dtype=torch.int32)
    if epilogue != "decide":
        kernel = fw.K3_UPDATE if table == "one table" else sh.K7
    decide = dict(shadow=b.shadow, near_ratio=float(rng.random())) if epilogue == "decide" else {}
    out_dtype = "" if epilogue == "decide" else epilogue
    result = fw.launch_general_step(
        entry, shape, kernel, counts, b.slots, b.hits, b.fresh, b.limits, out_dtype, **decide
    )
    return entry, shape, kernel, counts, b, result


@pytest.mark.parametrize("epilogue", ["", "uint8", "uint16", "decide"])
@pytest.mark.parametrize("table", ["one table", "8 banks"])
def test_one_step_is_one_ctypes_call(monkeypatch, table, epilogue):
    calls = _fake_card(monkeypatch)
    before = dict(kernels.launches)
    entry, shape, kernel, counts, b, result = _launch(table, epilogue)
    n = b.slots.shape[0]
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert len(args) == len(kernels.SIGNATURES[entry][1])
    k = len(shape)
    assert args[: 1 + k] == (counts.data_ptr(), *shape)
    slots, hits, fresh, limits, shadow, ratio, afters, incl, out, set_lc, code, n_arg, _ = args[1 + k :]
    assert (slots, hits, fresh, limits) == tuple(
        t.data_ptr() for t in (b.slots, b.hits, b.fresh, b.limits)
    )
    assert n_arg == n
    assert code == {"": 0, "uint8": 1, "uint16": 2, "decide": 3}[epilogue]
    if epilogue == "decide":
        assert isinstance(result, fw.DeviceDecisions)
        assert shadow == b.shadow.data_ptr() and set_lc == result.set_local_cache.data_ptr()
        assert out == result.codes.data_ptr() and afters == result.afters.data_ptr()
        assert all(getattr(result, f).shape == (n,) for f in FIELDS)
        assert result.set_local_cache.dtype == torch.bool
    else:
        assert shadow is None and set_lc is None and ratio == 0.0
        assert result.dtype == fw.OUT_DTYPES[epilogue] and result.shape == (n,)
        assert (afters if epilogue == "" else out) == result.data_ptr()
        assert len({afters, incl, out}) == (2 if epilogue == "" else 3)
    assert incl not in (afters, out)
    assert kernels.launches[kernel] == before.get(kernel, 0) + 1


def test_a_refused_launch_raises_and_counts_nothing(monkeypatch):
    """cudaErrorCooperativeLaunchTooLarge (720), as the C entry returns
    it, raises KernelError; no fallback, no count.  An empty batch makes
    no call at all."""
    calls = _fake_card(monkeypatch, rc=720)
    before = kernels.launches[fw.K3_STEP]
    with pytest.raises(kernels.KernelError, match="720"):
        _launch("one table", "decide")
    assert kernels.launches[fw.K3_STEP] == before and len(calls) == 1
    out = fw.launch_general_step(
        "rl_fw_general_step", (NS,), fw.K3_UPDATE, torch.zeros(NS, dtype=torch.int32),
        *(torch.zeros(0, dtype=torch.int32),) * 2, torch.zeros(0, dtype=torch.bool),
    )
    assert out.shape == (0,) and len(calls) == 1


# -- the sources against the ctypes table --------------------------------

_REMOVED = (
    "zero_fresh_kernel", "gather_kernel", "add_kernel", "launch_zero_and_gather",
    "launch_add", "rl_fw_zero_and_gather", "rl_fw_add", "rl_sharded_zero_and_gather",
    "rl_sharded_add",
)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _ctype(param):
    """The ctypes type of one C parameter, e.g. 'const void* slots'."""
    ctype = re.match(r"(.*?)\w+$", param.strip()).group(1)
    if "**" in ctype:
        return kernels.ctypes.POINTER(kernels.ctypes.c_void_p)
    if "*" in ctype:
        return kernels.ctypes.c_void_p
    return {
        "int": kernels.ctypes.c_int,
        "long long": kernels.ctypes.c_longlong,
        "float": kernels.ctypes.c_float,
    }[ctype.strip()]


def _externs(library):
    """extern "C" functions of a library's source: name -> ctypes."""
    src = _source(kernels.SOURCES[library])
    return {
        m.group(1): [_ctype(p) for p in m.group(2).split(",")]
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)
    }


def test_signatures_are_the_c_entries():
    """Every SIGNATURES row is an extern "C" function of its library's
    source with the same parameter types, and every extern "C" function
    has a row."""
    externs = {lib: _externs(lib) for lib in kernels.SOURCES}
    for name, (lib, argtypes) in kernels.SIGNATURES.items():
        assert name in externs[lib], f"{name} is not an extern C entry of {lib}"
        assert externs[lib][name] == argtypes, name
    for lib, entries in externs.items():
        for name in entries:
            assert kernels.SIGNATURES.get(name, (None,))[0] == lib, f"{name} has no row"


def test_the_fused_step_is_one_cooperative_launch_and_the_chain_is_gone():
    sources = {f: _source(f) for f in os.listdir(CSRC)}
    every = "".join(sources.values())
    assert "cudaLaunchCooperativeKernel(" in sources["counter_update.cuh"]
    assert "grid.sync()" in sources["counter_update.cuh"]
    assert not re.search(r"general_step_kernel<[^;]*?<<<", every)
    for name in _REMOVED:
        assert not re.search(rf"\b{name}\b", every), name
        assert name not in kernels.SIGNATURES
    # The standalone K2 and decision block stay, on the shared code.
    assert "prefix_tile_pass(" in sources["prefix.cu"]
    assert "decide_lane(" in sources["fixed_window.cu"]
