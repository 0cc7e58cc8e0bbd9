"""The served unique-slot step's mapped form, on the CPU.

A served chunk past the by-value budget (more than 128 padded lanes,
banks x cap) goes to K1 / K6 in their mapped form: the kernel reads the
packed batch straight from the engine's pinned staging through its device
alias and writes the readback there the same way, so a wide chunk is one
launch with no upload, no device buffer and no readback copy.  The
batch's shape alone picks the form (``lanes_by_value``).  On the CPU the
mapped wrappers run the same plain versions as the device form, into the
caller's `out`, so these tests hold:

- the form rule at every default bucket and at 8 banks x cap 8 to 512;
- each mapped wrapper (K1, K6, K6's card form, the mesh entry) against
  its device form and the JAX step on the same seeded inputs, with
  fresh, padding, saturated, negative and out-of-table ids, in u32, u8
  and u16;
- CounterEngine over wide chunks (129 to 4096 lanes, duplicates) against
  the JAX ``tpu`` engine, and ShardedCounterEngine on one group and on 4
  CPU "cards" against JAX's ``tpu-sharded`` engine at 2, 4 and 8 virtual
  devices, tolerance 0;
- that a wide chunk is ONE mapped call handed the staging itself, with
  no ``Tensor.to`` and no ``copy_`` in the engine, and over 4 cards ONE
  ctypes call of the mesh entry (``kernels.function`` faked);
- the wrappers' refusals, and the new C entries against
  ``kernels.SIGNATURES`` both ways.
"""

import ctypes
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.fixed_window import FixedWindowModel as JaxModel
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.analysis.cparse import parse_sources
from ratelimit_tpu_torch.backends.engine import DEFAULT_BUCKETS, CounterEngine, HostBatch
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models.fixed_window import state_from_numpy, state_to_numpy
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, ShardedFixedWindowModel, make_mesh
from ratelimit_tpu_torch.parallel import sharded as sh

U32 = 0xFFFFFFFF
DTYPES = ["", "uint8", "uint16"]
FIELDS = fw.DeviceDecisions._fields
_HOST = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8}
CSRC = Path(__file__).resolve().parent.parent / "ratelimit_tpu_torch" / "csrc"
#: Widths past the by-value budget: one lane past it, and buckets.
WIDE = (129, 256, 1024, 4096)


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_HOST[t.dtype])


def _assert_same(dj, dt, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(dt, f)).astype(np.int64),
            np.asarray(getattr(dj, f)).astype(np.int64),
            err_msg=f"{what} {f}",
        )


# -- the form rule ------------------------------------------------------------


@pytest.mark.parametrize("padded", DEFAULT_BUCKETS)
def test_one_table_form_at_every_default_bucket(padded):
    assert fw.lanes_by_value(1, padded) is (padded <= fw.MAX_LANES)


@pytest.mark.parametrize("cap", [8, 16, 32, 64, 128, 256, 512])
def test_eight_banks_form_at_every_cap(cap):
    """8 banks go by value up to cap 16 (128 routed lanes), mapped past."""
    assert fw.lanes_by_value(8, cap) is (cap <= 16)


# -- the mapped wrappers against the device form and JAX --------------------


def _unique_words(rng, n, ns):
    """int32[4, n]: distinct live slots (about a third as their alias id -
    ns, some on near-u32-max counters with large hits), fresh lanes, a
    few out-of-table ids below -ns and past the padding, and distinct
    pads ns + i."""
    pad = n // 4
    g = n - pad
    slots = rng.choice(ns, g, replace=False).astype(np.int64)
    slots[rng.random(g) < 0.35] -= ns
    far = rng.random(g) < 0.05
    slots[far] = np.where(rng.random(int(far.sum())) < 0.5, -ns - 1 - np.arange(int(far.sum())),
                          4 * ns + np.arange(int(far.sum())))
    slots = np.concatenate([slots, ns + np.arange(pad)])
    hits = rng.integers(0, 30, n).astype(np.uint32)
    hits[: max(1, g // 4)] = U32 - rng.integers(0, 4, max(1, g // 4)).astype(np.uint32)
    limits = rng.integers(1, 200, n).astype(np.uint32)
    fresh = rng.random(n) < 0.2
    hits[g:], limits[g:], fresh[g:] = 0, 1, False
    return np.stack(
        [slots.astype(np.int32), hits.view(np.int32), limits.view(np.int32), fresh]
    ).astype(np.int32)


def _warm(rng, ns):
    start = rng.integers(0, 100, ns).astype(np.uint32)
    start[rng.choice(ns, ns // 4, replace=False)] = U32 - 2
    return start


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("n", WIDE)
def test_k1_mapped_equals_device_form_and_jax(n, out_dtype):
    """fw_unique_step_mapped over three steps against fw_unique_step and
    JAX's jitted step_counters_unique_packed: readback and table equal."""
    rng = np.random.default_rng(n + len(out_dtype))
    ns = 8192
    start = _warm(rng, ns)
    jc = jnp.asarray(start)
    ck, cd = state_from_numpy(start, "cpu"), state_from_numpy(start, "cpu")
    model = fw.FixedWindowModel(ns, device="cpu")
    for step in range(3):
        pk = _unique_words(rng, n, ns)
        out = torch.full((n,), 7, dtype=fw.OUT_DTYPES[out_dtype])
        ck, got = model.step_counters_unique_mapped(ck, out_dtype, torch.from_numpy(pk), out)
        assert got is out
        want = fw.fw_unique_step(cd, torch.from_numpy(pk.copy()), out_dtype)
        jc, ja = JaxModel(ns).step_counters_unique_packed(jc, out_dtype, jnp.asarray(pk))
        assert torch.equal(out, want)
        np.testing.assert_array_equal(_u(out), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(state_to_numpy(ck), np.asarray(jc), err_msg=f"step {step}")
        assert torch.equal(ck, cd)
    assert (state_to_numpy(ck) == U32).any()


def _routed_words(rng, nb, spb, cap, skew):
    """int32[nb, 4, cap] routed rows: distinct live local ids a bank
    (some as their alias id - spb), all in bank 0 when `skew`, fresh and
    saturating lanes, padding ids spb + i."""
    pk = np.zeros((nb, 4, cap), np.int32)
    pk[:, 0] = spb + np.arange(cap)
    pk[:, 2] = 1
    for b in ([0] if skew else range(nb)):
        live = cap if skew else int(rng.integers(cap // 2, cap + 1))
        ids = rng.choice(spb, live, replace=False).astype(np.int64)
        ids[rng.random(live) < 0.35] -= spb
        hits = rng.integers(0, 30, live).astype(np.uint32)
        hits[: live // 4] = U32 - 1
        pk[b, 0, :live] = ids
        pk[b, 1, :live] = hits.view(np.int32)
        pk[b, 2, :live] = rng.integers(1, 200, live)
        pk[b, 3, :live] = rng.random(live) < 0.2
    return pk


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "one-bank"])
@pytest.mark.parametrize("cap", [17, 32, 512])
def test_k6_mapped_equals_device_form_and_jax(cap, skew, out_dtype):
    """sharded_routed_step_mapped over 8 banks against sharded_routed_step
    and JAX's routed step on 8 devices, and the model's mapped step."""
    rng = np.random.default_rng(cap + 2 * skew + len(out_dtype))
    nb, spb = 8, 1024
    start = _warm(rng, nb * spb).reshape(nb, spb)
    jm = JaxShardedModel(nb * spb, jax_make_mesh(nb))
    jc = jnp.asarray(start)
    ck = torch.from_numpy(start.view(np.int32).copy())
    cd, cm = ck.clone(), ck.clone()
    tm = ShardedFixedWindowModel(nb * spb, make_mesh(nb, "cpu"))
    for step in range(2):
        pk = _routed_words(rng, nb, spb, cap, skew)
        out = torch.zeros((nb, cap), dtype=fw.OUT_DTYPES[out_dtype])
        assert sh.sharded_routed_step_mapped(ck, torch.from_numpy(pk), out, out_dtype) is out
        want = sh.sharded_routed_step(cd, torch.from_numpy(pk.copy()), out_dtype)
        mout = torch.zeros_like(out)
        cm, got = tm.step_counters_unique_routed_mapped(cm, out_dtype, torch.from_numpy(pk), mout)
        jc, ja = jm.step_counters_unique_routed_packed(jc, out_dtype, pk)
        assert torch.equal(out, want) and torch.equal(got, want)
        np.testing.assert_array_equal(_u(out), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(_u(ck), np.asarray(jc), err_msg=f"step {step}")
        assert torch.equal(ck, cd) and torch.equal(cm, cd)


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("held", [1, 2, 4])
def test_k6_card_mapped_equals_card_form(held, out_dtype):
    """K6's card form mapped over 1, 2 and 4 groups of 2 banks on a card
    against its device form; the mesh entry's mapped form over 4 cards
    (the model's routed step) against the one-group step."""
    rng = np.random.default_rng(50 + held + len(out_dtype))
    k, spb, cap = 2, 512, 64
    rows = held * k
    base = torch.from_numpy(_warm(rng, rows * spb).reshape(rows, spb).view(np.int32).copy())
    pk = torch.from_numpy(_routed_words(rng, rows, spb, cap, skew=False))
    mapped = [base[h * k : (h + 1) * k].clone() for h in range(held)]
    device = [base[h * k : (h + 1) * k].clone() for h in range(held)]
    out = torch.zeros((rows, cap), dtype=fw.OUT_DTYPES[out_dtype])
    assert sh.sharded_routed_card_step_mapped(mapped, pk, out, out_dtype) is out
    assert torch.equal(out, sh.sharded_routed_card_step(device, pk.clone(), out_dtype))
    assert all(torch.equal(a, b) for a, b in zip(mapped, device))
    # Over cards: 8 banks in 4 groups on cpu:0..cpu:3 (groups 0, 2 and
    # 1, 3 on two cards: rows that are not one run of the batch).
    for devices in ([f"cpu:{i}" for i in range(4)], [f"cpu:{i % 2}" for i in range(4)]):
        tm = ShardedFixedWindowModel(8 * spb, make_mesh(8, devices=devices))
        one = ShardedFixedWindowModel(8 * spb, make_mesh(8, "cpu"))
        table = _warm(rng, 8 * spb).reshape(8, spb)
        state = tm.join([torch.from_numpy(table[2 * g : 2 * g + 2].view(np.int32).copy())
                         for g in range(4)])
        whole = torch.from_numpy(table.view(np.int32).copy())
        words = torch.from_numpy(_routed_words(rng, 8, spb, cap, skew=True))
        out = torch.zeros((8, cap), dtype=fw.OUT_DTYPES[out_dtype])
        state, got = tm.step_counters_unique_routed_mapped(state, out_dtype, words, out)
        whole, want = one.step_counters_unique_routed_packed(whole, out_dtype, words.clone())
        assert got is out and torch.equal(out, want)
        assert torch.equal(torch.cat(tm.parts(state)), whole)


# -- the engines against JAX ------------------------------------------------


def _wide_batch(rng, n, distinct, ns, out_dtype):
    """n raw lanes over `distinct` base slots (the rest duplicates of
    them; about a third as alias ids - ns, a few out of the table), fresh
    lanes, limits that pick the readback type: u8, u16 or u32."""
    base = rng.choice(ns, distinct, replace=False).astype(np.int64)
    base[rng.random(distinct) < 0.3] -= ns
    far = rng.random(distinct) < 0.03
    base[far] = 3 * ns + np.arange(int(far.sum()))
    slots = base[rng.integers(0, distinct, n)]
    slots[:distinct] = base  # every base slot at least once
    hi = {"uint8": 100, "uint16": 60_000, "": 3_000_000_000}[out_dtype]
    return dict(
        slots=slots.astype(np.int32),
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(hi // 2, hi, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.1,
    )


def _count_calls(monkeypatch, module, names):
    """Count the calls of module-level functions `names` of `module`."""
    calls = {name: 0 for name in names}
    for name in names:
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("out_dtype", DTYPES)
def test_engine_serves_wide_chunks_like_jax(monkeypatch, out_dtype):
    """CounterEngine over chunks of 129 to 4096 lanes against the JAX
    `tpu` engine: every decision field and the table equal; every chunk
    past 128 lanes one mapped launch, none in the device form."""
    ns = 8192
    je = JaxEngine(num_slots=ns, buckets=DEFAULT_BUCKETS)
    te = CounterEngine(num_slots=ns, buckets=DEFAULT_BUCKETS, device="cpu")
    calls = _count_calls(monkeypatch, fw, ["fw_unique_step_mapped", "fw_unique_step_lanes",
                                           "fw_unique_step"])
    rng = np.random.default_rng(3 + len(out_dtype))
    # (raw lanes, distinct slots): 129 distinct pad to 256, the last
    # bucket's 4096 fill it.
    widths = ((129, 129), (300, 200), (1024, 800), (4096, 4096), (2000, 1500))
    for n, distinct in widths:
        raw = _wide_batch(rng, n, distinct, ns, out_dtype)
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)), f"n={n}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts(), err_msg=f"n={n}")
    assert calls == {"fw_unique_step_mapped": len(widths), "fw_unique_step_lanes": 0,
                     "fw_unique_step": 0}


def _sharded_chunk(rng, step, nb, spb, ns):
    """A wide chunk, past 128 routed lanes on every card of the meshes
    below: uniform over the banks, or all in bank 0."""
    n = int(rng.integers(600, 1000))
    if step % 2:
        slots = (rng.choice(spb, min(n, spb), replace=False) * nb).astype(np.int32)
        n = len(slots)
    else:
        slots = rng.integers(0, ns, n).astype(np.int32)
    return dict(
        slots=slots,
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(1, 10, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.2,
    )


@pytest.mark.parametrize("placement", ["one group", "4 cards"])
@pytest.mark.parametrize("nb", [2, 4, 8])
def test_sharded_engine_serves_wide_chunks_like_jax(monkeypatch, nb, placement):
    """ShardedCounterEngine over nb banks -- one group, or min(4, nb)
    groups on as many CPU cards -- against JAX's tpu-sharded engine on nb
    virtual devices over wide chunks (uniform and all-one-bank): every
    field, the table and the per-bank lane counts; every chunk one mapped
    launch (one card: K6's; several: the mesh entry's)."""
    ns = 1024 * nb
    buckets = (8, 16, 32, 64, 128, 256, 512, 1024)
    devices = [f"cpu:{i}" for i in range(min(4, nb))]
    mesh = make_mesh(nb, "cpu") if placement == "one group" else make_mesh(nb, devices=devices)
    je = JaxShardedEngine(jax_make_mesh(nb), num_slots=ns, buckets=buckets)
    te = ShardedCounterEngine(mesh, num_slots=ns, buckets=buckets)
    calls = _count_calls(monkeypatch, sh, ["sharded_routed_step_mapped", "mesh_routed_step_mapped",
                                           "sharded_routed_step", "mesh_routed_step"])
    m = te.model
    rng = np.random.default_rng(70 + nb)
    chunks = 0
    for step in range(4):
        raw = _sharded_chunk(rng, step, m.num_banks, m.slots_per_bank, m.num_slots)
        _assert_same(je.step(JaxHostBatch(**raw)), te.step(HostBatch(**raw)), f"step {step}")
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
        assert te.stat_bank_lane_counts == je.stat_bank_lane_counts
        chunks += 1
    mapped = "sharded_routed_step_mapped" if mesh.groups == 1 else "mesh_routed_step_mapped"
    assert calls[mapped] == chunks
    assert sum(calls.values()) == chunks


# -- one call, no copy ----------------------------------------------------------


def _no_copies(monkeypatch, wrappers):
    """Record Tensor.to and Tensor.copy_ calls made outside the wrapper
    functions `wrappers` ((module, name) pairs; their plain versions copy
    on the CPU), and the calls of those wrappers with their arguments."""
    seen = dict(to=0, copy_=0, calls=[])
    inside = [0]
    for method in ("to", "copy_"):
        real = getattr(torch.Tensor, method)

        def spy(self, *args, _real=real, _m=method, **kwargs):
            if not inside[0]:
                seen[_m] += 1
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, method, spy)
    for module, name in wrappers:
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


def _hb(slots):
    n = len(slots)
    return HostBatch(slots=np.asarray(slots, np.int32), hits=np.ones(n, np.uint32),
                     limits=np.full(n, 9, np.uint32), fresh=np.zeros(n, bool),
                     shadow=np.zeros(n, bool))


def test_wide_chunk_is_one_mapped_call_on_the_staging(monkeypatch):
    """One table: a 300-lane chunk is ONE call of fw_unique_step_mapped,
    handed views of the submission's own staging (words of its packed
    buffer, readback of its readback buffer), with no Tensor.to and no
    copy_ in the engine; the answer is the plain step's."""
    te = CounterEngine(num_slots=4096, buckets=(8, 128, 512), device="cpu")
    seen = _no_copies(monkeypatch, [(fw, "fw_unique_step_mapped"), (fw, "fw_unique_step"),
                                    (fw, "fw_unique_step_lanes")])
    token = te.step_submit(_hb(np.arange(300) * 3))
    (st, readback), *_ = token[3][0]
    assert (seen["to"], seen["copy_"]) == (0, 0)
    ((name, (counts, words, out, dt)),) = seen["calls"]
    assert name == "fw_unique_step_mapped" and dt == "uint8"
    assert tuple(words.shape) == (4, 512) and words.data_ptr() == st.packed.data_ptr()
    assert out is readback and out.data_ptr() == st.readback.data_ptr()
    d = te.step_complete(token)
    np.testing.assert_array_equal(d.afters, np.ones(300))


def test_sharded_wide_chunk_is_one_mapped_call(monkeypatch):
    """One group of 8 banks: a chunk past 128 routed lanes is ONE call of
    sharded_routed_step_mapped on the staging, no Tensor.to, no copy_."""
    te = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=8192, buckets=(8, 64))
    seen = _no_copies(monkeypatch, [(sh, "sharded_routed_step_mapped"),
                                    (sh, "sharded_routed_step"),
                                    (sh, "sharded_routed_step_lanes")])
    token = te.step_submit(_hb(np.arange(60) * 8))  # all in bank 0: cap 64
    (st, readback), *_ = token[3][0]
    assert (seen["to"], seen["copy_"]) == (0, 0)
    ((name, (counts, words, out, dt)),) = seen["calls"]
    assert name == "sharded_routed_step_mapped"
    assert tuple(words.shape) == (8, 4, 64) and words.data_ptr() == st.packed.data_ptr()
    assert out is readback
    np.testing.assert_array_equal(te.step_complete(token).afters, np.ones(60))


def _recorder(monkeypatch, rc=0, failed=-1, read=None):
    """kernels.function as a recorder of (entry, args, read(args)) whose
    entries return `rc`, writing `failed` into a mesh entry's last
    argument."""
    calls = []

    def function(name):
        def call(*args):
            calls.append((name, args, read(args) if read else None))
            if name.startswith("rl_mesh_"):
                args[-1]._obj.value = failed
            return rc

        return call

    monkeypatch.setattr(kernels, "function", function)
    return calls


def _read(address, ctype, n):
    return list((ctype * n).from_address(address))


def test_wide_chunk_over_four_cards_is_one_ctypes_call(monkeypatch):
    """A grouped engine over 4 CPU cards (its mesh call taken down the
    card's path, kernels.function faked): a chunk past 128 lanes a card
    is ONE ctypes call of rl_mesh_routed_step_mapped carrying each card's
    device, stream, tables, staged words and staged readback, counted as
    one K6 card launch mapped a card, and the engine makes no Tensor.to
    and no copy_."""
    calls = _recorder(monkeypatch, read=lambda a: (
        _read(a[1], ctypes.c_int, 4), _read(a[2], ctypes.c_void_p, 4),
        _read(a[3], ctypes.c_void_p, 4), _read(a[7], ctypes.c_void_p, 4),
        _read(a[9], ctypes.c_void_p, 4)))
    mesh = make_mesh(8, devices=[f"cpu:{i}" for i in range(4)])
    engine = ShardedCounterEngine(mesh, num_slots=8192, buckets=(8, 256))
    engine._cards = mesh.card_groups([SimpleNamespace(cuda_stream=201 + c) for c in range(4)])
    real = sh.mesh_routed_step_mapped

    def on_card(parts, cards, words, outs, out_dtype="", events=None):
        return sh.launch_mesh_routed_mapped(parts, cards, words, outs, out_dtype,
                                            words[0].shape[-1], events)

    monkeypatch.setattr(sh, "mesh_routed_step_mapped", on_card)
    seen = _no_copies(monkeypatch, [])
    before, mesh0 = kernels.launches[sh.K6_CARD_MAPPED], kernels.mesh_calls[sh.MESH_ROUTED_MAPPED]
    token = engine.step_submit(_hb(np.arange(150) * 8))  # bank 0: cap 256
    ((name, args, (devices, streams, tables, words, outs)),) = calls
    assert name == sh.MESH_ROUTED_MAPPED and len(args) == len(kernels.SIGNATURES[name][1])
    assert args[0] == 4 and devices == [0, 1, 2, 3] and streams == [201, 202, 203, 204]
    parts = engine.model.parts(engine._counts)
    assert tables == [p.data_ptr() for p in parts]
    handle = token[3][0][0]
    assert words == [st.packed.data_ptr() for st, _ in handle]
    assert outs == [rb.data_ptr() for _, rb in handle]
    assert args[5:7] == (2, 8192 // 8) and args[8] == 256
    assert kernels.launches[sh.K6_CARD_MAPPED] == before + 4
    assert kernels.mesh_calls[sh.MESH_ROUTED_MAPPED] == mesh0 + 1
    assert (seen["to"], seen["copy_"]) == (0, 0)
    assert real is not on_card


def test_a_failed_mapped_card_names_itself(monkeypatch):
    """The mapped mesh entry's error (pageable staging answers
    cudaErrorInvalidValue, 1) raises KernelError naming the card, counting
    the launches of the cards before it only: nothing falls back."""
    _recorder(monkeypatch, rc=1, failed=1)
    mesh = make_mesh(8, devices=[f"cpu:{i}" for i in range(4)])
    plan = mesh.card_groups([SimpleNamespace(cuda_stream=1) for _ in range(4)])
    parts = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(4)]
    words = [torch.zeros((2, 4, 256), dtype=torch.int32) for _ in range(4)]
    outs = [torch.zeros((2, 256), dtype=torch.int32) for _ in range(4)]
    before = kernels.launches[sh.K6_CARD_MAPPED]
    with pytest.raises(kernels.KernelError, match=r"on card 1 \(cpu\)") as err:
        sh.launch_mesh_routed_mapped(parts, plan, words, outs, "", 256)
    assert err.value.code == 1
    assert kernels.launches[sh.K6_CARD_MAPPED] == before + 1


# -- refusals ----------------------------------------------------------------


def test_mapped_wrappers_refuse_what_the_kernel_does_not_take():
    counts = torch.zeros(64, dtype=torch.int32)
    words = torch.zeros((4, 256), dtype=torch.int32)
    out = torch.zeros(256, dtype=torch.int32)
    # Any width: 256 lanes are past the by-value budget, not the mapped one.
    assert fw.fw_unique_step_mapped(counts, words, out) is out
    with pytest.raises(ValueError, match="device form"):
        fw.fw_unique_step_lanes(counts, words, out)
    with pytest.raises(TypeError, match="out must be"):
        fw.fw_unique_step_mapped(counts, words, out, "uint8")
    with pytest.raises(TypeError, match="words must be"):
        fw.fw_unique_step_mapped(counts, torch.zeros((3, 256), dtype=torch.int32), out)
    with pytest.raises(TypeError, match=r"words must be int32\[4, N\]"):
        fw.fw_unique_step_mapped(counts, torch.zeros((2, 4, 256), dtype=torch.int32),
                                 torch.zeros((2, 256), dtype=torch.int32))
    # The kernel reads the words and writes the readback in host memory:
    # tensors on a device are refused, and so are strided ones.
    with pytest.raises(ValueError, match="words must be a contiguous host tensor"):
        fw.fw_unique_step_mapped(counts, words.to("meta"), out)
    with pytest.raises(ValueError, match="words must be a contiguous host tensor"):
        fw.fw_unique_step_mapped(counts, torch.zeros((4, 512), dtype=torch.int32)[:, ::2], out)
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        fw.fw_unique_step_mapped(counts, words, out.to("meta"))
    # No fallback: a table on a device without a kernel is refused.
    with pytest.raises(ValueError, match="unsupported device"):
        fw.fw_unique_step_mapped(counts.to("meta"), words, out)
    banked = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="words must be"):
        sh.sharded_routed_step_mapped(banked, torch.zeros((4, 4, 32), dtype=torch.int32),
                                      torch.zeros((4, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be a contiguous host tensor"):
        sh.sharded_routed_step_mapped(banked, torch.zeros((8, 4, 32), dtype=torch.int32),
                                      torch.zeros((8, 32), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sh.sharded_routed_step_mapped(banked.to("meta"), torch.zeros((8, 4, 32), dtype=torch.int32),
                                      torch.zeros((8, 32), dtype=torch.int32))
    tables = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(2)]
    with pytest.raises(TypeError, match=r"int32\[4, 4, cap\]"):
        sh.sharded_routed_card_step_mapped(tables, torch.zeros((2, 4, 32), dtype=torch.int32),
                                           torch.zeros((2, 32), dtype=torch.int32))
    plan = make_mesh(8, devices=[f"cpu:{i}" for i in range(4)]).card_groups()
    parts = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError, match="one cap"):
        sh.mesh_routed_step_mapped(
            parts, plan, [torch.zeros((2, 4, 32 + 32 * (c == 3)), dtype=torch.int32)
                          for c in range(4)],
            [torch.zeros((2, 32 + 32 * (c == 3)), dtype=torch.int32) for c in range(4)])


# -- the C entries ----------------------------------------------------------------

_CTYPE = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_longlong, "int32_t": ctypes.c_int,
          "float": ctypes.c_float}
MAPPED_ENTRIES = {
    "rl_fw_unique_step_mapped": "rl_fw_unique_step_lanes",
    "rl_sharded_routed_step_mapped": "rl_sharded_routed_step_lanes",
    "rl_sharded_routed_card_step_mapped": "rl_sharded_routed_card_step_lanes",
    "rl_mesh_routed_step_mapped": "rl_mesh_routed_step_lanes",
    "rl_mesh_routed_step": "rl_mesh_routed_step_lanes",
}


def test_signatures_match_the_extern_c_sources_both_ways():
    """Every extern "C" entry of csrc/*.cu has a SIGNATURES row and every
    row an entry; each mapped entry's (and the device-form mesh entry's,
    now without host copies) parameters read as its ctypes argtypes, the
    same as its by-value twin's."""
    model = parse_sources([str(p) for p in sorted(CSRC.glob("*.cu"))])
    assert set(model.functions) == set(kernels.SIGNATURES)
    for entry, twin in MAPPED_ENTRIES.items():
        params = [_CTYPE[p.ctype.describe()] for p in model.functions[entry].params]
        assert params == kernels.SIGNATURES[entry][1], entry
        assert kernels.SIGNATURES[entry][1] == kernels.SIGNATURES[twin][1], entry
        assert kernels.SIGNATURES[entry][0] == kernels.SIGNATURES[twin][0]
    names = [p.name for p in model.functions["rl_mesh_routed_step"].params]
    assert "uploads" not in names and "readbacks" not in names
