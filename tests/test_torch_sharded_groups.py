"""Banks in groups: the port's sharded table over several group tensors
against the JAX package's mesh of the same number of banks, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, one bank per
device; the port places the same banks in G groups of the CPU
(``make_mesh(nb, devices=("cpu",) * G)``), for every G that divides
nb, where every kernel wrapper takes its plain version -- K7 once over
the groups of the one device (the card step), and the combine that
stands in for the psum where a card cannot map the home card.  The
same numpy-seeded inputs go through both and every answer, readback and
the (num_banks, slots_per_bank) table in global bank order must be
equal (tolerance 0): duplicates, fresh and shadow lanes, skew onto one
bank, ids past the table and negative ids, in all three readback
types.  Then the engine over groups, the plain card step into the home
output and the combine cards' partials, and the combine, against the
one-group plain step, and the launch's device rules.
"""

import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxDeviceBatch
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.backends.engine import HostBatch
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models.fixed_window import DeviceBatch, state_to_numpy
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, ShardedFixedWindowModel, make_mesh
from ratelimit_tpu_torch.parallel import sharded as sh

NUM_SLOTS = 64
U32 = 0xFFFFFFFF
FIELDS = fw.DeviceDecisions._fields
_HOST = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8, torch.bool: np.bool_}
#: (banks, groups) for every group count that divides the banks.
SPLITS = [(nb, g) for nb in (2, 4, 8) for g in (1, 2, 4, 8) if nb % g == 0]


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_HOST[t.dtype])


def _groups(nb, g):
    return make_mesh(nb, devices=("cpu",) * g)


def _table(model, counts) -> np.ndarray:
    """A port state as the JAX (num_banks, slots_per_bank) table."""
    return np.concatenate([state_to_numpy(p) for p in model.parts(counts)])


def _raw_batch(rng, step, nb, n=32, ns=NUM_SLOTS):
    """Odd steps: every lane in bank 0 (one group) with heavy duplicates;
    even steps: duplicates, ids past the table and negative ids down to
    -ns - 4.  Fresh and shadow lanes on both."""
    if step % 2:
        slots = (rng.integers(0, max(ns // nb // 2, 2), n) * nb).astype(np.int32)
    else:
        slots = rng.integers(-ns - 4, ns + 6, size=n).astype(np.int32)
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


# -- the model -----------------------------------------------------------


@pytest.mark.parametrize("nb,g", SPLITS, ids=[f"{nb}banks-{g}groups" for nb, g in SPLITS])
@pytest.mark.parametrize("variant", ["step", "step_counters", "uint8", "uint16"])
def test_grouped_model_matches_jax(nb, g, variant):
    """Six batches through JAX's mesh of nb devices and the port's nb
    banks in g groups: step's nine decision fields, step_counters'
    afters or step_counters_compact's narrow readback, and the table."""
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(nb))
    tm = ShardedFixedWindowModel(NUM_SLOTS, _groups(nb, g))
    assert (tm.num_banks, tm.groups, tm.banks_per_group) == (nb, g, nb // g)
    jc, tc = jm.init_state(), tm.init_state()
    assert len(tm.parts(tc)) == g
    assert all(tuple(p.shape) == (nb // g, NUM_SLOTS // nb) for p in tm.parts(tc))
    rng = np.random.default_rng(100 + 10 * nb + g)
    for step in range(6):
        raw = _raw_batch(rng, step, nb)
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
        np.testing.assert_array_equal(_table(tm, tc), np.asarray(jc), err_msg=f"step {step}")


def _routed_raw(rng, nb, spb, cap, table):
    """int32[nb, 4, cap] routed rows: distinct live local ids per bank
    (some as their alias id - spb), fresh and saturating lanes, padding
    ids spb + i."""
    pk = np.zeros((nb, 4, cap), np.int32)
    pk[:, 0] = spb + np.arange(cap)
    pk[:, 2] = 1
    for b in range(nb):
        live = int(rng.integers(0, min(cap, spb) + 1))
        ids = rng.choice(spb, live, replace=False).astype(np.int64)
        ids[rng.random(live) < 0.35] -= spb
        hits = rng.integers(0, 40, live).astype(np.uint32)
        hot = table[b, ids % spb] > U32 - 64
        hits[hot] = rng.integers(60, 200, int(hot.sum()))
        pk[b, 0, :live] = ids
        pk[b, 1, :live] = hits.view(np.int32)
        pk[b, 2, :live] = rng.integers(1, 300, live).astype(np.uint32).view(np.int32)
        pk[b, 3, :live] = rng.random(live) < 0.2
    return pk


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("form", ["packed", "lanes", "unpacked"])
@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
def test_grouped_routed_step_matches_jax(g, form, out_dtype):
    """The routed serving step (K6, one launch a group on the group's
    rows) over 8 banks in g groups against the JAX routed step: the
    device form, the by-value form (host words, host readback) and the
    unpacked batch, all three readback types."""
    nb = 8
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(nb))
    tm = ShardedFixedWindowModel(NUM_SLOTS, _groups(nb, g))
    spb, k = tm.slots_per_bank, nb // g
    rng = np.random.default_rng(11 + g)
    table = rng.integers(0, 300, (nb, spb)).astype(np.uint32)
    table[rng.random((nb, spb)) < 0.2] = U32 - 10
    jc = jnp.asarray(table)
    tc = tuple(
        torch.from_numpy(table[i * k : (i + 1) * k].view(np.int32).copy()) for i in range(g)
    )
    for step, cap in enumerate((8, 16, 8, 4)):
        pk = _routed_raw(rng, nb, spb, cap, _table(tm, tc))
        jc, ja = jm.step_counters_unique_routed_packed(jc, out_dtype, pk)
        if form == "packed":
            tc, ta = tm.step_counters_unique_routed_packed(tc, out_dtype, torch.from_numpy(pk))
        elif form == "lanes":
            out = torch.empty((nb, cap), dtype=fw.OUT_DTYPES[out_dtype])
            tc, ta = tm.step_counters_unique_routed_lanes(tc, out_dtype, torch.from_numpy(pk), out)
            assert ta is out
        else:
            tb = DeviceBatch(
                *(torch.from_numpy(pk[:, r].copy()) for r in range(3)),
                fresh=torch.from_numpy(pk[:, 3] != 0),
                shadow=torch.zeros((nb, cap), dtype=torch.bool),
            )
            tc, ta = tm.step_counters_unique_routed(tc, out_dtype, tb)
        assert tuple(ta.shape) == (nb, cap)
        np.testing.assert_array_equal(_u(ta), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(_table(tm, tc), np.asarray(jc), err_msg=f"step {step}")


# -- the plain card step into rows, and the combine ------------------------


#: Where the groups' lanes go on the combine path: each group a card of
#: its own, group 0 the home card and every other a combine card with a
#: partial; or the even groups in place (home or peer cards) and the odd
#: ones on combine cards.
COMBINE_SPLITS = {
    "every group a card": lambda g: [(i,) for i in range(g)],
    "odd groups combine": lambda g: [tuple(range(0, g, 2))] + [(i,) for i in range(1, g, 2)],
}


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("layout", ["", "uint8", "uint16", "decide"])
def test_plain_group_form_and_combine_equal_one_group(g, layout):
    """The plain card step on the groups of each card: the in-place
    cards' owned lanes into one zeroed home output, each combine card's
    into one zeroed partial of its own, then the plain
    combine, equals the one-group plain step on one table of the same
    banks, lane for lane and table for table; no buffer holds anything
    off its card's lanes, so the combine (a select) also equals the
    bytewise sum of the output and the partials, JAX's psum."""
    nb, spb = 8, NUM_SLOTS // 8
    rng = np.random.default_rng(40 + g)
    base = rng.integers(0, 2**32, (nb, spb), dtype=np.uint64).astype(np.uint32)
    for split, sets in COMBINE_SPLITS.items():
        one = torch.from_numpy(base.view(np.int32).copy())
        k = nb // g
        parts = [one[i * k : (i + 1) * k].clone() for i in range(g)]
        cards = [(groups, "home" if c == 0 else "combine") for c, groups in enumerate(sets(g))]
        sources = sh._combine_sources(cards)
        for step in range(4):
            b = _port_batch(_raw_batch(rng, step, nb, n=40))
            n = b.slots.shape[0]
            decide = layout == "decide"
            if decide:
                afters = sh._general_update_plain(one, b.slots, b.hits, b.fresh, None, "")
                want = fw._decision_block_plain(afters, b.hits, b.limits, b.shadow, 0.8)
            else:
                want = sh._general_update_plain(one, b.slots, b.hits, b.fresh, b.limits, layout)
            size = sh.partial_bytes(layout, n)
            out = torch.zeros(size, dtype=torch.uint8)
            partials = torch.zeros((len(cards) - 1, -(-size // 16) * 16), dtype=torch.uint8)
            for c, (groups, _) in enumerate(cards):
                sh.sharded_card_step(
                    parts, groups, nb, b.slots, b.hits, b.fresh, b.limits, layout, b.shadow,
                    0.8, out if c == 0 else partials[c - 1],
                )
            summed = torch.cat([out[None], partials[:, :size]]).sum(0, dtype=torch.uint8)
            assert sh.sharded_combine(out, partials, sources, b.slots, nb, spb, layout) is out
            got = sh.unpack_partial(out, layout, n)
            assert torch.equal(out, summed), f"{split} step {step}: a lane is off its owner"
            if decide:
                for f in FIELDS:
                    assert torch.equal(getattr(got, f), getattr(want, f)), (split, step, f)
            else:
                assert torch.equal(got, want), (split, step)
            assert torch.equal(torch.cat(parts), one), (split, step)


def test_combine_takes_out_of_table_lanes_from_bank_zeros_group():
    """An id past the table or negative belongs to the group of bank 0,
    which the home card holds, so its lane stays in the home output; an
    in-table id takes its bank's group's place: the output for group 0,
    partial c - 1 for a group on the c-th combine card."""
    nb, spb, g = 8, 4, 4
    slots = torch.tensor([-1, 32, 0, 1, 2, 3, 4, 5, 6, 7, 31, -2**31, 2**31 - 1],
                         dtype=torch.int32)
    n = slots.shape[0]
    out = torch.full((n,), 1, dtype=torch.int32)
    partials = torch.arange(2, g + 1, dtype=torch.int32).repeat_interleave(n).view(g - 1, n)
    got = sh.sharded_combine(out.view(torch.uint8), partials.view(torch.uint8), [0, 1, 2, 3],
                             slots, nb, spb, "")
    # group + 1; 31 % 8 = 7 -> group 3; the int32 extremes are out of the table.
    owner = [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4, 1, 1]
    assert sh.unpack_partial(got, "", n).tolist() == owner


# -- the engine ----------------------------------------------------------


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
    n = 8
    return dict(
        slots=np.concatenate([np.arange(ns, ns + n), rng.integers(0, ns, n)]).astype(np.int32),
        hits=np.concatenate([np.zeros(n), rng.integers(1, 4, n)]).astype(np.uint32),
        limits=np.array([100, 60_000, 3_000_000_000, 7] * 4, np.uint32),
        fresh=np.zeros(2 * n, bool),
        shadow=np.zeros(2 * n, bool),
    )


def _grouped_engine(g, nb=8, num_slots=NUM_SLOTS, buckets=(8, 32)):
    return ShardedCounterEngine(_groups(nb, g), num_slots=num_slots, buckets=buckets)


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("case", [_uniform, _skewed, _probes], ids=["uniform", "skew", "probes"])
def test_grouped_engine_matches_jax(g, case):
    """The routed serving engine over 8 banks in g groups (one K6 a
    group a chunk, the readback after every group's) against the JAX
    sharded engine: every decision field, export_counts() in global
    order and the per-bank lane counts."""
    je = JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=(8, 32))
    te = _grouped_engine(g)
    m = te.model
    rng = np.random.default_rng(21 + g)
    for step in range(5):
        raw = case(rng, step, m.num_banks, m.slots_per_bank, m.num_slots)
        dj = je.step(JaxHostBatch(**raw))
        dt = te.step(HostBatch(**raw))
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(dt, f)).astype(np.int64),
                np.asarray(getattr(dj, f)).astype(np.int64),
                err_msg=f"step {step} {f}",
            )
        np.testing.assert_array_equal(te.export_counts(), je.export_counts())
        assert te.stat_bank_lane_counts == je.stat_bank_lane_counts
    assert te.stat_window_rollovers == je.stat_window_rollovers


def test_grouped_engine_submits_one_staging_a_group():
    """A chunk over 4 groups on one card is ONE handle of one staging,
    the card's, from the card's own pool: int32[8, 4, cap], the rows of
    every bank the card holds (2 a group), on the card's one stream;
    after the wait it goes back to that pool."""
    te = _grouped_engine(4, num_slots=1 << 10, buckets=(8, 32, 128, 256))
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
    handle = token[3][0][0]
    assert isinstance(handle, list) and len(handle) == 1
    ((st, rb),) = handle
    assert rb.shape[0] == 8 and rb.shape[1] < n
    assert te._staging_size()[0] == 8 * 4 * 128
    assert len(te._card_streams()) == 1 and te._more_staging == ()
    np.testing.assert_array_equal(te.step_complete(token).afters, np.ones(n))
    assert list(te._pool(0)) == [st]


def test_counts_cross_between_group_counts_and_jax():
    """export_counts / import_counts in global order: a JAX engine's
    table into 1 and 4 groups, 4 groups into 1 and back into JAX, and
    the same batch then answers alike everywhere; read_slots and
    write_slots address global slots over the groups."""
    je = JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=(8, 32))
    one, four = _grouped_engine(1), _grouped_engine(4)
    rng = np.random.default_rng(5)
    m = four.model
    for _ in range(2):
        je.step(JaxHostBatch(**_uniform(rng, 0, m.num_banks, m.slots_per_bank, m.num_slots)))
    for e in (one, four):
        e.import_counts(je.export_counts())
        np.testing.assert_array_equal(e.export_counts(), je.export_counts())
    np.testing.assert_array_equal(_table(m, four._counts), np.asarray(je._counts))
    raw = _skewed(rng, 1, m.num_banks, m.slots_per_bank, m.num_slots)
    dj = je.step(JaxHostBatch(**raw))
    for e in (one, four):
        np.testing.assert_array_equal(e.step(HostBatch(**raw)).afters, np.asarray(dj.afters))
    one.import_counts(four.export_counts())
    je2 = JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=(8, 32))
    je2.import_counts(four.export_counts())
    np.testing.assert_array_equal(je2.export_counts(), je.export_counts())
    np.testing.assert_array_equal(one.export_counts(), je.export_counts())
    slots = rng.choice(NUM_SLOTS, 20, replace=False)
    np.testing.assert_array_equal(four.read_slots(slots)["counts"], je.export_counts()[slots])
    four.write_slots(slots, {"counts": np.arange(20, dtype=np.uint32) + U32 - 9})
    want = je.export_counts().copy()
    want[slots] = np.arange(20, dtype=np.uint32) + U32 - 9
    np.testing.assert_array_equal(four.export_counts(), want)
    with pytest.raises(ValueError):
        four.import_counts(np.zeros(10, np.uint32))


# -- the launch's device rules ------------------------------------------


def test_one_launch_lies_on_one_device(monkeypatch):
    """kernels.launch runs its ctypes call under the one device of the
    launch's tensors (torch.cuda.device of it), and a launch whose
    tensors lie on two devices raises ValueError before any call."""
    entered, calls = [], []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append("exit")

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(kernels, "function", lambda name: lambda *a: calls.append((name, a)) or 0)
    on = [SimpleNamespace(device=torch.device("cuda", 1))] * 2
    before = kernels.launches["k"]
    kernels.launch("rl_x", "k", on, 1, 2)
    assert entered == [torch.device("cuda", 1), "exit"]
    assert calls == [("rl_x", (1, 2))] and kernels.launches["k"] == before + 1
    assert kernels.device_of(*on) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one device"):
        kernels.launch("rl_x", "k", [on[0], SimpleNamespace(device=torch.device("cuda", 0))])
    assert len(calls) == 1 and kernels.launches["k"] == before + 1
    # The CPU needs no current device.
    kernels.launch("rl_x", "k", [SimpleNamespace(device=torch.device("cpu"))])
    assert entered == [torch.device("cuda", 1), "exit"]


def test_wrappers_refuse_tensors_on_two_devices():
    """The card step and the combine never mix devices: the lanes on
    another device than the card's tables, the card's tables on two
    devices, or the ids on another device than the rows, raise
    ValueError."""
    tables = [torch.zeros((2, 4), dtype=torch.int32)] * 2
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    lanes = torch.zeros(8, dtype=torch.int32)
    fresh = torch.zeros(8, dtype=torch.bool)
    out = torch.zeros(32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="expected cpu"):
        sh.sharded_card_step(tables, (0,), 4, meta, lanes, fresh, None, "", None, 0.0, out)
    with pytest.raises(ValueError, match="one device"):
        sh.sharded_card_step([tables[0], tables[1].to("meta")], (0, 1), 4, lanes, lanes, fresh,
                             None, "", None, 0.0, out)
    partials = torch.zeros((1, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one device"):
        sh.sharded_combine(out, partials, [0, 1], meta, 4, 4, "")
    with pytest.raises(ValueError, match="are not groups of"):
        sh.sharded_card_step(tables, (2,), 4, lanes, lanes, fresh, None, "", None, 0.0, out)
    with pytest.raises(ValueError, match="do not hold"):
        sh.sharded_combine(out, torch.zeros((1, 28), dtype=torch.uint8), [0, 1], lanes, 4, 4, "")
    for sources in ([1, 0], [0, 2], [0, 1, 1]):
        with pytest.raises(ValueError, match="do not place"):
            sh.sharded_combine(out, partials, sources, lanes, 4, 4, "")


def _fake_card(monkeypatch):
    calls = []

    def function(name):
        def call(*args):
            calls.append((name, args))
            return 0

        return call

    monkeypatch.setattr(kernels, "function", function)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(fw, "_require_cuda", lambda device: None)
    return calls


@pytest.mark.parametrize("layout", ["", "uint8", "uint16", "decide"])
def test_group_form_and_combine_are_one_ctypes_call_each(monkeypatch, layout):
    """A CPU tensor taken for a card's: K7 over the groups a card holds
    is one call of rl_sharded_card_step carrying the mesh's table
    pointers (null for a group elsewhere), the output and
    set_local_cache's offset, counted under its epilogue's name; the
    combine one call of rl_sharded_combine on the home output and the
    partials, with the group -> source table and the layout's rows; the
    argument counts are those of SIGNATURES."""
    calls = _fake_card(monkeypatch)
    n, nb = 40, 8
    b = _port_batch(_raw_batch(np.random.default_rng(n), 0, nb, n=n))
    tables = [torch.zeros((2, NUM_SLOTS // nb), dtype=torch.int32) for _ in range(4)]
    before = dict(kernels.launches)
    out = torch.zeros(4 * 48 * n, dtype=torch.uint8)
    seen = []
    monkeypatch.setattr(
        kernels, "function",
        lambda name: lambda *a: calls.append((name, a)) or seen.append(
            list((ctypes.c_void_p * 4).from_address(a[0])) if name == "rl_sharded_card_step"
            else list((ctypes.c_int * 4).from_address(a[4]))) or 0,
    )
    got = sh.launch_card_step(
        tables, (1, 3), nb, b.slots, b.hits, b.fresh, b.limits, layout, b.shadow, 0.5, out,
    )
    (name, args), = calls
    assert name == "rl_sharded_card_step" and got is out
    assert len(args) == len(kernels.SIGNATURES[name][1])
    assert seen[0] == [None, tables[1].data_ptr(), None, tables[3].data_ptr()]
    assert args[1:4] == (4, nb, NUM_SLOTS // nb)
    assert args[-3:-1] == ({"": 0, "uint8": 1, "uint16": 2, "decide": 3}[layout], n)
    assert args[12] == out.data_ptr()  # out
    assert args[13] == (out.data_ptr() + 32 * n if layout == "decide" else None)  # set_lc
    kernel = sh.K7_CARD_STEP if layout == "decide" else sh.K7_CARD
    assert kernels.launches[kernel] == before.get(kernel, 0) + 1
    home = torch.zeros(sh.partial_bytes(layout, n), dtype=torch.uint8)
    partials = torch.zeros((2, 48 * n), dtype=torch.uint8)
    got = sh.launch_combine(home, partials, [0, 2, 0, 1], b.slots, nb, NUM_SLOTS // nb, layout)
    name, args = calls[1]
    assert name == "rl_sharded_combine" and got is home
    assert len(args) == len(kernels.SIGNATURES[name][1])
    assert args[:4] == (home.data_ptr(), partials.data_ptr(), 48 * n, 2)
    assert seen[1] == [0, 2, 0, 1] and args[5] == 4  # the group -> source table
    assert args[6:9] == (b.slots.data_ptr(), nb, NUM_SLOTS // nb)
    assert args[9:13] == (*sh.LAYOUTS[layout], n)
    assert kernels.launches[sh.COMBINE] == before.get(sh.COMBINE, 0) + 1
