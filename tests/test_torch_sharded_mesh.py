"""The mesh's one dispatch: K6's card form (one launch over every group a
card holds) and the mesh entries that enqueue every card's work in one
host call, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port
holds the same banks in groups over "cards" of the CPU (``cpu:0``,
``cpu:1``, ... are distinct devices of one memory, so a mesh over them
has several cards, each holding its groups round robin as
``chip_smoke.py``'s ``group_mesh`` places them), where every wrapper
takes its plain version.  The same numpy-seeded inputs go through both
and every readback and table must be equal (tolerance 0).  Then the
engine over cards against JAX's ``tpu-sharded`` engine, the per-card
plan, and -- with ``kernels.function`` replaced by a recorder, a CPU
tensor taken for a card's -- that a served chunk and a forward step
over 4 cards are ONE ctypes call each, counted as one launch a card,
and that a failed card's error names it.
"""

import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.backends.engine import HostBatch as JaxHostBatch
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.backends import engine as engine_mod
from ratelimit_tpu_torch.backends.engine import HostBatch
from ratelimit_tpu_torch.backends.fault_domain import _device_lost, kernel_defect
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models.fixed_window import state_to_numpy
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, ShardedFixedWindowModel, make_mesh
from ratelimit_tpu_torch.parallel import sharded as sh

NUM_SLOTS = 64
U32 = 0xFFFFFFFF
FIELDS = fw.DeviceDecisions._fields
_HOST = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8}
#: (banks of the JAX mesh, groups on a card): the port's banks in
#: min(4, banks) groups, round robin over groups / held cards.
CARD_SPLITS = [(nb, h) for nb in (2, 4, 8) for h in (1, 2, 4) if h <= min(4, nb)]


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_HOST[t.dtype])


def _card_mesh(nb, held):
    """nb banks in min(4, nb) groups, round robin over the cards
    cpu:0, cpu:1, ... so that each card holds `held` groups."""
    groups = min(4, nb)
    cards = groups // held
    return make_mesh(nb, devices=[f"cpu:{g % cards}" for g in range(groups)])


def _table(model, counts) -> np.ndarray:
    return np.concatenate([state_to_numpy(p) for p in model.parts(counts)])


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


def _seeded(rng, nb, spb):
    table = rng.integers(0, 300, (nb, spb)).astype(np.uint32)
    table[rng.random((nb, spb)) < 0.2] = U32 - 10
    return table


# -- K6's card form against JAX's routed step -----------------------------


@pytest.mark.parametrize("nb,held", CARD_SPLITS,
                         ids=[f"{nb}banks-{h}held" for nb, h in CARD_SPLITS])
@pytest.mark.parametrize("form", ["packed", "lanes", "cards"])
@pytest.mark.parametrize("out_dtype", ["", "uint8", "uint16"])
def test_card_form_matches_jax_routed_step(nb, held, form, out_dtype):
    """The routed serving step over nb banks in groups, `held` groups a
    card, against JAX's step_counters_unique_routed_packed on a mesh of
    nb devices: through the model (one mesh call over the cards: the
    device form, "packed", and by value, "lanes"), and through K6's card
    form on each card's rows ("cards": sharded_routed_card_step and its
    by-value form in turn, each card's plain version), readback and table
    equal at every step."""
    jm = JaxShardedModel(NUM_SLOTS, jax_make_mesh(nb))
    tm = ShardedFixedWindowModel(NUM_SLOTS, _card_mesh(nb, held))
    plan = tm.mesh.card_groups()
    assert all(len(c.groups) == held for c in plan)
    spb, k = tm.slots_per_bank, tm.banks_per_group
    rng = np.random.default_rng(100 * nb + 10 * held + len(out_dtype))
    table = _seeded(rng, nb, spb)
    jc = jnp.asarray(table)
    tc = tm.join([torch.from_numpy(table[g * k : (g + 1) * k].view(np.int32).copy())
                  for g in range(tm.groups)])
    for step, cap in enumerate((8, 16, 4, 8)):
        pk = _routed_raw(rng, nb, spb, cap, _table(tm, tc))
        jc, ja = jm.step_counters_unique_routed_packed(jc, out_dtype, pk)
        out = torch.empty((nb, cap), dtype=fw.OUT_DTYPES[out_dtype])
        if form == "packed":
            tc, ta = tm.step_counters_unique_routed_packed(tc, out_dtype, torch.from_numpy(pk))
        elif form == "lanes":
            tc, ta = tm.step_counters_unique_routed_lanes(tc, out_dtype, torch.from_numpy(pk), out)
            assert ta is out
        else:
            parts = tm.parts(tc)
            for c, card in enumerate(plan):
                tables = [parts[g] for g in card.groups]
                rows = torch.from_numpy(pk[list(card.rows)].copy())
                got = (sh.sharded_routed_card_step(tables, rows, out_dtype) if c % 2 == 0 else
                       sh.sharded_routed_card_step_lanes(
                           tables, rows, torch.empty((len(card.rows), cap),
                                                     dtype=fw.OUT_DTYPES[out_dtype]), out_dtype))
                out[list(card.rows)] = got
            ta = out
        assert tuple(ta.shape) == (nb, cap)
        np.testing.assert_array_equal(_u(ta), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_array_equal(_table(tm, tc), np.asarray(jc), err_msg=f"step {step}")


def test_card_form_is_the_routed_step_on_each_group():
    """The plain card form is _routed_step_plain on each group it holds,
    over that group's rows, and the wrappers refuse tables unalike, a
    batch of another number of rows, or tables on two devices."""
    rng = np.random.default_rng(7)
    k, spb, cap = 2, 8, 8
    groups = [torch.from_numpy(_seeded(rng, k, spb).view(np.int32).copy()) for _ in range(3)]
    pk = torch.from_numpy(_routed_raw(rng, 3 * k, spb, cap, np.zeros((3 * k, spb), np.uint32)))
    alone = [g.clone() for g in groups]
    want = torch.cat([sh._routed_step_plain(t, pk[h * k : (h + 1) * k], "uint16")
                      for h, t in enumerate(alone)])
    got = sh.sharded_routed_card_step(groups, pk, "uint16")
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(groups, alone))
    with pytest.raises(ValueError, match="alike"):
        sh.sharded_routed_card_step([groups[0], torch.zeros((k, 4), dtype=torch.int32)], pk[:4])
    with pytest.raises(TypeError, match=r"int32\[4, 4, cap\]"):
        sh.sharded_routed_card_step(groups[:2], pk)
    with pytest.raises(ValueError, match="one device"):
        sh.sharded_routed_card_step([groups[0], groups[1].to("meta")], pk[:4])
    with pytest.raises(ValueError, match="out_dtype"):
        sh.sharded_routed_card_step(groups, pk, "uint32")


# -- the engine over cards -------------------------------------------------


def _chunk(rng, step, nb, spb, ns):
    """A seeded chunk: uniform, all in bank 0, or crossing max_batch."""
    n = int(rng.integers(1, 70))
    if step % 3 == 1:
        slots = (rng.integers(0, max(spb // 2, 2), n) * nb).astype(np.int32)
    else:
        slots = rng.integers(0, ns, n).astype(np.int32)
    return dict(
        slots=slots,
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(1, 10, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=rng.random(n) < 0.3,
    )


MESHES = {
    "4 groups on one card": lambda: make_mesh(8, devices=("cpu",) * 4),
    "4 cards": lambda: make_mesh(8, devices=[f"cpu:{i}" for i in range(4)]),
    "8 groups round robin over 4 cards": lambda: make_mesh(
        8, devices=[f"cpu:{i % 4}" for i in range(8)]),
}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("buckets", [(8, 32), (8, 16, 32, 64, 128)], ids=["narrow", "wide"])
def test_engine_over_cards_matches_jax(mesh, buckets):
    """The routed serving engine over 8 banks in groups (one staging and
    one K6 card launch a card a chunk, every card in one mesh call)
    against JAX's sharded engine (tpu-sharded) over a seeded chunk stream
    -- chunks by value and, with wide buckets, in the mapped form: every
    decision field, export_counts() in global order and the per-bank lane
    counts."""
    je = JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=buckets)
    te = ShardedCounterEngine(MESHES[mesh](), num_slots=NUM_SLOTS, buckets=buckets)
    m = te.model
    rng = np.random.default_rng(31 + len(buckets))
    for step in range(8):
        raw = _chunk(rng, step, m.num_banks, m.slots_per_bank, m.num_slots)
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


def test_card_groups_yields_the_per_card_plan():
    """Mesh.card_groups gives each card's plan, the home card first: its
    groups, link, bank rows (its groups' banks in order: the rows of the
    routed batch it serves), device, and the stream given to it; an
    engine's plan carries the streams it claimed, one a card."""
    mesh = make_mesh(8, devices=[f"cpu:{i % 2}" for i in range(4)])
    plan = mesh.card_groups()
    assert [(c.groups, c.link, c.rows, c.device) for c in plan] == [
        ((0, 2), "home", (0, 1, 4, 5), torch.device("cpu:0")),
        ((1, 3), "peer", (2, 3, 6, 7), torch.device("cpu:1")),
    ]
    assert [c.stream for c in plan] == [None, None]
    streams = ("s0", "s1")
    assert [c.stream for c in mesh.card_groups(streams)] == list(streams)
    one = make_mesh(8, devices=("cpu",) * 4).card_groups()
    assert [(c.groups, c.rows) for c in one] == [((0, 1, 2, 3), tuple(range(8)))]
    engine = ShardedCounterEngine(mesh, num_slots=NUM_SLOTS, buckets=(8,))
    assert [c.stream for c in engine._cards] == list(engine._card_streams())
    assert engine._card_of_group == (0, 1, 0, 1)
    assert engine._staging_size(1)[0] == 4 * 4 * 8


# -- one ctypes call a mesh dispatch ---------------------------------------


def _recorder(monkeypatch, rc=0, failed=-1, read=None):
    """kernels.function as a recorder of (entry, args, read(args)) whose
    entries return `rc`, writing `failed` into a mesh entry's last
    argument.  `read` decodes the C arrays an entry is handed while they
    live: the call's own."""
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


def _four_cards(streams=(101, 102, 103, 104)):
    mesh = make_mesh(8, devices=[f"cpu:{i}" for i in range(4)])
    return mesh, mesh.card_groups([SimpleNamespace(cuda_stream=s) for s in streams])


def _read(address, ctype, n):
    return list((ctype * n).from_address(address))


def test_served_chunk_over_four_cards_is_one_ctypes_call(monkeypatch):
    """A grouped engine's chunk over 4 cards (its mesh call taken down the
    card's path) is ONE ctypes call of rl_mesh_routed_step_lanes carrying
    each card's device, stream, tables, words, readback and event,
    counted as one launch of K6's card form by value a card; a chunk past
    128 lanes a card is one call of rl_mesh_routed_step_mapped with each
    card's staged words and readback (no upload, no device buffer)."""
    calls = _recorder(monkeypatch, read=lambda a: (
        _read(a[1], ctypes.c_int, 4), _read(a[2], ctypes.c_void_p, 4),
        _read(a[3], ctypes.c_void_p, 4), _read(a[4], ctypes.c_int, 4)))
    mesh, _ = _four_cards()
    engine = ShardedCounterEngine(mesh, num_slots=4096, buckets=(8, 128))
    engine._cards = mesh.card_groups([SimpleNamespace(cuda_stream=101 + c) for c in range(4)])

    def by_card(name, launch):
        real = getattr(sh, name)

        def call(parts, cards, *args, **kwargs):
            cap = args[0][0].shape[-1]
            return launch(parts, cards, *args[:3], cap, *args[3:], **kwargs)

        monkeypatch.setattr(sh, name, call)
        return real

    by_card("mesh_routed_step_lanes", sh.launch_mesh_routed_lanes)
    by_card("mesh_routed_step_mapped", sh.launch_mesh_routed_mapped)
    parts = engine.model.parts(engine._counts)
    # 12 lanes over every bank (cap 8, by value); 70 lanes all in bank 0
    # (cap 128: 2 banks x 128 lanes a card, the mapped form).
    for slots, entry, kernel in ((np.arange(12), sh.MESH_ROUTED_LANES, sh.K6_CARD_LANES),
                                 (np.arange(70) * 8, sh.MESH_ROUTED_MAPPED, sh.K6_CARD_MAPPED)):
        calls.clear()
        before, mesh0 = dict(kernels.launches), dict(kernels.mesh_calls)
        width = len(slots)
        hb = HostBatch(slots=slots.astype(np.int32), hits=np.ones(width, np.uint32),
                       limits=np.full(width, 9, np.uint32), fresh=np.zeros(width, bool),
                       shadow=np.zeros(width, bool))
        engine.step_submit(hb)
        ((name, args, (devices, streams, tables, held)),) = calls
        assert name == entry and len(args) == len(kernels.SIGNATURES[name][1])
        assert args[0] == 4
        assert devices == [0, 1, 2, 3] and streams == [101, 102, 103, 104]
        assert tables == [p.data_ptr() for p in parts] and held == [1, 1, 1, 1]
        assert args[5:7] == (2, 4096 // 8)
        assert kernels.launches[kernel] == before.get(kernel, 0) + 4
        assert kernels.mesh_calls[entry] == mesh0.get(entry, 0) + 1


@pytest.mark.parametrize("layout", ["", "uint8", "uint16", "decide"])
def test_forward_step_over_four_cards_is_one_ctypes_call(monkeypatch, layout):
    """K7 over 4 cards, one group each, is ONE ctypes call of
    rl_mesh_card_step: each card's device, stream and the mesh's table
    pointers (null off the card), the home card's lanes where they lie
    and every other card's inside one copy of their bytes (its
    destination in `copies`), scratch a card, one output; counted as one
    card step a card under the epilogue's name."""
    calls = _recorder(monkeypatch, read=lambda a: (
        _read(a[1], ctypes.c_int, 4), _read(a[2], ctypes.c_void_p, 4),
        _read(a[3], ctypes.c_void_p, 16), _read(a[7], ctypes.c_void_p, 20),
        _read(a[8], ctypes.c_void_p, 4)))
    mesh, plan = _four_cards()
    rng = np.random.default_rng(4)
    n, nb = 24, 8
    parts = [torch.zeros((2, NUM_SLOTS // nb), dtype=torch.int32) for _ in range(4)]
    lanes = (torch.from_numpy(rng.integers(0, NUM_SLOTS, n).astype(np.int32)),
             torch.ones(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
             torch.full((n,), 5, dtype=torch.int32), torch.zeros(n, dtype=torch.bool))
    out = torch.zeros(sh.partial_bytes(layout, n), dtype=torch.uint8)
    kernel = sh.K7_CARD_STEP if layout == "decide" else sh.K7_CARD
    before = kernels.launches[kernel]
    assert sh.launch_mesh_card_step(parts, plan, nb, lanes, layout, 0.5, out) is out
    ((name, args, (devices, streams, tables, lane_ptrs, copies)),) = calls
    assert name == sh.MESH_CARD and len(args) == len(kernels.SIGNATURES[name][1])
    assert args[0] == 4 and args[4:7] == (4, nb, NUM_SLOTS // nb)
    assert devices == [0, 1, 2, 3] and streams == [101, 102, 103, 104]
    assert tables == [parts[g].data_ptr() if g == c else None for c in range(4) for g in range(4)]
    assert lane_ptrs[:5] == [t.data_ptr() for t in lanes]
    assert copies[0] is None and all(copies[1:])
    packed, spans = sh._pack_lanes(lanes)
    assert args[10] == packed.numel()
    for c in range(1, 4):
        assert lane_ptrs[5 * c : 5 * c + 5] == [copies[c] + sp[0] for sp in spans]
    assert args[13] == out.data_ptr() and args[-3:-1] == (
        {"": 0, "uint8": 1, "uint16": 2, "decide": 3}[layout], n)
    assert kernels.launches[kernel] == before + 4


@pytest.mark.parametrize("code,sticky", [(1, False), (700, True)])
def test_a_failed_card_names_itself(monkeypatch, code, sticky):
    """A mesh entry's error raises KernelError naming the card that
    raised it (the index the entry wrote), with the CUDA code, counting
    the launches of the cards before it only; the fault domain reads the
    code as for any launch: a sticky one is a lost device, another a
    kernel defect."""
    _recorder(monkeypatch, rc=code, failed=2)
    _, plan = _four_cards()
    parts = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(4)]
    words = [torch.zeros((2, 4, 8), dtype=torch.int32) for _ in range(4)]
    outs = [torch.zeros((2, 8), dtype=torch.int32) for _ in range(4)]
    before = kernels.launches[sh.K6_CARD_LANES]
    with pytest.raises(kernels.KernelError, match=r"on card 2 \(cpu\)") as err:
        sh.launch_mesh_routed_lanes(parts, plan, words, outs, "", 8)
    assert err.value.code == code
    assert kernels.launches[sh.K6_CARD_LANES] == before + 2
    assert _device_lost(err.value) is sticky
    assert kernel_defect(err.value) is not sticky


def test_a_one_group_mesh_keeps_its_one_table_entries(monkeypatch):
    """A mesh of one group (the default on one card) serves and steps as
    one table: the engine's chunk is one call of K6's one-table entry (by
    value, or mapped past 128 lanes) and the forward step one of K7's
    group entry, no mesh entry, no card form."""
    model = ShardedFixedWindowModel(NUM_SLOTS, make_mesh(8, "cpu"))
    seen = []
    for name in ("sharded_routed_step", "sharded_routed_step_lanes", "sharded_routed_step_mapped",
                 "sharded_general_step", "mesh_routed_step", "mesh_routed_step_lanes",
                 "mesh_routed_step_mapped", "mesh_card_step"):
        real = getattr(sh, name)
        monkeypatch.setattr(sh, name, lambda *a, _n=name, _r=real, **k: seen.append(_n) or _r(*a, **k))
    engine = ShardedCounterEngine(model.mesh, num_slots=4096, buckets=(8, 64))
    # 5 lanes by value; 60 lanes all in bank 0 (8 banks x cap 64: the
    # mapped form).
    for slots in (np.arange(5), np.arange(60) * 8):
        width = len(slots)
        engine.step(HostBatch(slots=slots.astype(np.int32),
                              hits=np.ones(width, np.uint32), limits=np.full(width, 9, np.uint32),
                              fresh=np.zeros(width, bool), shadow=np.zeros(width, bool)))
    rng = np.random.default_rng(3)
    b = fw.DeviceBatch(torch.from_numpy(rng.integers(0, NUM_SLOTS, 8).astype(np.int32)),
                       torch.ones(8, dtype=torch.int32), torch.full((8,), 3, dtype=torch.int32),
                       torch.zeros(8, dtype=torch.bool), torch.zeros(8, dtype=torch.bool))
    model.step(model.init_state(), b)
    assert seen == ["sharded_routed_step_lanes", "sharded_routed_step_mapped",
                    "sharded_general_step"]
    assert engine._card_streams() == (engine._stream,)


def test_engine_streams_come_from_the_pool_one_a_card(monkeypatch):
    """Each card's stream is claimed from the pool (claim_stream) and
    given back with the engine's: 4 cards hold 4, one card 1."""
    drawn = []

    def draw(device):
        drawn.append(device)
        return SimpleNamespace(cuda_stream=900_000 + len(drawn), query=lambda: True)

    monkeypatch.setattr(engine_mod, "_draw_stream", draw)
    mesh, _ = _four_cards()
    engine = ShardedCounterEngine(mesh, num_slots=NUM_SLOTS, buckets=(8,))
    assert [d.index for d in drawn] == [1, 2, 3, 0]
    held = [s.cuda_stream for s in engine._card_streams()]
    assert all(engine_mod._HELD_STREAMS[h] is engine for h in held)
    engine.give_back_stream()
    assert not set(held) & set(engine_mod._HELD_STREAMS)
