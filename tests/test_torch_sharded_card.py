"""K7 once a card: the plain card step (every group a card holds in one
launch, the lanes it owns stored into one output) against the JAX
package's mesh, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, one bank per
device, at 2, 4 and 8 banks; the port holds the same banks in groups of
the CPU and runs ``sharded_card_step`` (its plain version: every tensor
is on the CPU) over all of them, or over disjoint sets of them as two
"cards" storing into one output.  The same numpy-seeded inputs go
through both, and every answer and the (num_banks, slots_per_bank)
table must be equal (tolerance 0), in all four epilogues.  Then the
model's launch count, the combine path of a card without a peer
mapping (one partial and one copy home a card, ids at the int32
extremes), the mesh's links and its cap on groups.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimit_tpu.models.fixed_window import DeviceBatch as JaxDeviceBatch
from ratelimit_tpu.parallel import ShardedFixedWindowModel as JaxShardedModel
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.models import fixed_window as fw
from ratelimit_tpu_torch.models.fixed_window import DeviceBatch, state_to_numpy
from ratelimit_tpu_torch.parallel import ShardedFixedWindowModel, make_mesh
from ratelimit_tpu_torch.parallel import sharded as sh

NUM_SLOTS = 64
N = 48
U32 = 0xFFFFFFFF
FIELDS = fw.DeviceDecisions._fields
LAYOUTS = ["decide", "", "uint8", "uint16"]
#: (banks, groups): the JAX mesh's devices, and the port's groups.
MESHES = [(nb, g) for nb in (2, 4, 8) for g in (2, 4, 8) if g <= nb]
_HOST = {torch.int32: np.uint32, torch.int16: np.uint16, torch.uint8: np.uint8, torch.bool: np.bool_}
_JAX = {}


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_HOST[t.dtype])


def _graft(rng, ns):
    """__graft_entry__.entry()'s batch recipe at N lanes."""
    return dict(
        slots=rng.integers(0, ns, N).astype(np.int32),
        hits=rng.integers(1, 4, N).astype(np.uint32),
        limits=rng.integers(1, 1000, N).astype(np.uint32),
        fresh=rng.random(N) < 0.1,
        shadow=np.zeros(N, dtype=bool),
    )


def _duplicates(rng, ns):
    """Heavy duplicates, ids past the table and negative ids down to
    -ns - 4; fresh and shadow lanes."""
    pool = np.concatenate([rng.integers(0, ns, 6), [-1, -ns, -ns - 4, ns, ns + 5]])
    return dict(
        slots=rng.choice(pool, N).astype(np.int32),
        hits=rng.integers(1, 5, N).astype(np.uint32),
        limits=rng.integers(1, 12, N).astype(np.uint32),
        fresh=rng.random(N) < 0.15,
        shadow=rng.random(N) < 0.2,
    )


BATCHES = {"graft": _graft, "duplicates": _duplicates}


def _port_batch(raw):
    return DeviceBatch(
        slots=torch.from_numpy(raw["slots"]),
        hits=torch.from_numpy(raw["hits"].view(np.int32)),
        limits=torch.from_numpy(raw["limits"].view(np.int32)),
        fresh=torch.from_numpy(raw["fresh"]),
        shadow=torch.from_numpy(raw["shadow"]),
    )


def _jax_model(nb):
    if nb not in _JAX:
        _JAX[nb] = JaxShardedModel(NUM_SLOTS, jax_make_mesh(nb))
    return _JAX[nb]


def _jax_step(nb, table, raw, layout):
    """JAX's mesh of nb devices on `table` (uint32[nb, spb]): the answer
    of `layout` as numpy (the nine decision fields for "decide") and the
    table after."""
    jm = _jax_model(nb)
    jc = jnp.asarray(table)
    jb = JaxDeviceBatch(**{k: jnp.asarray(v) for k, v in raw.items()})
    if layout == "decide":
        jc, jd = jm.step(jc, jb)
        answer = {f: np.asarray(getattr(jd, f)).astype(np.int64) for f in FIELDS}
    elif layout == "":
        jc, answer = jm.step_counters(jc, jb)
    else:
        jc, answer = jm.step_counters_compact(jc, layout, jb)
    return answer, np.asarray(jc)


def _same(got, want, layout, what):
    if layout == "decide":
        for f in FIELDS:
            np.testing.assert_array_equal(
                _u(getattr(got, f)).astype(np.int64), want[f], err_msg=f"{what} {f}"
            )
    else:
        assert _u(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_u(got), np.asarray(want), err_msg=what)


def _tables(table, g):
    """A uint32[nb, spb] table as g group tensors."""
    k = table.shape[0] // g
    return [torch.from_numpy(table[i * k : (i + 1) * k].view(np.int32).copy()) for i in range(g)]


def _joined(tables) -> np.ndarray:
    return np.concatenate([state_to_numpy(t) for t in tables])


def _seeded_table(rng, nb):
    table = rng.integers(0, 300, (nb, NUM_SLOTS // nb)).astype(np.uint32)
    table[rng.random(table.shape) < 0.1] = U32 - 2  # adds wrap (modular)
    return table


def _card(tables, groups, nb, b, layout, out):
    return sh.sharded_card_step(
        tables, groups, nb, b.slots, b.hits, b.fresh, b.limits, layout, b.shadow, 0.8, out,
    )


# -- every group on one card ---------------------------------------------


@pytest.mark.parametrize("nb,g", MESHES, ids=[f"{nb}banks-{g}groups" for nb, g in MESHES])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: x or "afters")
def test_card_step_over_every_group_matches_jax(nb, g, layout):
    """One plain card step over every group of the mesh into an output
    filled with a sentinel: the graft-shaped batch and a batch of
    duplicates with negative and out-of-table ids, each against JAX's
    mesh of nb devices, answer and table."""
    rng = np.random.default_rng(1000 + 10 * nb + g)
    for what, make in BATCHES.items():
        table = _seeded_table(rng, nb)
        raw = make(rng, NUM_SLOTS)
        want, want_table = _jax_step(nb, table, raw, layout)
        tables = _tables(table, g)
        out = torch.full((sh.partial_bytes(layout, N),), 0xA5, dtype=torch.uint8)
        assert _card(tables, range(g), nb, _port_batch(raw), layout, out) is out
        _same(sh.unpack_partial(out, layout, N), want, layout, what)
        np.testing.assert_array_equal(_joined(tables), want_table, err_msg=what)


def _written(tables, groups, nb, b, layout):
    """The lanes a card step over `groups` writes, and the output: a
    lane is written where the output is the same over a 0x00 and a 0xFF
    fill (each run on its own copy of the tables)."""
    size = sh.partial_bytes(layout, N)
    outs = []
    for fill in (0x00, 0xFF):
        copy = [t.clone() for t in tables]
        out = torch.full((size,), fill, dtype=torch.uint8)
        outs.append(_card(copy, groups, nb, b, layout, out))
    same = [a == c for a, c in zip(sh._rows(outs[0], layout, N), sh._rows(outs[1], layout, N))]
    lanes = torch.stack([s.all(0) for s in same]).all(0)
    assert torch.equal(lanes, torch.stack([s.any(0) for s in same]).any(0)), (
        "a lane was written in part"
    )
    return lanes


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: x or "afters")
@pytest.mark.parametrize("nb,sets", [(4, ((0, 2), (1, 3))), (8, ((0, 2), (1, 3))),
                                     (8, ((1, 2, 3), (0,)))], ids=["4banks", "8banks", "8banks-0"])
def test_two_cards_store_each_lane_once(nb, sets, layout):
    """Two disjoint sets of groups as two cards, each one card step into
    ONE output pre-filled with a sentinel: the answer and the table equal
    JAX's, no lane keeps the sentinel, each lane is written by exactly
    one set, and that set holds the lane's owner group."""
    g = sum(len(s) for s in sets)
    rng = np.random.default_rng(77 + nb + len(sets[0]))
    for what, make in BATCHES.items():
        table = _seeded_table(rng, nb)
        raw = make(rng, NUM_SLOTS)
        b = _port_batch(raw)
        want, want_table = _jax_step(nb, table, raw, layout)
        tables = _tables(table, g)
        written = [_written(tables, s, nb, b, layout) for s in sets]
        assert torch.equal(written[0] ^ written[1], torch.ones(N, dtype=torch.bool)), what
        s = b.slots.to(torch.int64)
        in_table = (s >= 0) & (s < NUM_SLOTS)
        owner = torch.where(in_table, (s % nb) // (nb // g), 0)
        for lanes, groups in zip(written, sets):
            assert torch.equal(lanes, torch.isin(owner, torch.tensor(groups))), what
        for fill in (0x00, 0xFF):
            out = torch.full((sh.partial_bytes(layout, N),), fill, dtype=torch.uint8)
            run = [t.clone() for t in tables]
            for groups in sets:
                _card(run, groups, nb, b, layout, out)
            _same(sh.unpack_partial(out, layout, N), want, layout, f"{what} fill {fill}")
            np.testing.assert_array_equal(_joined(run), want_table, err_msg=what)


@pytest.mark.parametrize("holder", [0, 1])
def test_out_of_table_lanes_go_to_group_zeros_card(holder):
    """Ids past the table and negative ids belong to the card that holds
    group 0, whichever set of groups that is; the other card leaves them
    as they were."""
    nb, g = 8, 4
    sets = ((0, 3), (1, 2)) if holder == 0 else ((1, 2), (0, 3))
    slots = torch.tensor([-1, -65, NUM_SLOTS, NUM_SLOTS + 7, 0, 1, 2, 3, 4, 5, 6, 7],
                         dtype=torch.int32)
    n = slots.shape[0]
    b = DeviceBatch(slots, torch.ones(n, dtype=torch.int32), torch.full((n,), 9, dtype=torch.int32),
                    torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool))
    tables = [torch.zeros((2, NUM_SLOTS // nb), dtype=torch.int32) for _ in range(g)]
    for groups in sets:
        out = torch.full((4 * n,), 0xFF, dtype=torch.uint8)
        sh.sharded_card_step(tables, groups, nb, b.slots, b.hits, b.fresh, None, "", None, 0.0,
                             out)
        afters = sh.unpack_partial(out, "", n)
        # In-table ids 0-7 lie in banks 0-7, groups 0, 0, 1, 1, 2, 2, 3, 3.
        mine = [0 in groups] * 4 + [b_ // 2 in groups for b_ in range(8)]
        assert [int(a) != -1 for a in afters] == mine, groups
        assert all(int(a) == 1 for a, m in zip(afters, mine) if m)


# -- the model and the mesh's paths ----------------------------------------


def _counting(monkeypatch, name):
    calls = []
    real = getattr(sh, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(sh, name, spy)
    return calls


@pytest.mark.parametrize("variant", ["step", "step_counters", "uint16"])
def test_model_step_on_four_groups_is_one_card_step(monkeypatch, variant):
    """The model over 8 banks in 4 groups of the CPU (one card): each
    step is ONE card step over groups (0, 1, 2, 3) storing into one
    output -- no rows, no combine -- and equals JAX's mesh."""
    calls = _counting(monkeypatch, "sharded_card_step")
    combines = _counting(monkeypatch, "sharded_combine")
    tm = ShardedFixedWindowModel(NUM_SLOTS, make_mesh(8, devices=("cpu",) * 4))
    assert [c[:2] for c in tm.mesh.card_groups()] == [((0, 1, 2, 3), "home")]
    jm = _jax_model(8)
    jc, tc = jm.init_state(), tm.init_state()
    rng = np.random.default_rng(3)
    for step in range(3):
        raw = BATCHES["duplicates"](rng, NUM_SLOTS)
        jb = JaxDeviceBatch(**{k: jnp.asarray(v) for k, v in raw.items()})
        tb = _port_batch(raw)
        if variant == "step":
            (jc, jd), (tc, td) = jm.step(jc, jb), tm.step(tc, tb)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    _u(getattr(td, f)).astype(np.int64), np.asarray(getattr(jd, f)).astype(np.int64)
                )
        elif variant == "step_counters":
            (jc, ja), (tc, ta) = jm.step_counters(jc, jb), tm.step_counters(tc, tb)
            np.testing.assert_array_equal(_u(ta), np.asarray(ja))
        else:
            (jc, ja), (tc, ta) = (jm.step_counters_compact(jc, variant, jb),
                                  tm.step_counters_compact(tc, variant, tb))
            np.testing.assert_array_equal(_u(ta), np.asarray(ja))
        assert len(calls) == step + 1 and calls[-1][1] == (0, 1, 2, 3)
        layout = {"step": "decide", "step_counters": ""}.get(variant, variant)
        # One output of the batch's bytes, no rows a group.
        assert calls[-1][-1].shape == (sh.partial_bytes(layout, tb.slots.shape[0]),)
        np.testing.assert_array_equal(_joined(tm.parts(tc)), np.asarray(jc))
    assert combines == []


@pytest.mark.parametrize("link", ["peer", "combine"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: x or "afters")
def test_grouped_step_over_two_cards_matches_jax(monkeypatch, link, layout):
    """grouped_general_step over groups {0, 2} on the home card and
    {1, 3} on a second card (both the CPU here): with a peer mapping one
    output and no combine; without one, the home card's lanes in the one
    output, the second card's in ONE partial copied home, and ONE
    combine placing {1, 3}'s lanes from it.  Both equal JAX's mesh,
    answer and table."""
    combines = _counting(monkeypatch, "sharded_combine")
    cards = (((0, 2), "home"), ((1, 3), link))
    nb, g = 8, 4
    rng = np.random.default_rng(5)
    for what, make in BATCHES.items():
        table = _seeded_table(rng, nb)
        raw = make(rng, NUM_SLOTS)
        b = _port_batch(raw)
        want, want_table = _jax_step(nb, table, raw, layout)
        tables = _tables(table, g)
        decide = layout == "decide"
        got = sh.grouped_general_step(
            tables, cards, nb, b.slots, b.hits, b.fresh, b.limits, layout,
            b.shadow if decide else None, 0.8,
        )
        _same(got, want, layout, what)
        np.testing.assert_array_equal(_joined(tables), want_table, err_msg=what)
    assert len(combines) == (2 if link == "combine" else 0)
    for out, partials, sources, *_ in combines:
        assert partials.shape[0] == 1 and list(sources) == [0, 1, 0, 1]
        assert out.shape == (sh.partial_bytes(layout, N),)
    with pytest.raises(ValueError, match="each of 4 groups once"):
        sh.grouped_general_step(tables, (((0, 2), "home"),), nb, b.slots, b.hits, b.fresh)


def _extremes(rng, ns):
    """Ids at the int32 extremes, negative, at and past the table's end,
    and in the table; fresh and shadow lanes."""
    pool = np.concatenate([rng.integers(0, ns, 8), [-(2**31), 2**31 - 1, -1, -ns, ns, ns + 1]])
    return dict(
        slots=rng.choice(pool, N).astype(np.int32),
        hits=rng.integers(1, 5, N).astype(np.uint32),
        limits=rng.integers(1, 12, N).astype(np.uint32),
        fresh=rng.random(N) < 0.15,
        shadow=rng.random(N) < 0.2,
    )


#: (banks, the cards' groups and links): the home card and one or two
#: cards that take the combine, with and without a peer-mapped card.
COMBINE_MESHES = {
    "4banks-2cards": (4, [((0, 2), "home"), ((1, 3), "combine")]),
    "8banks-3cards": (8, [((0,), "home"), ((1, 3), "combine"), ((2,), "combine")]),
    "8banks-4cards-peer": (8, [((0, 4), "home"), ((1, 5), "combine"), ((2, 6), "peer"),
                               ((3, 7), "combine")]),
}


@pytest.mark.parametrize("mesh", COMBINE_MESHES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: x or "afters")
def test_combine_path_matches_jax(mesh, layout):
    """The combine path with one or two combine cards (and a peer card
    beside them), on the graft batch, heavy duplicates, and ids at the
    int32 extremes, negative and at or past num_slots: answer and table
    equal JAX's mesh, and the plain combine alone, on the cards' output
    and partials, equals the bytewise sum of them."""
    nb, cards = COMBINE_MESHES[mesh]
    g = sum(len(groups) for groups, _ in cards)
    rng = np.random.default_rng(91 + nb + len(cards))
    for what, make in dict(BATCHES, extremes=_extremes).items():
        table = _seeded_table(rng, nb)
        raw = make(rng, NUM_SLOTS)
        b = _port_batch(raw)
        want, want_table = _jax_step(nb, table, raw, layout)
        decide = layout == "decide"
        tables = _tables(table, g)
        got = sh.grouped_general_step(tables, cards, nb, b.slots, b.hits, b.fresh, b.limits,
                                      layout, b.shadow if decide else None, 0.8)
        _same(got, want, layout, what)
        np.testing.assert_array_equal(_joined(tables), want_table, err_msg=what)
        # The same through the plain combine on zeroed buffers.
        tables = _tables(table, g)
        size = sh.partial_bytes(layout, N)
        out = torch.zeros(size, dtype=torch.uint8)
        combine = [groups for groups, link in cards if link == "combine"]
        partials = torch.zeros((len(combine), -(-size // 16) * 16), dtype=torch.uint8)
        for groups, link in cards:
            dst = out if link != "combine" else partials[combine.index(groups)]
            _card(tables, groups, nb, b, layout, dst)
        summed = torch.cat([out[None], partials[:, :size]]).sum(0, dtype=torch.uint8)
        sh._combine_plain(out, partials, sh._combine_sources(cards), b.slots, nb,
                          NUM_SLOTS // nb, layout)
        assert torch.equal(out, summed), what
        _same(sh.unpack_partial(out, layout, N), want, layout, what)


def test_one_copy_home_per_combine_card(monkeypatch):
    """Each card that takes the combine writes ONE partial of the
    output's layout and sends it home in ONE copy (not a copy a group):
    three cards, two of them combine cards of two groups and one."""
    copies = []
    real = torch.Tensor.copy_

    def spy(self, src, *args, **kwargs):
        copies.append((tuple(self.shape), tuple(src.shape)))
        return real(self, src, *args, **kwargs)

    nb = 8
    cards = [((0, 4), "home"), ((1, 3), "combine"), ((2, 5, 6, 7), "combine")]
    rng = np.random.default_rng(17)
    raw = _duplicates(rng, NUM_SLOTS)
    b = _port_batch(raw)
    table = _seeded_table(rng, nb)
    want, _ = _jax_step(nb, table, raw, "decide")
    tables = _tables(table, 8)
    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    got = sh.grouped_general_step(tables, cards, nb, b.slots, b.hits, b.fresh, b.limits,
                                  "decide", b.shadow, 0.8)
    monkeypatch.undo()
    size = sh.partial_bytes("decide", N)
    assert copies == [((size,), (size,))] * 2
    _same(got, want, "decide", "duplicates")


def _fake_host(monkeypatch, cards, unmapped=()):
    """A host of `cards` CUDA cards on which every card but those in
    `unmapped` can map card 0's memory; returns the enable_peer calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)

    def enable_peer(device, peer):
        calls.append((device, peer))
        return device not in unmapped

    monkeypatch.setattr(kernels, "enable_peer", enable_peer)
    return calls


def test_mesh_links_come_from_the_topology(monkeypatch):
    """make_mesh asks each card past the home one, once, whether it maps
    the home card: a mapped card stores ("peer"), an unmapped one takes
    the combine.  Groups that share a card share its launch and link;
    one card asks nothing."""
    calls = _fake_host(monkeypatch, 4, unmapped={2})
    mesh = make_mesh(8, devices=[f"cuda:{i % 4}" for i in range(8)])
    assert calls == [(1, 0), (2, 0), (3, 0)]
    assert mesh.cards == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.links == ("home", "peer", "combine", "peer")
    assert [c[:2] for c in mesh.card_groups()] == [((0, 4), "home"), ((1, 5), "peer"),
                                                   ((2, 6), "combine"), ((3, 7), "peer")]
    assert mesh.paths() == {"cuda:1->cuda:0": "peer", "cuda:2->cuda:0": "combine",
                            "cuda:3->cuda:0": "peer"}
    calls.clear()
    one = make_mesh(8, devices=("cuda:0",) * 4)
    assert calls == [] and one.links == ("home",) and one.paths() == {}
    assert [c[:2] for c in one.card_groups()] == [((0, 1, 2, 3), "home")]


def test_mesh_refuses_more_groups_than_a_launch_carries(monkeypatch):
    """One card's launch carries MAX_GROUPS table pointers: make_mesh
    refuses a mesh of more groups, and the card step a table list of
    more; a Mesh's links must fit its cards."""
    assert len(make_mesh(sh.MAX_GROUPS, devices=("cpu",) * sh.MAX_GROUPS).devices) == sh.MAX_GROUPS
    with pytest.raises(ValueError, match=f"at most {sh.MAX_GROUPS}"):
        make_mesh(sh.MAX_GROUPS + 1, devices=("cpu",) * (sh.MAX_GROUPS + 1))
    tables = [torch.zeros((1, 4), dtype=torch.int32)] * (sh.MAX_GROUPS + 1)
    lanes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {sh.MAX_GROUPS}"):
        sh.sharded_card_step(tables, (0,), sh.MAX_GROUPS + 1, lanes, lanes,
                             torch.zeros(4, dtype=torch.bool), None, "", None, 0.0,
                             torch.zeros(16, dtype=torch.uint8))
    cuda = tuple(torch.device("cuda", i) for i in (0, 1, 0))
    assert sh.Mesh(3, cuda).links == ("home", "combine")
    assert [c[:2] for c in sh.Mesh(3, cuda, ("home", "peer")).card_groups()] == [
        ((0, 2), "home"), ((1,), "peer")]
    for bad in (("home",), ("peer", "home"), ("home", "home"), ("home", "wire")):
        with pytest.raises(ValueError, match="do not fit"):
            sh.Mesh(3, cuda, bad)


def test_max_groups_is_the_kernels_cap():
    """MAX_GROUPS is csrc/counter_update.cuh's kMaxGroups, and the
    CardIndex that carries them fits a launch's 4 KB of parameters."""
    path = os.path.join(kernels.CSRC_DIR, "counter_update.cuh")
    with open(path) as f:
        src = f.read()
    (cap,) = re.findall(r"constexpr int kMaxGroups = (\d+);", src)
    assert int(cap) == sh.MAX_GROUPS
    assert sh.MAX_GROUPS * ctypes.sizeof(ctypes.c_void_p) + 24 + 14 * 8 < 4096


def test_card_step_checks_its_arguments():
    """Groups outside the mesh or repeated, tables of two shapes, an
    output too small for the batch, or lanes on another device raise."""
    tables = [torch.zeros((2, 4), dtype=torch.int32) for _ in range(4)]
    lanes = torch.zeros(8, dtype=torch.int32)
    fresh = torch.zeros(8, dtype=torch.bool)
    out = torch.zeros(32, dtype=torch.uint8)

    def call(groups=(0,), tabs=tables, out=out, slots=lanes, layout=""):
        return sh.sharded_card_step(tabs, groups, 8, slots, lanes, fresh, None, layout, None,
                                    0.0, out)

    for groups in ((), (4,), (0, 0), (-1,)):
        with pytest.raises(ValueError, match="are not groups of"):
            call(groups)
    with pytest.raises(ValueError, match="alike"):
        call((0, 1), [tables[0], torch.zeros((2, 8), dtype=torch.int32)] + tables[2:])
    with pytest.raises(ValueError, match="does not hold"):
        call((0, 1), out=torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="does not hold"):
        call(out=torch.zeros(31, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        call(out=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected cpu"):
        call(slots=torch.zeros(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="layout"):
        call(layout="uint32")
    assert call((0, 1, 2, 3), out=torch.zeros(4 * 32 + 32, dtype=torch.uint8)) is not None


def test_lanes_cross_to_a_card_in_one_copy():
    """The lanes reach a card past the home one by ONE copy of their
    bytes end to end (int32 lanes first), viewed back bit for bit; a
    lane not given stays None, and the home card's lanes are used as
    they are."""
    rng = np.random.default_rng(8)
    b = _port_batch(BATCHES["duplicates"](rng, NUM_SLOTS))
    lanes = (b.slots, b.hits, b.fresh, b.limits, None)
    packed, spans = sh._pack_lanes(lanes)
    assert packed.dtype == torch.uint8 and packed.shape == (13 * N,)
    assert spans == [(0, 4 * N), (4 * N, 4 * N), (12 * N, N), (8 * N, 4 * N), None]
    copies = []

    class Packed:
        def to(self, device, non_blocking=False):
            copies.append(device)
            return packed.clone()

    got = sh._lanes_to(lanes, Packed(), spans, torch.device("meta"))
    assert copies == [torch.device("meta")]
    for g, t in zip(got, lanes):
        assert (g is None) if t is None else (g.dtype == t.dtype and torch.equal(g, t))
    assert sh._lanes_to(lanes, Packed(), spans, torch.device("cpu")) is lanes and len(copies) == 1
