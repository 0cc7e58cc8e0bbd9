"""The per-day messaging deployment (envoyproxy/ratelimit README, the
``domain: messaging`` example) on the port, against the plain reference
``ratelimit_tpu_torch/reference/descriptor_limits.py``, on the CPU:

- the served path: the port's service with the messaging rules on the
  ``cuda`` cache at ``device="cpu"``, seeded messages to 2^10 recipients
  (one in four marketing, so it sends the nested descriptor too) across
  a UTC midnight; every per-descriptor status and overall code equals
  the reference's;
- the engine's ``submit_packed`` after a mid-day snapshot is restored,
  against the reference started from the snapshot's counts;
- a native table rebuilt from a snapshot's arrays (``from_arrays``)
  equals the one ``from_entries`` builds, with no key decoded on the
  native path (``EntryArrays.entries`` raises there);
- the native table's counters: an import sizes its map once, probe cells
  at least the lookups, index bytes at least the arena, the engine's
  gauges and the cache's, and the restore's span."""

import logging
import os

import numpy as np
import pytest

from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends import checkpoint
from ratelimit_tpu_torch.backends import native_slot_table as nst
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.slot_table import EntryArrays, SlotTable
from ratelimit_tpu_torch.reference.descriptor_limits import OK, OVER_LIMIT, DescriptorLimits
from ratelimit_tpu_torch.service.ratelimit import RateLimitService
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

#: The README's example, verbatim.
MESSAGING_YAML = """\
domain: messaging
descriptors:
  # Only allow 5 marketing messages a day
  - key: message_type
    value: marketing
    descriptors:
      - key: to_number
        rate_limit:
          unit: day
          requests_per_unit: 5
  # Only allow 100 messages a day to any unique phone number
  - key: to_number
    rate_limit:
      unit: day
      requests_per_unit: 100
"""

DAY = 86400
MIDNIGHT = 1_750_032_000  # a UTC midnight
NOON = MIDNIGHT + DAY // 2
MARKETING = ("message_type", "marketing")


@pytest.fixture
def native():
    if not nst.available():
        pytest.skip("no C++ toolchain for the native slot table")


def number(r: int) -> str:
    return f"+1{5550000000 + r}"


def message(r: int, marketing: bool):
    """The descriptors of one message, in the request's order: the nested
    one first for a marketing message."""
    to = ("to_number", number(r))
    return [[MARKETING, to], [to]] if marketing else [[to]]


def draw(rng, n, recipients, skew=1.1):
    """`n` (recipient, marketing) messages, recipients under a zipfian
    law (so some pass both limits), one in four marketing."""
    weights = np.arange(1, recipients + 1, dtype=np.float64) ** -skew
    ids = rng.choice(recipients, size=n, p=weights / weights.sum())
    return list(zip(ids.tolist(), (rng.random(n) < 0.25).tolist()))


class _Runtime:
    def __init__(self, files):
        self._files = files

    def snapshot(self):
        files = self._files

        class Snap:
            def keys(self):
                return sorted(files)

            def get(self, key):
                return files.get(key, "")

        return Snap()

    def add_update_callback(self, fn):
        pass


@pytest.mark.parametrize("seed", [3, 2**33 + 17])
def test_served_messages_across_midnight_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    clock = PinnedTimeSource(MIDNIGHT + DAY - 40)
    cache = CudaRateLimitCache(
        CounterEngine(num_slots=1 << 13, buckets=(8, 32), device="cpu"), clock
    )
    svc = RateLimitService(_Runtime({"config.messaging": MESSAGING_YAML}), cache, Manager(),
                           clock=clock)
    ref = DescriptorLimits(MESSAGING_YAML)
    seen = {OK: 0, OVER_LIMIT: 0}
    try:
        for i, (r, marketing) in enumerate(draw(rng, 2400, 1 << 10)):
            if i % 30 == 29:
                clock.now += 1  # 80 s in all: the day rolls over at i = 1200
            descs = message(r, marketing)
            req = api.RateLimitRequest("messaging", [api.Descriptor.of(*d) for d in descs], 0)
            got = svc.should_rate_limit(req)
            overall, statuses = ref.decide("messaging", descs, clock.now)
            assert int(got.overall_code) == overall, i
            assert [
                (int(s.code), s.current_limit.requests_per_unit, s.current_limit.unit.name,
                 s.limit_remaining, s.duration_until_reset)
                for s in got.statuses
            ] == statuses, i
            seen[overall] += 1
    finally:
        cache.close()
    assert clock.now > MIDNIGHT + DAY
    # Both limits bind: the hot recipients pass 100 a day, their
    # marketing 5, and the new day starts each from zero.
    assert seen[OVER_LIMIT] > 100 and seen[OK] > 1000
    windows = {int(k.rsplit("_", 1)[1]) for k in ref.counts}
    assert windows == {MIDNIGHT, MIDNIGHT + DAY}
    assert max(c for k, c in ref.counts.items() if "marketing" in k) > 5
    assert max(c for k, c in ref.counts.items() if "marketing" not in k) > 100


# -- a mid-day snapshot --------------------------------------------------------


def morning(rng, recipients, messages, num_slots):
    """A morning of the deployment as a snapshot's parts: (counts by key,
    EntryArrays, device counts).  Slots go to keys in a seeded order."""
    counts = {}
    for r, marketing in draw(rng, messages, recipients):
        for entries in message(r, marketing):
            key = "messaging_" + "".join(f"{k}_{v}_" for k, v in entries) + str(MIDNIGHT)
            counts[key] = counts.get(key, 0) + 1
    keys = sorted(counts)
    slots = rng.permutation(num_slots)[: len(keys)].astype(np.int64)
    arrays = EntryArrays.from_entries(
        [(k, int(s), MIDNIGHT + DAY) for k, s in zip(keys, slots.tolist())]
    )
    device = np.zeros(num_slots, dtype=np.uint32)
    device[slots] = [counts[k] for k in keys]
    return counts, arrays, device


def write_morning(path, arrays, device, num_slots):
    checkpoint.write_snapshot(str(path), num_slots, {"counts": device}, arrays, "lane0of1")


def no_decode(monkeypatch):
    def refuse(self):
        raise AssertionError("a key was decoded on the native restore path")

    monkeypatch.setattr(EntryArrays, "entries", refuse)


def pack(messages, limits=(5, 100)):
    """One chunk's lanes: (blob, LANE_DTYPE records, descriptors a lane)."""
    lanes = []
    for r, marketing in messages:
        lanes += message(r, marketing)
    keys = [
        ("messaging_" + "".join(f"{k}_{v}_" for k, v in e) + str(MIDNIGHT)).encode() for e in lanes
    ]
    meta = np.zeros(len(keys), dtype=LANE_DTYPE)
    meta["hits"] = 1
    meta["limits"] = [limits[0] if e[0] == MARKETING else limits[1] for e in lanes]
    meta["len"] = [len(k) for k in keys]
    meta["expiry"] = MIDNIGHT + DAY
    return np.frombuffer(b"".join(keys), dtype=np.uint8).copy(), meta, lanes


@pytest.mark.parametrize("seed", [5, 2**35 + 3])
def test_submit_packed_after_a_mid_day_restore_equals_the_reference(seed, native, tmp_path,
                                                                    monkeypatch):
    rng = np.random.default_rng(seed)
    num_slots = 1 << 12
    counts, arrays, device = morning(rng, 1 << 10, 3000, num_slots)
    path = tmp_path / "bank0.npz"
    write_morning(path, arrays, device, num_slots)

    engine = CounterEngine(num_slots=num_slots, buckets=(64, 512), device="cpu")
    no_decode(monkeypatch)
    assert checkpoint.restore_engine(engine, str(path), "lane0of1", wall_now=lambda: NOON)
    assert isinstance(engine.slot_table, nst.NativeSlotTable)
    assert len(engine.slot_table) == len(counts)

    ref = DescriptorLimits(MESSAGING_YAML)
    ref.counts = dict(counts)
    answered = 0
    for c in range(12):
        blob, meta, lanes = pack(draw(rng, 150, 1 << 10))
        now = NOON + c
        d = engine.step_complete(engine.submit_packed(now, blob, meta))
        want = [ref.decide("messaging", [e], now)[1][0] for e in lanes]
        assert d.codes.tolist() == [w[0] for w in want], c
        assert d.limit_remaining.tolist() == [w[3] for w in want], c
        answered += len(lanes)
    assert answered > 1800
    # The state: every key's count is the reference's (the keys decoded
    # here by hand: EntryArrays.entries still refuses).
    got = engine.export_counts()
    exported = engine.slot_table.export_entries()
    raw = exported.key_blob.tobytes()
    ends = np.cumsum(exported.key_lens)
    held = {
        raw[a:b].decode(): int(got[s])
        for a, b, s in zip(np.r_[0, ends[:-1]].tolist(), ends.tolist(), exported.slots.tolist())
    }
    assert held == ref.counts


def test_restore_after_midnight_refuses_nothing_but_the_age_guard(native, tmp_path):
    """The one-day guard reads the clock it is given: a snapshot saved
    now restores at any earlier pinned clock and is refused a day and a
    second after it was saved."""
    rng = np.random.default_rng(1)
    _, arrays, device = morning(rng, 64, 200, 1 << 10)
    path = tmp_path / "bank0.npz"
    write_morning(path, arrays, device, 1 << 10)
    saved = checkpoint.time.time()
    fresh = CounterEngine(num_slots=1 << 10, buckets=(8,), device="cpu")
    assert checkpoint.restore_engine(fresh, str(path), "lane0of1", wall_now=lambda: NOON)
    stale = CounterEngine(num_slots=1 << 10, buckets=(8,), device="cpu")
    assert not checkpoint.restore_engine(stale, str(path), "lane0of1",
                                         wall_now=lambda: saved + DAY + 1)
    assert len(stale.slot_table) == 0


# -- from_arrays against from_entries --------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_from_arrays_is_from_entries_without_a_decode(seed, native, monkeypatch):
    rng = np.random.default_rng(seed)
    num_slots = 1 << 11
    source = nst.NativeSlotTable(num_slots)
    keys = [f"messaging_to_number_{number(int(r))}_{MIDNIGHT}" for r in rng.permutation(1500)]
    expiries = rng.integers(NOON, NOON + 50, len(keys))
    source.assign_batch(keys, NOON, expiries.tolist())
    source.gc(NOON + 20)  # a few slots freed: the free list is not a plain range
    arrays = source.export_entries()
    entries = arrays.entries()

    by_entries = nst.NativeSlotTable.from_entries(num_slots, entries)
    no_decode(monkeypatch)
    by_arrays = nst.NativeSlotTable.from_arrays(num_slots, arrays)
    monkeypatch.undo()
    assert sorted(by_arrays.entries()) == sorted(by_entries.entries()) == sorted(entries)
    more = [f"messaging_to_number_{number(1500 + i)}_{MIDNIGHT}" for i in range(900)]
    more += keys[:300]
    a = by_arrays.assign_batch(more, NOON + 30, [NOON + 90] * len(more))
    b = by_entries.assign_batch(more, NOON + 30, [NOON + 90] * len(more))
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert by_arrays.evictions == by_entries.evictions
    assert sorted(by_arrays.entries()) == sorted(by_entries.entries())


def test_the_python_table_restores_from_its_decoded_entries(tmp_path):
    rng = np.random.default_rng(2)
    counts, arrays, device = morning(rng, 128, 600, 1 << 10)
    path = tmp_path / "bank0.npz"
    write_morning(path, arrays, device, 1 << 10)
    engine = CounterEngine(num_slots=1 << 10, buckets=(8,), device="cpu", native_table=False)
    assert checkpoint.restore_engine(engine, str(path), "lane0of1", wall_now=lambda: NOON)
    assert isinstance(engine.slot_table, SlotTable)
    got = engine.export_counts()
    assert {k: int(got[s]) for k, s, _ in engine.slot_table.entries()} == counts


# -- the native table's counters -------------------------------------------------


@pytest.mark.parametrize("n", [100, 5000, 60000])
def test_an_import_sizes_its_map_once(n, native):
    keys = [f"messaging_to_number_{number(i)}_{MIDNIGHT}" for i in range(n)]
    arrays = EntryArrays.from_entries([(k, i, MIDNIGHT + DAY) for i, k in enumerate(keys)])
    assert nst.NativeSlotTable(1 << 17).stats().rehashes == 0  # construction is not counted
    t = nst.NativeSlotTable.from_arrays(1 << 17, arrays)
    s = t.stats()
    assert len(t) == n
    assert s.rehashes == (0 if n < 700 else 1) and (s.rehash_ns > 0) == (s.rehashes > 0)
    assert s.lookups == s.probes == 0  # an import's lookups are not assign lookups
    # Sized for n under 70 % load: a power of two of cells, 41 bytes each.
    cells = s.map_bytes // 41
    assert cells & (cells - 1) == 0 and n * 10 < cells * 7 <= max(n * 20, 1024 * 7)
    # Inserts up to 70 % load do not grow it; one past does, once.
    room = (cells * 7 - 1) // 10 - n
    t.assign_batch([f"x{i}" for i in range(room)], NOON, [MIDNIGHT + DAY] * room)
    assert t.stats().rehashes == s.rehashes
    t.assign_batch(["one_more"], NOON, [MIDNIGHT + DAY])
    assert t.stats().rehashes == s.rehashes + 1
    # Filled from empty, the map doubles its way up instead.
    grown = nst.NativeSlotTable(1 << 17)
    grown.assign_batch(keys, NOON, [MIDNIGHT + DAY] * n)
    assert grown.stats().rehashes == max(0, int(np.ceil(np.log2(n * 10 / 7 / 1024))))


def test_probes_lookups_and_index_bytes(native):
    t = nst.NativeSlotTable(1 << 14)
    keys = [f"messaging_to_number_{number(i)}_{MIDNIGHT}" for i in range(5000)]
    t.assign_batch(keys, NOON, [MIDNIGHT + DAY] * len(keys))
    t.assign_batch(keys[:1000], NOON, [MIDNIGHT + DAY] * 1000)
    blob, meta, lanes = pack([(r, r % 4 == 0) for r in range(2000)])
    t.assign_dedup_packed(blob, meta["len"].astype(np.int64), NOON, meta["expiry"],
                          meta["hits"], meta["limits"])
    s = t.stats()
    assert s.lookups == 5000 + 1000 + len(lanes)
    assert s.probes >= s.lookups
    assert s.index_bytes == s.map_bytes + s.arena_bytes + s.homes_bytes + s.expiry_bytes
    assert s.index_bytes >= t.arena_bytes > 0 and s.arena_bytes >= t.arena_bytes
    assert s.homes_bytes == 8 << 14 and s.expiry_bytes >= 8 * len(t)


def test_sk_stats_is_in_the_binding_and_the_compiled_source():
    from ratelimit_tpu_torch.analysis.cparse import parse_sources
    from ratelimit_tpu_torch.analysis.native_abi import find_native_sources

    assert "sk_stats" in nst.expected_symbols()
    c = parse_sources(find_native_sources(nst.__file__)).functions["sk_stats"]
    assert c.path.endswith(os.path.join("csrc", "slot_table.cpp"))
    assert [(p.ctype.kind, p.ctype.width, p.ctype.is_pointer) for p in c.params] == [
        ("void", 0, True), ("int", 8, True)]
    assert len(nst.TableStats._fields) == 9


def test_engine_and_cache_publish_the_counters_and_the_restore_span(native, tmp_path, caplog):
    rng = np.random.default_rng(4)
    counts, arrays, device = morning(rng, 1 << 10, 4000, 1 << 12)
    assert len(counts) > 716  # past the 1024-cell map's 70 %: the import sizes it
    path = tmp_path / "bank0.npz"
    write_morning(path, arrays, device, 1 << 12)
    engine = CounterEngine(num_slots=1 << 12, buckets=(64, 512), device="cpu")
    assert (engine.stat_restore_ns, engine.stat_probes, engine.stat_index_bytes) == (0, 0, 0)
    with caplog.at_level(logging.WARNING, logger="ratelimit.checkpoint"):
        assert checkpoint.restore_engine(engine, str(path), "lane0of1", wall_now=lambda: NOON)
    assert engine.stat_restore_keys == len(counts) == engine.stat_live_keys
    parts = (engine.stat_restore_read_ns, engine.stat_restore_state_ns,
             engine.stat_restore_table_ns)
    assert all(p > 0 for p in parts) and sum(parts) == engine.stat_restore_ns
    assert f"restored {len(counts)} live keys" in caplog.text and "table" in caplog.text
    assert engine.stat_index_bytes == engine.slot_table.stats().index_bytes > 0
    assert engine.stat_rehashes == 1 and engine.stat_lookups == 0

    blob, meta, lanes = pack(draw(rng, 300, 1 << 10))
    engine.step_complete(engine.submit_packed(NOON, blob, meta))
    s = engine.slot_table.stats()
    assert (engine.stat_lookups, engine.stat_probes, engine.stat_rehashes,
            engine.stat_rehash_ns, engine.stat_index_bytes) == (
        s.lookups, s.probes, s.rehashes, s.rehash_ns, s.index_bytes)
    assert engine.stat_lookups == len(lanes) and engine.stat_probes >= len(lanes)

    mgr = Manager()
    cache = CudaRateLimitCache(engine, PinnedTimeSource(NOON))
    try:
        cache.register_stats(mgr.store)
        values = {**mgr.store.counter_fn_values(), **mgr.store.snapshot()}
        base = "ratelimit.tpu.bank0."
        assert values[base + "probes"] == engine.stat_probes
        assert values[base + "rehashes"] == engine.stat_rehashes
        assert values[base + "index_bytes"] == engine.stat_index_bytes
    finally:
        cache.close()


# -- the reference's own semantics -----------------------------------------------


def test_reference_matches_nested_value_before_wildcard_and_binds_the_last_level():
    ref = DescriptorLimits(MESSAGING_YAML + """\
  - key: message_type
    rate_limit:
      unit: hour
      requests_per_unit: 2
""")
    now = NOON + 7
    # A value-specific node first: marketing nests to_number.
    assert ref.rule_of([MARKETING, ("to_number", "x")]).limit == (5, DAY)
    # The marketing node has no limit of its own: alone it matches none.
    assert ref.rule_of([MARKETING]) is None
    # Another message type falls to the wildcard, whose limit binds it.
    assert ref.rule_of([("message_type", "alert")]).limit == (2, 3600)
    # A walk that leaves the tree matches nothing.
    assert ref.rule_of([("message_type", "alert"), ("to_number", "x")]) is None
    assert ref.rule_of([("sender", "x")]) is None
    overall, st = ref.decide("messaging", [[("sender", "x")], [MARKETING, ("to_number", "x")]],
                             now, hits_addend=6)
    assert overall == OVER_LIMIT
    assert st == [(OK, None, None, 0, None), (OVER_LIMIT, 5, "DAY", 0, DAY // 2 - 7)]
    assert ref.counts == {f"messaging_message_type_marketing_to_number_x_{MIDNIGHT}": 6}
    assert ref.decide("other", [[("to_number", "x")]], now) == (OK, [(OK, None, None, 0, None)])
