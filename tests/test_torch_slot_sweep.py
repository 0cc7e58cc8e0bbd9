"""The port's slot table (csrc/slot_table.cpp: per-expiry buckets of
slot records, each swept in one sorted pass) against the JAX package's
native table (native/slot_table.cpp: a heap of key copies), step for
step on seeded workloads of thousands of operations: the fused assign
+ dedup over many windows with and without expiry jitter, gc inside and
outside begin_batch pins, exhaustion and eviction on a small table, and
a restore from a snapshot.  Every step asserts equal lane groups,
unique slots, fresh flags, gc returns, evictions, lengths and entry
sets.  The C release, which the JAX table lacks, is held against the
port's Python SlotTable: the slots it frees and the assignments after.
The engine's sweep counters, the cache's gauges over them and the
sweep replay script at a tiny size close the file."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ratelimit_tpu.backends import native_slot_table as jax_nst
from ratelimit_tpu_torch.backends import native_slot_table as port_nst
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.slot_table import EntryArrays, SlotTable
from ratelimit_tpu_torch.stats import manager
from ratelimit_tpu_torch.utils import time as port_time

NOW = 1_700_000_000


@pytest.fixture
def native():
    if not (port_nst.available() and jax_nst.available()):
        pytest.skip("no C++ toolchain for the native slot tables")


def _pack(keys):
    enc = [k.encode("utf-8") for k in keys]
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8)
    lens = np.fromiter((len(b) for b in enc), np.int64, len(enc))
    return blob, lens


def _key(rng, window, addresses):
    """A key of the window's family: a per-IP key as the service builds
    it (one long common prefix); now and then a short key among them
    (keys that tie on the 16 bytes past the common prefix); or a
    tenant's path (keys that tie on the first 8 of those bytes)."""
    i = int(rng.integers(0, addresses))
    family = window % 3
    if family == 1 and rng.random() < 0.1:
        return f"k{i}_{window}"
    if family == 2:
        return f"tenant_{i % 7}_path_{i:06d}_{window}"
    return f"edge_proxy_per_ip_remote_address_10.{i >> 16}.{(i >> 8) & 255}.{i & 255}_{window}"


class Pair:
    """The port's table and the JAX package's, driven alike."""

    def __init__(self, num_slots):
        self.num_slots = num_slots
        self.port = port_nst.NativeSlotTable(num_slots)
        self.jax = jax_nst.NativeSlotTable(num_slots)
        self.ops = 0

    def fused(self, keys, now, expiries, rng):
        blob, lens = _pack(keys)
        exp = np.asarray(expiries, np.int64)
        hits = rng.integers(1, 4, len(keys)).astype(np.uint32)
        limits = rng.integers(1, 100, len(keys)).astype(np.uint32)
        got = []
        for t in (self.port, self.jax):
            try:
                got.append(t.assign_dedup_packed(blob, lens, now, exp, hits, limits))
            except RuntimeError as e:
                assert "slot table exhausted" in str(e)
                got.append(None)
        self.ops += len(keys)
        if got[0] is None or got[1] is None:
            assert got[0] is None and got[1] is None, "only one table was exhausted"
            return
        for a, b, what in zip(got[0], got[1], ("inv", "uniq", "totals", "prefix", "fresh", "limit_max")):
            np.testing.assert_array_equal(a, b, err_msg=what)

    def assign_batch(self, keys, now, expiries):
        s1, f1 = self.port.assign_batch(keys, now, expiries)
        s2, f2 = self.jax.assign_batch(keys, now, expiries)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(f1, f2)
        self.ops += len(keys)

    def gc(self, now):
        freed = self.port.gc(now)
        assert freed == self.jax.gc(now)
        self.ops += 1
        return freed

    def check(self):
        assert len(self.port) == len(self.jax)
        assert self.port.evictions == self.jax.evictions
        assert sorted(self.port.entries()) == sorted(self.jax.entries())

    def restore(self):
        """Both tables rebuilt from the port's snapshot (sk_import)."""
        entries = sorted(self.port.entries())
        self.port = port_nst.NativeSlotTable.from_entries(self.num_slots, entries)
        self.jax = jax_nst.NativeSlotTable.from_entries(self.num_slots, entries)
        self.check()


# case -> (num_slots, addresses, lanes per chunk, chunks a window, jitter,
#          lease past the window, windows)
CASES = {
    # one bucket a window; the table runs out of free slots between
    # sweeps, so assign's own gc (with the call's pins) runs too
    "fixed": (1024, 600, 64, 6, 0, 1, 40),
    # a window spread over four one-second buckets
    "jittered": (1024, 600, 64, 6, 4, 1, 40),
    # buckets of over 8192 keys: the sweep's radix sort
    "wide": (65536, 40000, 4096, 6, 0, 1, 10),
    # leases far past the sweeps: the small table evicts, and a chunk of
    # more distinct keys than slots exhausts it
    "evict": (96, 400, 48, 4, 3, 50, 30),
}


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_assign_and_sweep_match_the_jax_table(native, case, seed):
    num_slots, addresses, lanes, per_window, jitter, lease, windows = CASES[case]
    rng = np.random.default_rng(seed)
    pair = Pair(num_slots)
    now = NOW
    for w in range(windows):
        window = now
        for _ in range(per_window):
            n = int(rng.integers(1, lanes + 1))
            if case == "evict" and rng.random() < 0.05:
                n = 2 * num_slots  # more distinct keys than slots, likely
            keys = [_key(rng, window, addresses) for _ in range(n)]
            exp = [window + lease + int(rng.integers(0, jitter + 1)) for _ in range(n)]
            pair.fused(keys, now, exp, rng)
            pair.check()
        if rng.random() < 0.6:
            pair.gc(now + int(rng.integers(0, 3)))
            pair.check()
        if w == windows // 2:
            pair.restore()
        now += int(rng.integers(1, 3))
    assert pair.ops > 2000
    if case == "evict":
        assert pair.port.evictions > 0


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_gc_inside_and_outside_batch_pins_matches_the_jax_table(native, seed):
    """gc within begin_batch leaves the batch's pinned keys, expired or
    not, in their bucket; the next gc outside the batch frees them."""
    rng = np.random.default_rng(seed)
    pair = Pair(128)
    now = NOW
    for step in range(300):
        window = now
        keys = [_key(rng, window, 200) for _ in range(int(rng.integers(1, 24)))]
        exp = [now + int(rng.integers(0, 3)) for _ in keys]  # some expire at now
        if step % 3 == 0:
            for t in (pair.port, pair.jax):
                t.begin_batch()
            try:
                pair.assign_batch(keys, now, exp)
                pair.gc(now)
                pair.check()
                pair.assign_batch(keys[: len(keys) // 2], now, exp[: len(keys) // 2])
            finally:
                for t in (pair.port, pair.jax):
                    t.end_batch()
        else:
            pair.assign_batch(keys, now, exp)
        pair.check()
        if rng.random() < 0.5:
            pair.gc(now)
            pair.check()
        now += int(rng.integers(0, 2))
    assert pair.ops > 2000


def test_an_expired_pinned_key_is_kept_then_swept(native):
    """A key handed out in the open batch and expired at its `now` stays
    through the batch's gc; the same sweep frees the unpinned one."""
    pair = Pair(8)
    pair.assign_batch(["old_1", "held_1"], NOW, [NOW, NOW])
    for t in (pair.port, pair.jax):
        t.begin_batch()
    pair.assign_batch(["held_1"], NOW, [NOW])
    assert pair.gc(NOW) == 1
    pair.check()
    assert [k for k, _s, _e in pair.port.entries()] == ["held_1"]
    for t in (pair.port, pair.jax):
        t.end_batch()
    assert pair.gc(NOW) == 1
    pair.check()
    assert len(pair.port) == 0


def test_one_sweep_frees_in_expiry_then_key_order(native):
    """Freed slots go on the LIFO free list in (expiry, key) order, so
    the next fresh keys take them back in reverse: the heap's order."""
    pair = Pair(16)
    keys = ["b_9", "a_9", "c_7", "a_7", "ab_7", "a\x00_7", "a_70"]
    exp = [NOW + 2, NOW + 2, NOW + 1, NOW + 1, NOW + 1, NOW + 1, NOW + 1]
    pair.assign_batch(keys, NOW, exp)
    slot = {k: s for k, s, _e in pair.port.entries()}
    assert pair.gc(NOW + 2) == len(keys)
    fresh = [f"n{i}" for i in range(len(keys))]
    got, _ = pair.port.assign_batch(fresh, NOW + 2, [NOW + 9] * len(keys))
    order = sorted(keys, key=lambda k: (exp[keys.index(k)], k.encode()))
    assert got.tolist() == [slot[k] for k in reversed(order)]
    pair.jax.assign_batch(fresh, NOW + 2, [NOW + 9] * len(keys))
    pair.check()


@pytest.mark.parametrize("seed", [7, 2**32 + 3])
def test_release_matches_the_python_table(native, seed):
    """release_arrays frees what SlotTable.release_arrays frees (same
    key, slot and expiry), and the keys after it get the same slots."""
    rng = np.random.default_rng(seed)
    port, py = port_nst.NativeSlotTable(64), SlotTable(64)
    now = NOW
    ops = 0
    for _ in range(250):
        keys = [_key(rng, now, 120) for _ in range(int(rng.integers(1, 16)))]
        exp = [now + 1 + int(rng.integers(0, 4)) for _ in keys]
        s1, f1 = port.assign_batch(keys, now, exp)
        s2, f2 = py.assign_batch(keys, now, exp)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(f1, f2)
        ops += len(keys)
        entries = sorted(port.entries())
        assert entries == sorted(py.entries())
        if entries and rng.random() < 0.4:
            pick = [entries[int(i)] for i in rng.integers(0, len(entries), 6)]
            # some copies no longer match: another expiry or slot
            moved = [
                (k, s, e + 1) if rng.random() < 0.2 else ((k, (s + 1) % 64, e) if rng.random() < 0.2 else (k, s, e))
                for k, s, e in pick
            ]
            arrays = EntryArrays.from_entries(moved)
            np.testing.assert_array_equal(port.release_arrays(arrays), py.release_arrays(arrays))
            ops += len(moved)
        if rng.random() < 0.3:
            assert port.gc(now) == py.gc(now)
            ops += 1
        assert port.evictions == py.evictions
        now += int(rng.integers(0, 2))
    assert ops > 1500


@pytest.mark.parametrize("seed", [11, 2**32 + 17])
@pytest.mark.parametrize("every, survivors", [(64, 64), (2, 10240)])
def test_a_mostly_released_mixed_bucket_sweeps_in_key_order(native, seed, every, survivors):
    """One expiry's bucket of keys of three families with different
    first bytes, released but for every `every`-th key from the second
    (so a key past the bucket's first record decides the common prefix,
    and the survivors share none; 64 survivors take the comparison
    sort, 10240 the radix sort): the sweep frees the survivors in key
    order, as the Python table does, and the keys after it get its
    slots."""
    rng = np.random.default_rng(seed)
    port, py = port_nst.NativeSlotTable(32768), SlotTable(32768)
    keys = {}
    while len(keys) < every * survivors:
        keys[_key(rng, 3 + int(rng.integers(0, 3)), 1 << 20)] = None
    keys = list(keys)
    exp = [NOW + 5] * len(keys)
    s1, _ = port.assign_batch(keys, NOW, exp)
    s2, _ = py.assign_batch(keys, NOW, exp)
    np.testing.assert_array_equal(s1, s2)
    gone = EntryArrays.from_entries(
        [(k, int(s), NOW + 5) for i, (k, s) in enumerate(zip(keys, s1)) if i % every != 1]
    )
    np.testing.assert_array_equal(port.release_arrays(gone), py.release_arrays(gone))
    kept = [k for i, k in enumerate(keys) if i % every == 1]
    assert len(kept) == survivors and len({k[0] for k in kept}) > 1
    assert port.gc(NOW + 5) == py.gc(NOW + 5) == len(kept)
    fresh = [f"next_{i}" for i in range(len(kept))]
    s1, _ = port.assign_batch(fresh, NOW + 6, [NOW + 9] * len(fresh))
    s2, _ = py.assign_batch(fresh, NOW + 6, [NOW + 9] * len(fresh))
    np.testing.assert_array_equal(s1, s2)
    assert sorted(port.entries()) == sorted(py.entries())


def test_sweeps_compact_the_key_arena(native):
    """Window after window of keys swept whole: the arena stays bounded
    (dead keys are compacted by the sweep) and every window's keys get
    the same slots as in the JAX table."""
    pair = Pair(4096)
    keys = [f"churnkey_with_a_realistic_length_{i:05d}" for i in range(2048)]
    key_bytes = sum(len(k) for k in keys)
    peak = 0
    for window in range(40):
        now = NOW + window * 100
        pair.assign_batch(keys, now, [now + 50] * len(keys))
        assert pair.gc(now + 60) == len(keys)
        pair.check()
        peak = max(peak, pair.port.arena_bytes)
    assert peak < 20 * key_bytes, (peak, key_bytes)


def test_engine_gc_counts_its_sweeps(native):
    engine = CounterEngine(num_slots=64, buckets=(8,), device="cpu", native_table=True)
    assert (engine.stat_gc_ns, engine.stat_gc_freed, engine.stat_gc_sweeps) == (0, 0, 0)
    for i in range(5):
        engine.assign_slot(f"a{i}_1", NOW, NOW + 1)
    engine.assign_slot("b_1", NOW, NOW + 10)
    assert engine.gc(NOW + 1) == 5
    assert (engine.stat_gc_freed, engine.stat_gc_sweeps) == (5, 1)
    assert engine.stat_gc_ns > 0
    assert engine.gc(NOW + 1) == 0
    assert (engine.stat_gc_freed, engine.stat_gc_sweeps) == (0, 2)


def test_cache_publishes_the_sweep_gauges(native):
    engine = CounterEngine(num_slots=64, buckets=(8,), device="cpu", native_table=True)
    cache = CudaRateLimitCache(engine, port_time.PinnedTimeSource(NOW))
    mgr = manager.Manager()
    cache.register_stats(mgr.store)
    try:

        def sweep():
            for i in range(3):
                engine.assign_slot(f"g{i}_1", NOW, NOW + 1)
            engine.gc(NOW + 1)

        cache.run_exclusive(engine, sweep)
        snap = mgr.store.snapshot()
        base = "ratelimit.tpu.bank0."
        assert snap[base + "gc_sweeps"] == 1
        assert snap[base + "gc_freed"] == 3
        assert snap[base + "gc_us"] == engine.stat_gc_ns // 1000
    finally:
        cache.close()


def test_sweep_replay_script_runs_on_the_cpu(native):
    """scripts/torch_slot_sweep.py at a tiny size: the cell's config and
    traffic files, two sweeps, one summary line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "torch_slot_sweep.py"), "--seed",
         str(2**32 + 9), "--windows", "5", "--chunks-per-window", "3", "--gc-every", "2",
         "--lanes", "512", "--pool-chunks", "4", "--commit", "test"],
        capture_output=True, text=True, timeout=300, check=True,
    )
    [line] = [x for x in out.stdout.splitlines() if x.startswith("SLOT_SWEEP ")]
    got = json.loads(line.split(" ", 1)[1])
    assert (got["commit"], got["sweeps"], got["chunks"], got["lanes"]) == ("test", 2, 15, 512)
    assert got["freed_median"] > 0 and got["sweep_ms_max"] >= got["sweep_ms_median"] > 0
