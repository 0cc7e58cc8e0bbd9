"""The write-behind backend (ratelimit_tpu_torch/backends/write_behind.py)
against the JAX package's, on the CPU.

Each scenario of the JAX package's tests/test_write_behind.py runs
through both packages -- ratelimit_tpu's WriteBehindRateLimitCache over
its CounterEngine, and the port's over CounterEngine(device="cpu") --
with the same requests under a pinned clock, and must give equal
statuses, equal stats and equal counters after flush() (tolerance 0),
and host views with the same keys, each agreeing with its counters.  Then the 8-thread stress of
tests/test_adversarial.py, a u16 readback past 32767, a GCRA rule
counted as a fixed window, checkpoint files crossing between the
packages both ways, and the bank role that keeps a write-behind bank
and a one-lane sync bank off each other's files.
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ratelimit_tpu import api as jax_api
from ratelimit_tpu import service as jax_service
from ratelimit_tpu.backends import checkpoint as jax_cp
from ratelimit_tpu.backends import dispatcher as jax_dispatcher
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.backends.write_behind import (
    WriteBehindRateLimitCache as JaxWriteBehind,
)
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.limiter.local_cache import LocalCache as JaxLocalCache
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch import service
from ratelimit_tpu_torch.backends import checkpoint as cp
from ratelimit_tpu_torch.backends import dispatcher
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.write_behind import WriteBehindRateLimitCache
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.limiter.local_cache import LocalCache
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

YAML = """
domain: wb
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 5
  - key: shadow
    rate_limit:
      unit: minute
      requests_per_unit: 2
    shadow_mode: true
  - key: big
    rate_limit:
      unit: hour
      requests_per_unit: 100
  - key: stress
    rate_limit:
      unit: hour
      requests_per_unit: 1000000
  - key: wide
    rate_limit:
      unit: minute
      requests_per_unit: 40000
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: gcra
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    loader=jax_loader,
    Manager=JaxManager,
    Clock=JaxPinned,
    EngineCls=JaxEngine,
    engine_kw={},
    WriteBehind=JaxWriteBehind,
    Sync=TpuRateLimitCache,
    LocalCache=JaxLocalCache,
    cp=jax_cp,
    CacheError=jax_service.CacheError,
    DispatcherDead=jax_dispatcher.DispatcherDead,
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    loader=loader,
    Manager=Manager,
    Clock=PinnedTimeSource,
    EngineCls=CounterEngine,
    engine_kw={"device": "cpu"},
    WriteBehind=WriteBehindRateLimitCache,
    Sync=CudaRateLimitCache,
    LocalCache=LocalCache,
    cp=cp,
    CacheError=service.CacheError,
    DispatcherDead=dispatcher.DispatcherDead,
)
BOTH = (JAX, PORT)
BOTH_IDS = [P.name for P in BOTH]


def _engine(P, cls=None, ns=256, buckets=(8, 32)):
    return (cls or P.EngineCls)(num_slots=ns, buckets=buckets, **P.engine_kw)


def _wb(P, clock, engine=None, **kw):
    return P.WriteBehind(engine or _engine(P), time_source=clock, batch_window_us=100, **kw)


def _cfg(P, mgr):
    return P.loader.load_config([P.loader.ConfigFile("config.wb", YAML)], mgr)


def _req(P, entries_list, hits=0):
    return P.api.RateLimitRequest("wb", [P.api.Descriptor.of(*e) for e in entries_list], hits)


def _limits(cfg, req):
    return [cfg.get_limit(req.domain, d) for d in req.descriptors]


def _do(P, cache, cfg, entries_list, hits=0):
    """(code name, remaining, duration) per descriptor of one request."""
    req = _req(P, entries_list, hits)
    return [
        (s.code.name, s.limit_remaining, s.duration_until_reset)
        for s in cache.do_limit(req, _limits(cfg, req))
    ]


#: requests_per_unit of each YAML key, by the key's name.
LIMITS = {"k": 5, "shadow": 2, "big": 100, "stress": 1000000, "wide": 40000, "tb": 5}


def _counters(engine):
    """{key: count} of the engine's live slots, after a flush."""
    counts = engine.export_counts()
    return {k: int(counts[slot]) for k, slot, _exp in engine.slot_table.entries()}


def _view_agrees(view, counters):
    """A reconciled view against the card's counters.  Its device
    component is the saturated readback min(after, limit + the batch's
    hits on the key), so it equals the counter while the counter is
    within the limit, and lies in (limit, counter] past it: how far
    depends on how the dispatcher happened to batch the hits."""
    for key, (dev, pending, _exp) in view.items():
        assert pending == 0, key
        true, limit = counters[key], LIMITS[key.split("_")[1]]
        if true <= limit:
            assert dev == true, key
        else:
            assert limit < dev <= true, key


class Pair:
    """One write-behind cache per package over the same config, fed the
    same requests under clocks pinned to the same second."""

    def __init__(self, make=None, t0=1234):
        self.clocks = [P.Clock(t0) for P in BOTH]
        self.mgrs = [P.Manager() for P in BOTH]
        self.cfgs = [_cfg(P, m) for P, m in zip(BOTH, self.mgrs)]
        make = make or (lambda P, clock: _wb(P, clock))
        self.caches = [make(P, c) for P, c in zip(BOTH, self.clocks)]

    def do(self, entries_list, hits=0):
        got = [
            _do(P, cache, cfg, entries_list, hits)
            for P, cache, cfg in zip(BOTH, self.caches, self.cfgs)
        ]
        assert got[0] == got[1]
        return got[1]

    def advance(self, seconds):
        for c in self.clocks:
            c.now += seconds

    def flush_and_compare(self):
        """After flush: equal stats and device counters, and views with
        the same keys and expiries, each agreeing with its counters."""
        for cache in self.caches:
            cache.flush()
        assert self.mgrs[0].store.counters() == self.mgrs[1].store.counters()
        counters = [_counters(cache.engine) for cache in self.caches]
        assert counters[0] == counters[1]
        views = [cache._view for cache in self.caches]
        assert {k: e[2] for k, e in views[0].items()} == {k: e[2] for k, e in views[1].items()}
        for view, c in zip(views, counters):
            _view_agrees(view, c)

    def close(self):
        for cache in self.caches:
            cache.close()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def test_differential_vs_sync_backend():
    """Interleaved keys, duplicates, hits_addend, shadow: the port's
    write-behind cache, the JAX package's, and the port's sync cache
    give the same decisions, and after a drain the same stats."""
    pair = Pair()
    clock = PinnedTimeSource(1234)
    mgr = Manager()
    cfg = _cfg(PORT, mgr)
    sync = CudaRateLimitCache(_engine(PORT), time_source=clock)
    try:
        rng = np.random.default_rng(7)
        for step in range(40):
            n = int(rng.integers(1, 4))
            entries = [[("k", f"v{int(rng.integers(0, 3))}")] for _ in range(n)]
            if rng.random() < 0.3:
                entries.append([("shadow", f"s{int(rng.integers(0, 2))}")])
            hits = int(rng.integers(0, 3))
            got = pair.do(entries, hits)
            want = _do(PORT, sync, cfg, entries, hits)
            assert [g[:2] for g in got] == [w[:2] for w in want], f"step {step}"
            dt = int(rng.integers(0, 2))
            pair.advance(dt)
            clock.now += dt
        pair.flush_and_compare()
        sync.flush()
        assert pair.mgrs[1].store.counters() == mgr.store.counters()
        assert _counters(pair.caches[1].engine) == _counters(sync.engine)
    finally:
        pair.close()
        sync.close()


def test_decisions_exact_within_one_request(pair):
    """Duplicates in one request see each other's hits (pipeline
    order), same as the sync path's prefixes."""
    got = pair.do([[("k", "dup")]] * 6)
    assert [g[0] for g in got] == ["OK"] * 5 + ["OVER_LIMIT"]
    assert [g[1] for g in got[:5]] == [4, 3, 2, 1, 0]
    pair.flush_and_compare()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_rpc_path_does_not_wait_for_device(P):
    """A stalled device must not stall do_limit (the write-behind
    point): decisions keep flowing from the host view."""
    stall = {"on": False}

    class StallingEngine(P.EngineCls):
        def submit_packed(self, *a, **kw):
            while stall["on"]:
                time.sleep(0.005)
            return super().submit_packed(*a, **kw)

    wb = _wb(P, P.Clock(1234), _engine(P, StallingEngine))
    cfg = _cfg(P, P.Manager())
    try:
        stall["on"] = True
        t0 = time.perf_counter()
        codes = [_do(P, wb, cfg, [[("k", "fast")]])[0][0] for _ in range(6)]
        elapsed = time.perf_counter() - t0
        # 6 exact decisions while the device leg is wedged.
        assert codes == ["OK"] * 5 + ["OVER_LIMIT"]
        assert elapsed < 2.0
        stall["on"] = False
        wb.flush()
        assert int(wb.engine.export_counts().sum()) == 6
    finally:
        stall["on"] = False
        wb.close()


def test_flush_reconciles_view_from_device(pair):
    for _ in range(3):
        pair.do([[("big", "r")]])
    pair.flush_and_compare()
    for cache in pair.caches:
        (dev, pending, _exp), = cache._view.values()
        assert (dev, pending) == (3, 0)  # device value absorbed, no pending
        assert int(cache.engine.export_counts().sum()) == 3


def test_shadow_mode_never_blocks(pair):
    for i in range(6):
        assert pair.do([[("shadow", "s")]])[0][0] == "OK", f"shadow blocked at call {i}"
    pair.flush_and_compare()
    assert pair.mgrs[1].store.counters()["ratelimit.service.rate_limit.wb.shadow.shadow_mode"] == 4


def test_local_cache_short_circuit():
    pair = Pair(lambda P, clock: _wb(P, clock, local_cache=P.LocalCache(1 << 16)))
    try:
        for _ in range(6):
            pair.do([[("k", "lc")]])
        # The over-limit transition populated the host cache: the next
        # request short-circuits.
        assert pair.do([[("k", "lc")]])[0][:2] == ("OVER_LIMIT", 0)
        snap = pair.mgrs[1].store.counters()
        assert snap["ratelimit.service.rate_limit.wb.k.over_limit_with_local_cache"] == 1
        pair.flush_and_compare()
    finally:
        pair.close()


def test_latency_comparison_row():
    """Per-request host time in write-behind mode against the port's
    inline sync mode (which pays the device leg on the RPC thread),
    asserted loosely (3x) as in the JAX package's test."""
    clock = PinnedTimeSource(1234)
    cfg = _cfg(PORT, Manager())
    sync = CudaRateLimitCache(_engine(PORT), time_source=clock, batch_window_us=0)
    wb = _wb(PORT, clock)
    try:
        def drive(cache, tag):
            req = _req(PORT, [[("big", tag)]])
            lim = _limits(cfg, req)
            cache.do_limit(req, lim)  # warm
            ts = []
            for _ in range(30):
                t0 = time.perf_counter()
                cache.do_limit(req, lim)
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        t_sync = drive(sync, "sync")
        t_wb = drive(wb, "wb")
        wb.flush()
        assert t_wb < t_sync / 3, (
            f"write-behind p50 {t_wb * 1e6:.0f}us not clearly below "
            f"sync inline p50 {t_sync * 1e6:.0f}us"
        )
    finally:
        sync.close()
        wb.close()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_failed_commit_drains_pending(P):
    """A failed device step must not permanently inflate the view:
    pending hits drain via WorkItem.on_error and decisions fall back to
    device-confirmed values."""
    flaky = {"fail": False}

    class FlakyEngine(P.EngineCls):
        def submit_packed(self, *a, **kw):
            if flaky["fail"]:
                raise RuntimeError("injected device failure")
            return super().submit_packed(*a, **kw)

    wb = _wb(P, P.Clock(1234), _engine(P, FlakyEngine))
    cfg = _cfg(P, P.Manager())
    try:
        _do(P, wb, cfg, [[("k", "drain")]])
        wb.flush()  # 1 committed hit
        flaky["fail"] = True
        _do(P, wb, cfg, [[("k", "drain")]])  # 1 pending hit; its commit fails
        wb.flush()
        (dev, pending, _exp), = wb._view.values()
        assert (dev, pending) == (1, 0), "failed commit leaked pending hits"
        flaky["fail"] = False
        # The next decision sees before=1 (not 2): limit 5, after 2.
        assert _do(P, wb, cfg, [[("k", "drain")]])[0][:2] == ("OK", 3)
        wb.flush()
    finally:
        wb.close()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_restore_rebuilds_view(P, tmp_path):
    """Checkpoint-restore repopulates the host view: the restored
    limit enforces before any reconcile."""
    cfg = _cfg(P, P.Manager())
    clock = P.Clock(1234)
    wb = _wb(P, clock)
    try:
        _do(P, wb, cfg, [[("k", "restore")]] * 5)  # at the 5/min limit
        wb.flush()
        P.cp.CheckpointManager(wb, str(tmp_path)).checkpoint()
    finally:
        wb.close()
    wb2 = _wb(P, clock)
    try:
        assert P.cp.CheckpointManager(wb2, str(tmp_path)).restore() == 1
        (dev, pending, _exp), = wb2._view.values()
        assert (dev, pending) == (5, 0)
        assert _do(P, wb2, cfg, [[("k", "restore")]])[0][0] == "OVER_LIMIT"
        wb2.flush()
    finally:
        wb2.close()


def test_extreme_hits_never_reset_enforcement(pair):
    """The view counts in unbounded Python ints and the device commit
    saturates: two u32-max-hit requests leave the key over-limit, not
    wrapped back to OK."""
    assert pair.do([[("k", "lap")]], hits=0xFFFFFFFF)[0][0] == "OVER_LIMIT"
    assert pair.do([[("k", "lap")]], hits=0xFFFFFFFF)[0][0] == "OVER_LIMIT"
    pair.flush_and_compare()
    assert pair.do([[("k", "lap")]])[0][0] == "OVER_LIMIT", "reconciled view must stay over"
    for cache in pair.caches:
        assert int(cache.engine.export_counts().max()) == 0xFFFFFFFF
    pair.flush_and_compare()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_dead_dispatcher_submit_drains_pending(P):
    """When dispatcher.submit itself raises (dispatcher dead), the
    pending hits this call already added to the view drain in the
    except branch: on_error never fires for an item that never reached
    the queue."""
    wb = _wb(P, P.Clock(1234))
    cfg = _cfg(P, P.Manager())
    try:
        _do(P, wb, cfg, [[("k", "deadsub")]])
        wb.flush()  # 1 committed hit
        wb._dispatcher.stop()
        wb._dispatcher._dead = P.DispatcherDead("stopped for test")
        with pytest.raises(P.CacheError):
            _do(P, wb, cfg, [[("k", "deadsub")]])
        (dev, pending, _exp), = wb._view.values()
        assert (dev, pending) == (1, 0), "raising submit leaked pending hits"
    finally:
        wb.close()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_many_thread_stress_exact(P):
    """8 threads hammering 5 keys with random hits_addend (the twin of
    tests/test_adversarial.py's write-behind stress): every decision OK,
    and after flush the device counters and the reconciled view carry
    every hit exactly once."""
    cfg = _cfg(P, P.Manager())
    cache = P.WriteBehind(
        _engine(P, ns=512, buckets=(8, 32, 128)),
        time_source=P.Clock(1234),
        batch_window_us=200,
    )
    keys = [f"w{i}" for i in range(5)]
    totals_per_thread = []
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        totals = {k: 0 for k in keys}
        try:
            for _ in range(60):
                k = keys[int(rng.integers(0, len(keys)))]
                hits = int(rng.integers(1, 4))
                assert _do(P, cache, cfg, [[("stress", k)]], hits)[0][0] == "OK"
                totals[k] += hits
        except Exception as e:  # pragma: no cover -- reported below
            errors.append(e)
        totals_per_thread.append(totals)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        cache.flush()
        want = {k: sum(t[k] for t in totals_per_thread) for k in keys}
        got = {k.split("_")[2]: v for k, v in _counters(cache.engine).items()}
        assert got == want
        assert all(e[1] == 0 for e in cache._view.values())
        assert sum(e[0] for e in cache._view.values()) == sum(want.values())
    finally:
        sys.setswitchinterval(interval)
        cache.close()


def test_u16_readback_past_32767(pair):
    """A rule whose readback cap fits u16 (limit + hits <= 65535) on a
    key whose count is past 32767: the port reads its int16-stored
    readback as unsigned, so the view holds 33001, never a negative
    count that would over-admit."""
    assert pair.do([[("wide", "u16")]], hits=33000)[0][:2] == ("OK", 7000)
    pair.flush_and_compare()
    assert pair.do([[("wide", "u16")]], hits=1)[0][:2] == ("OK", 6999)
    pair.flush_and_compare()
    for cache in pair.caches:
        (dev, pending, _exp), = cache._view.values()
        assert (dev, pending) == (33001, 0)
    assert pair.do([[("wide", "u16")]], hits=6999)[0][:2] == ("OK", 0)
    assert pair.do([[("wide", "u16")]], hits=1)[0][:2] == ("OVER_LIMIT", 0)
    pair.flush_and_compare()


def test_gcra_rule_counts_as_a_fixed_window(pair):
    """Write-behind has no algorithm banks: a rule naming gcra is a 5
    per minute fixed window on both packages.  GCRA would admit a hit
    12 s after a burst of five; the fixed window refuses it until the
    minute rolls over, then admits five again."""
    pair.advance(60 - pair.clocks[0].now % 60)  # a minute's first second
    got = [pair.do([[("tb", "g")]])[0][:2] for _ in range(6)]
    assert got == [("OK", 4), ("OK", 3), ("OK", 2), ("OK", 1), ("OK", 0), ("OVER_LIMIT", 0)]
    pair.advance(12)
    assert pair.do([[("tb", "g")]])[0][0] == "OVER_LIMIT"
    pair.advance(48)
    assert [pair.do([[("tb", "g")]])[0][0] for _ in range(6)] == ["OK"] * 5 + ["OVER_LIMIT"]
    pair.flush_and_compare()


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_checkpoint_files_cross_packages(src, dst, tmp_path):
    """A write-behind bank's file written by one package restores into
    the other's write-behind cache: the same view, the same counters,
    and the restored limits enforce before any reconcile."""
    cfg = _cfg(src, src.Manager())
    clock = src.Clock(1234)
    wb = _wb(src, clock)
    try:
        _do(src, wb, cfg, [[("k", "full")]] * 5 + [[("k", "part")]] * 2 + [[("big", "b")]] * 7)
        wb.flush()
        src.cp.CheckpointManager(wb, str(tmp_path)).checkpoint()
        view, counters = dict(wb._view), _counters(wb.engine)
    finally:
        wb.close()
    cfg2 = _cfg(dst, dst.Manager())
    wb2 = _wb(dst, dst.Clock(1234))
    try:
        assert dst.cp.CheckpointManager(wb2, str(tmp_path)).restore() == 1
        assert wb2._view == view
        assert _counters(wb2.engine) == counters
        got = [_do(dst, wb2, cfg2, [[("k", v)]])[0][:2] for v in ("full", "part")]
        assert got == [("OVER_LIMIT", 0), ("OK", 2)]
        wb2.flush()
    finally:
        wb2.close()


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_bank_role_separates_write_behind_from_one_lane(P, tmp_path):
    """A write-behind bank's role is bank0 and a one-lane sync cache's
    lane0of1: switching BACKEND_TYPE between the two on the same files
    restores nothing, either way, in both packages."""
    cfg = _cfg(P, P.Manager())
    clock = P.Clock(1234)
    wb = _wb(P, clock)
    sync = P.Sync(_engine(P), time_source=clock)
    try:
        assert P.cp.bank_roles(wb) == ["bank0"]
        assert P.cp.bank_roles(sync) == ["lane0of1"]
        _do(P, wb, cfg, [[("k", "role")]] * 5)
        _do(P, sync, cfg, [[("k", "role")]] * 5)
        for cache, sub in ((wb, "wb"), (sync, "sync")):
            cache.flush()
            P.cp.CheckpointManager(cache, str(tmp_path / sub)).checkpoint()
    finally:
        wb.close()
        sync.close()
    wb2 = _wb(P, clock)
    sync2 = P.Sync(_engine(P), time_source=clock)
    try:
        assert P.cp.CheckpointManager(wb2, str(tmp_path / "sync")).restore() == 0
        assert P.cp.CheckpointManager(sync2, str(tmp_path / "wb")).restore() == 0
        assert wb2._view == {}
        for cache in (wb2, sync2):
            assert _do(P, cache, cfg, [[("k", "role")]])[0][:2] == ("OK", 4)
        # Each still restores its own kind's file.
        assert P.cp.CheckpointManager(wb2, str(tmp_path / "wb")).restore() == 1
        wb2.flush()
    finally:
        wb2.close()
        sync2.close()
