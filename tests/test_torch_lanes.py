"""Host lanes (TPU_NUM_LANES) of the port against the JAX package's, on
the CPU.

Every scenario of the JAX package's tests/test_lanes.py runs through
both packages -- TpuRateLimitCache over a list of JAX engines, and the
port's CudaRateLimitCache over CounterEngine(device="cpu") lanes -- with
the same inputs (tolerance 0): one limit enforced exactly through the
split, keys spread by crc32 of the stem and staying put (the same lane
in both packages), exact counting under concurrency, lane checkpoints,
flush and close over every dispatcher, the runner's slot split, the
topology guard on restore, lanes of sharded engines, and a batched
two-lane Runner over gRPC.  Then the bank topology as a whole -- bank
labels, checkpoint roles, dispatcher and stats names equal to the JAX
package's -- a lane quarantined and restarted on its own, one dead lane
flipping health, and the CUDA stream that no two live banks may share
(on a fake stream pool: CUDA is not needed to show the rule).
"""

import re
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from test_torch_fault_domain import Injector

from ratelimit_tpu import api as jax_api
from ratelimit_tpu import runner as jax_runner
from ratelimit_tpu.backends import checkpoint as jax_cp
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch import runner as port_runner
from ratelimit_tpu_torch.backends import checkpoint as cp
from ratelimit_tpu_torch.backends import engine as engine_mod
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine, claim_stream, release_stream
from ratelimit_tpu_torch.backends.fault_domain import default_engine_factory
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.models.registry import get_algorithm
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils import time as port_time

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = """
domain: lanes
descriptors:
  - key: key1
    rate_limit:
      unit: minute
      requests_per_unit: 5
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    cp=jax_cp,
    Cache=TpuRateLimitCache,
    loader=jax_loader,
    Manager=JaxManager,
    time=jax_time,
    Settings=JaxSettings,
    runner=jax_runner,
    engine=lambda ns=256, **kw: JaxEngine(num_slots=ns, **kw),
    algo=lambda name, ns=256: JaxEngine(
        buckets=(8,), model=jax_algorithm(name).make_model(ns, 0.8)
    ),
    Sharded=JaxShardedEngine,
    create_limiter=lambda s, clock: jax_runner.create_limiter(s, JaxManager(), None, clock),
    runner_kw={},
    backend="tpu",
    sharded_backend="tpu-sharded",
    dispatcher_prefix="tpu-dispatcher",
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    cp=cp,
    Cache=CudaRateLimitCache,
    loader=loader,
    Manager=Manager,
    time=port_time,
    Settings=Settings,
    runner=port_runner,
    engine=lambda ns=256, **kw: CounterEngine(num_slots=ns, device="cpu", **kw),
    algo=lambda name, ns=256: CounterEngine(
        buckets=(8,), device="cpu", model=get_algorithm(name).make_model(ns, 0.8, device="cpu")
    ),
    Sharded=ShardedCounterEngine,
    create_limiter=lambda s, clock: port_runner.create_limiter(
        s, None, clock, device="cpu", mesh=make_mesh(8, "cpu")
    ),
    runner_kw={"device": "cpu"},
    backend="cuda",
    sharded_backend="cuda-sharded",
    dispatcher_prefix="cuda-dispatcher",
)
BOTH = (JAX, PORT)


def _cfg(P):
    return P.loader.load_config([P.loader.ConfigFile("config.lanes", YAML)], P.Manager())


def _req(P, values, hits=0):
    return P.api.RateLimitRequest(
        "lanes", [P.api.Descriptor.of(("key1", v)) for v in values], hits
    )


def _rules(cfg, req):
    return [cfg.get_limit(req.domain, d) for d in req.descriptors]


def _codes(sts):
    return [st.code.name for st in sts]


def _make_cache(P, n_lanes, **kw):
    engines = [P.engine() for _ in range(n_lanes)]
    return P.Cache(engines, time_source=P.time.PinnedTimeSource(1_000_000), **kw), engines


# ---------------------------------------------------------------------------
# tests/test_lanes.py's scenarios, each run on one package
# ---------------------------------------------------------------------------


def lanes_enforce_one_limit_exactly(P, tmp):
    cache, _ = _make_cache(P, 4)
    req = _req(P, ["joint"])
    rules = _rules(_cfg(P), req)
    codes = [cache.do_limit(req, rules)[0].code.name for _ in range(7)]
    assert codes == ["OK"] * 5 + ["OVER_LIMIT"] * 2
    return codes


def keys_spread_across_lanes_and_stay_put(P, tmp):
    cache, engines = _make_cache(P, 4)
    req = _req(P, [f"v{i}" for i in range(64)])
    rules = _rules(_cfg(P), req)
    cache.do_limit(req, rules)
    cache.do_limit(req, rules)
    per_lane = [int(e.export_counts().sum()) for e in engines]
    live = [len(e.slot_table) for e in engines]
    assert sum(per_lane) == 128 and sum(1 for c in per_lane if c > 0) >= 3
    assert sum(live) == 64
    return dict(per_lane=per_lane, live=live, keys=[sorted(k for k, _s, _e in e.slot_table.entries()) for e in engines])


def batched_lanes_count_exactly_under_concurrency(P, tmp):
    cache, _ = _make_cache(P, 4, batch_window_us=200, batch_limit=512)
    try:
        keys = [f"conc{i}" for i in range(6)]
        oks = {k: 0 for k in keys}
        lock = threading.Lock()

        def worker():
            local_cfg = _cfg(P)
            for _ in range(4):
                req = _req(P, keys)
                sts = cache.do_limit(req, _rules(local_cfg, req))
                with lock:
                    for k, st in zip(keys, sts):
                        oks[k] += st.code.name == "OK"

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(v == 5 for v in oks.values()), oks
        return oks
    finally:
        cache.close()


def lane_checkpoint_round_trip(P, tmp):
    cfg = _cfg(P)
    cache, engines = _make_cache(P, 3)
    req = _req(P, [f"ck{i}" for i in range(24)])
    cache.do_limit(req, _rules(cfg, req))
    assert len(cache.engines()) == 3
    P.cp.CheckpointManager(cache, str(tmp), interval_s=3600).checkpoint()
    cache2, engines2 = _make_cache(P, 3)
    restored = P.cp.CheckpointManager(cache2, str(tmp), interval_s=3600).restore()
    for a, b in zip(engines, engines2):
        np.testing.assert_array_equal(a.export_counts(), b.export_counts())
    one = _req(P, ["ck0"])
    codes = _codes(cache2.do_limit(_req(P, ["ck0"], hits=4), _rules(cfg, one)))
    codes += _codes(cache2.do_limit(one, _rules(cfg, one)))
    assert restored == 3 and codes == ["OK", "OVER_LIMIT"]
    return dict(restored=restored, codes=codes, counts=[int(e.export_counts().sum()) for e in engines2])


def lane_flush_and_close_cover_all_dispatchers(P, tmp):
    cache, _ = _make_cache(P, 4, batch_window_us=500)
    req = _req(P, [f"f{i}" for i in range(16)])
    cache.do_limit(req, _rules(_cfg(P), req))
    cache.flush()
    n = len(cache._dispatchers)
    cache.close()
    assert n == 4 and cache._dispatchers == {}
    return n


def runner_builds_lanes_from_settings(P, tmp):
    s = P.Settings(
        backend_type=P.backend, tpu_num_lanes=3, tpu_num_slots=1 << 8,
        tpu_batch_window_us=0, use_statsd=False,
    )
    cache = P.create_limiter(s, P.time.PinnedTimeSource(1_000_000))
    per_lane = [e.model.num_slots for e in cache.lanes]
    assert per_lane == [86, 85, 85]
    req = _req(P, ["rn"])
    codes = [cache.do_limit(req, _rules(_cfg(P), req))[0].code.name for _ in range(6)]
    assert codes == ["OK"] * 5 + ["OVER_LIMIT"]
    return dict(per_lane=per_lane, codes=codes)


def topology_change_refuses_cross_role_restore(P, tmp):
    cache, _ = _make_cache(P, 2)
    req = _req(P, [f"tc{i}" for i in range(16)])
    cache.do_limit(req, _rules(_cfg(P), req))
    P.cp.CheckpointManager(cache, str(tmp), interval_s=3600).checkpoint()
    cache2 = P.Cache(
        P.engine(), time_source=P.time.PinnedTimeSource(1_000_000),
        per_second_engine=P.engine(),
    )
    restored = P.cp.CheckpointManager(cache2, str(tmp), interval_s=3600).restore()
    live = len(cache2.per_second_engine.slot_table)
    assert restored == 0 and live == 0
    return dict(restored=restored, live=live)


def lanes_compose_with_sharded_engines(P, tmp):
    s = P.Settings(
        backend_type=P.sharded_backend, tpu_num_lanes=2, tpu_num_slots=1 << 9,
        tpu_batch_window_us=0, tpu_batch_buckets=[8, 32], use_statsd=False,
    )
    cache = P.create_limiter(s, P.time.PinnedTimeSource(1_000_000))
    assert len(cache.lanes) == 2 and all(isinstance(e, P.Sharded) for e in cache.lanes)
    cfg = _cfg(P)
    req = _req(P, [f"sl{i}" for i in range(16)] + ["sl0"])
    first = _codes(cache.do_limit(req, _rules(cfg, req)))
    one = _req(P, ["sl0"])
    codes = [cache.do_limit(one, _rules(cfg, one))[0].code.name for _ in range(4)]
    total = sum(int(e.export_counts().sum()) for e in cache.lanes)
    assert codes == ["OK"] * 3 + ["OVER_LIMIT"] and total == 15 + 6
    return dict(first=first, codes=codes, total=total,
                per_lane=[int(e.export_counts().sum()) for e in cache.lanes])


def lanes_serve_over_the_wire_batched(P, tmp):
    config_dir = tmp / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "lanes.yaml").write_text(YAML)
    r = P.runner.Runner(
        P.Settings(
            host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
            debug_host="127.0.0.1", debug_port=0, use_statsd=False,
            backend_type=P.backend, tpu_num_lanes=2, tpu_num_slots=1 << 10,
            tpu_batch_window_us=200, tpu_batch_buckets=[8, 32],
            runtime_path=str(tmp), runtime_subdirectory="ratelimit",
            local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
        ),
        time_source=P.time.PinnedTimeSource(1_000_000),
        **P.runner_kw,
    )
    r.start()
    try:
        assert len(r.cache.lanes) == 2
        addr = f"127.0.0.1:{r.grpc_server.bound_port}"
        with grpc.insecure_channel(addr) as ch:
            method = ch.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )

            def call(value):
                q = rls_pb2.RateLimitRequest(domain="lanes")
                e = q.descriptors.add().entries.add()
                e.key, e.value = "key1", value
                return method(q, timeout=30).overall_code

            spread = [call(f"w{i}") for i in range(16)]
            r.cache.flush()
            live = [len(e.slot_table) for e in r.cache.lanes]
            codes = [call("w0") for _ in range(5)]
        OK, OVER = rls_pb2.RateLimitResponse.OK, rls_pb2.RateLimitResponse.OVER_LIMIT
        assert spread == [OK] * 16 and all(live) and codes == [OK] * 4 + [OVER]
        return dict(spread=spread, live=live, codes=codes)
    finally:
        r.stop()


SCENARIOS = [
    lanes_enforce_one_limit_exactly,
    keys_spread_across_lanes_and_stay_put,
    batched_lanes_count_exactly_under_concurrency,
    lane_checkpoint_round_trip,
    lane_flush_and_close_cover_all_dispatchers,
    runner_builds_lanes_from_settings,
    topology_change_refuses_cross_role_restore,
    lanes_compose_with_sharded_engines,
    lanes_serve_over_the_wire_batched,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_lane_scenario_same_in_both_packages(scenario, tmp_path):
    outcomes = []
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        outcomes.append(scenario(P, d))
    assert outcomes[1] == outcomes[0]


def test_lane_slot_split_distributes_remainder():
    for total, lanes in [(1 << 20, 3), (1030, 4), (256, 3), (7, 7), (8, 3), (1 << 20, 4), (2, 4)]:
        split = port_runner.lane_slot_split(total, lanes)
        assert split == jax_runner.lane_slot_split(total, lanes)
        assert len(split) == lanes
        if total >= lanes:
            assert sum(split) == total and max(split) - min(split) <= 1
    assert port_runner.lane_slot_split(2, 4) == [1, 1, 1, 1]
    assert port_runner.lane_slot_split(1 << 20, 4) == [1 << 18] * 4


# ---------------------------------------------------------------------------
# the bank topology as a whole
# ---------------------------------------------------------------------------


#: Per-bank stats the port publishes beside the JAX package's: the
#: slot table's last sweep (µs, keys freed) and sweeps run, and its
#: probe cells, rehashes and host index bytes.
PORT_BANK_STATS = (".gc_freed", ".gc_sweeps", ".gc_us", ".probes", ".rehashes", ".index_bytes")


def _topology(P, n_lanes, per_second, algos):
    lanes = [P.engine(64, buckets=(8,)) for _ in range(n_lanes)]
    cache = P.Cache(
        lanes if n_lanes > 1 else lanes[0],
        time_source=P.time.PinnedTimeSource(1_000_000),
        per_second_engine=P.engine(64, buckets=(8,)) if per_second else None,
        algorithm_banks={name: P.algo(name, 64) for name in algos} or None,
        batch_window_us=100,
    )
    store = P.Manager().store
    cache.register_stats(store)
    names = sorted(
        d._thread.name.replace(P.dispatcher_prefix, "DISPATCHER")
        for d in cache._dispatchers.values()
    )
    out = dict(
        labels=list(cache._bank_labels),
        roles=P.cp.bank_roles(cache),
        dispatchers=names,
        stats=sorted(
            k for k in {**store.counter_fn_values(), **store.snapshot()} if ".bank" in k
        ),
    )
    cache.close()
    return out


@pytest.mark.parametrize(
    "n_lanes,per_second,algos",
    [
        (1, False, ()),
        (1, False, ("gcra", "sliding_window")),
        (4, False, ()),
        (1, True, ("gcra",)),
        (4, True, ("gcra", "sliding_window")),
    ],
)
def test_bank_names_are_the_jax_packages(n_lanes, per_second, algos):
    """Bank labels (traces), checkpoint roles (files, /debug/faults),
    dispatcher thread names and the per-bank stats names follow the
    reference's bank order: lanes, the per-second bank, the algorithm
    banks.  The default boot's names are unchanged (one lane: lane0,
    lane0of1, the plain dispatcher name).  The port adds its slot
    table's sweep and index gauges to every bank (PORT_BANK_STATS); every other
    name is the JAX package's."""
    want = _topology(JAX, n_lanes, per_second, algos)
    got = _topology(PORT, n_lanes, per_second, algos)
    banks = sorted({re.match(r"(.*\.bank\d+)\.", k).group(1) for k in want["stats"]})
    added = sorted(b + s for b in banks for s in PORT_BANK_STATS)
    assert [k for k in got["stats"] if k.endswith(PORT_BANK_STATS)] == added
    got["stats"] = [k for k in got["stats"] if k not in added]
    assert got == want


def lane_quarantined_and_restarted_alone(P):
    """A stalled lane is quarantined on its own: the other lanes keep
    their dispatchers and serve on, the stalled lane's keys answer from
    its mirror, and the restart forgives no window."""
    inj = Injector()
    clock = P.time.FakeMonotonicClock(100.0)
    lanes = [inj.wrap(f"lane{i}", P.engine(buckets=(8,))) for i in range(3)]
    cache = P.Cache(
        lanes,
        time_source=P.time.PinnedTimeSource(1234),
        batch_window_us=100,
        kernel_deadline_s=0.25,
        fault_interval_s=0,
        fault_clock=clock,
        fault_restart_backoff_s=0.05,
        fault_snapshot_interval_s=1000.0,
        fault_probe_timeout_s=10.0,
    )
    fd = cache.fault_domain
    cfg = _cfg(P)
    values = [f"q{i}" for i in range(12)]
    by_lane = {}
    for v in values:
        req = _req(P, [v], 1)
        cache.do_limit(req, _rules(cfg, req))
    for lane, eng in enumerate(cache.lanes):
        for k, _s, _e in eng.slot_table.entries():
            by_lane.setdefault(lane, []).append(k)
    victim = 1
    victim_value = sorted(by_lane[victim])[0].split("_")[2]
    other_value = sorted(by_lane[0])[0].split("_")[2]
    try:
        assert fd.snapshot_now() == 3
        inj.set(f"lane{victim}", "raise")
        codes = {}
        for v in (victim_value, other_value):
            req = _req(P, [v], 1)
            codes[v] = [cache.do_limit(req, _rules(cfg, req))[0].code.name for _ in range(2)]
        quarantined = [fd.is_quarantined(b) for b in range(3)]
        inj.heal()
        for _ in range(50):
            if not fd.is_quarantined(victim):
                break
            clock.advance(0.06)
            fd.tick()
        for v in (victim_value, other_value):
            req = _req(P, [v], 1)
            codes[v] += [cache.do_limit(req, _rules(cfg, req))[0].code.name for _ in range(4)]
        assert quarantined == [False, True, False]
        for v in (victim_value, other_value):
            assert codes[v] == ["OK"] * 4 + ["OVER_LIMIT"] * 2, codes
        return dict(
            quarantined=quarantined,
            codes=sorted(codes.values()),
            faults=dict(fd.stat_faults),
            fallback=fd.stat_fallback_decisions,
            restarts=[r.restarts for r in fd._records],
            roles=[r.role for r in fd._records],
        )
    finally:
        inj.heal()
        cache.close()


def test_lane_quarantined_and_restarted_alone_in_both_packages():
    assert lane_quarantined_and_restarted_alone(PORT) == lane_quarantined_and_restarted_alone(JAX)


def test_one_dead_lane_flips_process_not_serving():
    """Every lane's dispatcher reports into the health: one dead lane
    (no fault domain) flips the process NOT_SERVING while the others
    serve their keys (tests/test_backend_health.py:207)."""
    import time as _t

    class _FakeHealth:
        def __init__(self):
            self.calls = []

        def ok(self):
            self.calls.append("ok")

        def fail(self):
            self.calls.append("fail")

    lanes = [PORT.engine(buckets=(8,)) for _ in range(3)]
    cache = CudaRateLimitCache(lanes, batch_window_us=100)
    try:
        h = _FakeHealth()
        cache.bind_health(h)
        assert len(cache._dispatchers) == 3
        victim = cache._dispatchers[id(lanes[1])]
        with victim._buf_cv:  # a poison entry kills the collector
            victim._buf.append(object())
            victim._buf_cv.notify()
        deadline = _t.monotonic() + 5
        while (victim.dead is None or not h.calls) and _t.monotonic() < deadline:
            _t.sleep(0.01)
        assert h.calls == ["fail"]
    finally:
        cache.close()


# ---------------------------------------------------------------------------
# no two live banks share a CUDA stream
# ---------------------------------------------------------------------------


class FakeStream:
    def __init__(self, handle):
        self.cuda_stream = handle
        self.busy = False

    def query(self):
        return not self.busy


class FakePool:
    """torch's stream pool as it behaves: `size` streams handed out in
    turn, whoever holds them."""

    def __init__(self, size):
        self.size = size
        self.drawn = 0
        self.created = 0

    def __call__(self, device):
        self.drawn += 1
        return FakeStream(1000 + self.drawn % self.size)

    def create(self, device):
        self.created += 1
        return FakeStream(5000 + self.created)


@pytest.fixture
def pool(monkeypatch):
    """A fake pool of 8 streams behind every engine, the CPU ones too,
    and fake streams of their own past it."""
    fake = FakePool(8)
    monkeypatch.setattr(engine_mod, "_draw_stream", fake)
    monkeypatch.setattr(engine_mod, "_create_stream", fake.create)
    monkeypatch.setattr(engine_mod, "_OWN_STREAMS", {})
    monkeypatch.setattr(engine_mod, "STREAM_POOL_SIZE", 8)
    return fake


def _no_stream_of_its_own(device):
    raise RuntimeError("cudaStreamCreate failed")


def test_the_factory_never_returns_a_live_banks_stream(pool):
    """Seven live banks (four lanes, the per-second bank, two algorithm
    banks) on a pool of 8: restart one bank twenty times.  A plain draw
    would give the new engine a live bank's stream once the pool wraps
    (the reference's factory only avoids the old engine's); the claim
    never does, the old engine's stream included, across restarts."""
    banks = [PORT.engine(64, buckets=(8,)) for _ in range(5)]
    banks += [PORT.algo("gcra", 64), PORT.algo("sliding_window", 64)]
    handles = [b._stream.cuda_stream for b in banks]
    assert len(set(handles)) == 7
    for restart in range(20):
        bank = restart % len(banks)
        old = banks[bank]
        new = default_engine_factory(bank, old)
        live = {b._stream.cuda_stream for b in banks}
        assert new._stream.cuda_stream not in live, (restart, new._stream.cuda_stream, live)
        banks[bank] = new
        release_stream(old)
        del old
    assert len({b._stream.cuda_stream for b in banks}) == 7


def test_each_bank_group_holds_a_stream_of_its_own(pool):
    """An engine of 8 banks in groups claims one stream a CARD: the 4
    groups of one card share its one stream, and 8 groups round robin
    over 4 cards (the CPU's cpu:0..3) hold 4, each card's plan naming
    its own; no two cards, and no card and another live bank, share a
    stream.  The release gives back all four, and a busy stream on any
    one card keeps the engine's streams busy (fault_domain waits for
    it)."""
    one_card = ShardedCounterEngine(make_mesh(8, devices=("cpu",) * 4), num_slots=64,
                                    buckets=(8,))
    assert one_card._more_streams == () and one_card._stream is not None
    release_stream(one_card)
    grouped = ShardedCounterEngine(
        make_mesh(8, devices=[f"cpu:{i % 4}" for i in range(8)]), num_slots=64, buckets=(8,))
    banks = [PORT.engine(64, buckets=(8,)) for _ in range(3)]
    mine = [s.cuda_stream for s in (grouped._stream, *grouped._more_streams)]
    assert len(set(mine)) == 4
    assert [c.stream.cuda_stream for c in grouped._cards] == mine
    assert [c.groups for c in grouped._cards] == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert set(mine).isdisjoint(b._stream.cuda_stream for b in banks)
    assert all(engine_mod._HELD_STREAMS[h] is grouped for h in mine)
    assert engine_mod.stream_idle(grouped)
    grouped._more_streams[1].busy = True
    assert not engine_mod.stream_idle(grouped)
    grouped._more_streams[1].busy = False
    release_stream(grouped)
    assert not set(mine) & set(engine_mod._HELD_STREAMS)
    assert len({b._stream.cuda_stream for b in banks}) == 3


def _four_cards():
    """8 banks in 4 groups, one a card of the CPU (cpu:0..3)."""
    return make_mesh(8, devices=[f"cpu:{i}" for i in range(4)])


def test_a_grouped_engine_that_fails_to_build_holds_no_stream(pool, monkeypatch):
    """The groups' streams are claimed before the table is made: where
    making it raises, every stream the engine claimed is given back, so
    no later engine -- a restarted bank among them -- finds it held.  On
    a pool of 8 and no stream of its own, two engines of 4 groups on 4
    cards then still find their 8."""
    real = ShardedCounterEngine._fresh_state

    def no_table(self):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(ShardedCounterEngine, "_fresh_state", no_table)
    with pytest.raises(RuntimeError, match="out of memory") as failed:
        ShardedCounterEngine(_four_cards(), num_slots=64, buckets=(8,))
    # The traceback keeps the half-built engine alive: only the release
    # frees its streams.
    assert failed.value.__traceback__ is not None
    assert not any(
        isinstance(e, ShardedCounterEngine) for e in engine_mod._HELD_STREAMS.values()
    )
    monkeypatch.setattr(ShardedCounterEngine, "_fresh_state", real)
    monkeypatch.setattr(engine_mod, "_create_stream", _no_stream_of_its_own)
    engines = [
        ShardedCounterEngine(_four_cards(), num_slots=64, buckets=(8,))
        for _ in range(2)
    ]
    held = [s.cuda_stream for e in engines for s in (e._stream, *e._more_streams)]
    assert len(set(held)) == 8
    for e in engines:
        release_stream(e)


def test_an_exhausted_pool_refuses_a_new_bank(pool, monkeypatch):
    """Every stream of the pool held and no stream of its own to be
    made: the new bank is refused, never handed a live bank's stream."""
    monkeypatch.setattr(engine_mod, "_create_stream", _no_stream_of_its_own)
    banks = [PORT.engine(64, buckets=(8,)) for _ in range(8)]
    with pytest.raises(RuntimeError, match="cudaStreamCreate failed"):
        PORT.engine(64, buckets=(8,))
    release_stream(banks[3])
    assert PORT.engine(64, buckets=(8,))._stream.cuda_stream == banks[3]._stream.cuda_stream


def test_past_the_pool_each_bank_gets_a_stream_of_its_own(pool):
    """More banks than the pool has streams: each bank past the pool
    gets a stream made for it, and a released one serves the next bank
    instead of a new one."""
    banks = [PORT.engine(64, buckets=(8,)) for _ in range(11)]
    assert len({b._stream.cuda_stream for b in banks}) == 11
    assert pool.created == 3
    gone = banks.pop(9)
    freed = gone._stream.cuda_stream
    release_stream(gone)
    banks.append(PORT.engine(64, buckets=(8,)))
    assert pool.created == 3 and banks[-1]._stream.cuda_stream == freed
    assert len({b._stream.cuda_stream for b in banks}) == 11


def test_a_collected_engine_gives_its_stream_back(pool):
    first = claim_stream(engine_mod.torch.device("cuda"), holder := PORT.engine(64, buckets=(8,)))
    assert first.cuda_stream != holder._stream.cuda_stream
    held = {holder._stream.cuda_stream, first.cuda_stream}
    engines = [PORT.engine(64, buckets=(8,)) for _ in range(6)]
    assert {e._stream.cuda_stream for e in engines}.isdisjoint(held)
    del engines
    assert len([PORT.engine(64, buckets=(8,)) for _ in range(6)]) == 6


def test_close_gives_back_the_streams_of_retired_engines(pool):
    """A cache's close() releases every engine it held, restarted ones
    too: the next cache's banks have the whole pool again."""
    cache = CudaRateLimitCache(
        [PORT.engine(64, buckets=(8,)) for _ in range(4)],
        batch_window_us=100,
        kernel_deadline_s=0.25,
        fault_interval_s=0,
    )
    fd = cache.fault_domain
    fd.record_fault(2, "hang")
    fd._try_restart(2, fd._records[2], 1e9)
    assert not fd.is_quarantined(2) and len(cache._retired) == 1
    assert len({e._stream.cuda_stream for e in cache.engines()}) == 4
    cache.close()
    retired = [e for e, _ in cache._retired]
    assert not engine_mod._HELD_STREAMS or all(
        e not in cache.engines() + retired for e in engine_mod._HELD_STREAMS.values()
    )


def _four_lanes_on_the_pool():
    return CudaRateLimitCache(
        [PORT.engine(64, buckets=(8,)) for _ in range(4)],
        batch_window_us=100,
        kernel_deadline_s=0.25,
        fault_interval_s=0,
    )


def _quarantine_and_restart(cache, bank):
    """Quarantine `bank`, wait for its killed dispatcher's threads to
    return, then run one supervised restart."""
    fd = cache.fault_domain
    old_d = cache._dispatchers[id(cache.engines()[bank])]
    fd.record_fault(bank, "hang")
    deadline = time.monotonic() + 10
    while not old_d.exited():
        assert time.monotonic() < deadline, "killed dispatcher never returned"
        time.sleep(0.005)
    fd._try_restart(bank, fd._records[bank], 1e9)
    assert not fd.is_quarantined(bank)


def test_restarts_outnumber_the_pool(pool, monkeypatch):
    """Twenty supervised restarts of four lanes on a pool of 8 streams,
    with no stream of its own to be made: a replaced engine gives its
    stream back once its dispatcher has returned and its stream is idle
    (release_retired, before each restart), so every restart finds a
    free stream.  Held for good, the replaced streams would run the pool
    dry at the fifth restart."""
    monkeypatch.setattr(engine_mod, "_create_stream", _no_stream_of_its_own)
    cache = _four_lanes_on_the_pool()
    fd = cache.fault_domain
    try:
        for restart in range(20):
            bank = restart % 4
            _quarantine_and_restart(cache, bank)
            assert fd._records[bank].restarts == restart // 4 + 1
            assert len({e._stream.cuda_stream for e in cache.engines()}) == 4
            assert len(cache._retired) == 1
    finally:
        cache.close()


def test_a_stalled_stream_stays_held_until_it_drains(pool, monkeypatch):
    """A bank whose stream is still stalled stays quarantined and keeps
    that stream through the restarts of the other banks: its own restart
    waits for the stream (fault_domain._try_restart), and no new engine
    draws it.  Once the stream drains, the bank restarts and the next
    release gives the stream back."""
    monkeypatch.setattr(engine_mod, "_create_stream", _no_stream_of_its_own)
    cache = _four_lanes_on_the_pool()
    fd = cache.fault_domain
    try:
        stalled = cache.engines()[1]
        handle = stalled._stream.cuda_stream
        stalled._stream.busy = True
        old_d = cache._dispatchers[id(stalled)]
        fd.record_fault(1, "hang")
        deadline = time.monotonic() + 10
        while not old_d.exited():
            assert time.monotonic() < deadline, "killed dispatcher never returned"
            time.sleep(0.005)
        fd._try_restart(1, fd._records[1], 1e9)
        assert fd.is_quarantined(1) and cache.engines()[1] is stalled
        for restart in range(6):
            _quarantine_and_restart(cache, (0, 2, 3)[restart % 3])
            others = [e for b, e in enumerate(cache.engines()) if b != 1]
            assert handle not in {e._stream.cuda_stream for e in others}
            assert engine_mod._HELD_STREAMS.get(handle) is stalled
        assert cache.release_retired() == 1
        stalled._stream.busy = False
        fd._try_restart(1, fd._records[1], 1e9)
        assert not fd.is_quarantined(1) and cache.engines()[1] is not stalled
        assert cache.release_retired() == 1
        assert handle not in engine_mod._HELD_STREAMS
        assert cache._retired == []
    finally:
        cache.close()
