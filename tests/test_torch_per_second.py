"""The per-second bank (TPU_PERSECOND) of the port against the JAX
package's, and the whole bank topology booted from the environment, on
the CPU.

The JAX package's per-second scenarios run through both packages with
the same inputs (tolerance 0): SECOND-unit keys route to the per-second
bank and nothing else does (tests/test_backends.py:157,
tests/test_parity_scenarios.py:54), a second window rolls
(tests/test_parity_scenarios.py:74), a Runner wires the bank and shows it
in the bank gauges (tests/test_server_integration.py:532), SECOND-unit
rules on the sharded backend with and without a per-second bank
(tests/test_sharded_server.py:141,222), and health waits for every
bank's dispatcher (tests/test_backend_health.py:176); the per-second bank
is quarantined and restarted on its own.  Then the port's Runner booted
with TPU_NUM_LANES=4, TPU_PERSECOND=true and TPU_CHECKPOINT_DIR on
``cuda`` and on ``cuda-sharded``: every lane and the per-second bank
serve, the drain's checkpoint lets a second runner admit exactly the
rest of each limit, and a runner with another lane count refuses the
lane files by role and starts fresh.
"""

import urllib.request
from types import SimpleNamespace

import grpc
import pytest

from test_torch_fault_domain import Injector

from ratelimit_tpu import api as jax_api
from ratelimit_tpu import runner as jax_runner
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch import runner as port_runner
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.settings import Settings, new_settings
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils import time as port_time

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = """
domain: p
descriptors:
  - key: persec
    rate_limit:
      unit: second
      requests_per_unit: 2
  - key: perminute
    rate_limit:
      unit: minute
      requests_per_unit: 3
  - key: limited
    rate_limit:
      unit: minute
      requests_per_unit: 4
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    Cache=TpuRateLimitCache,
    loader=jax_loader,
    Manager=JaxManager,
    time=jax_time,
    Settings=JaxSettings,
    Runner=jax_runner.Runner,
    engine=lambda ns=64, **kw: JaxEngine(num_slots=ns, **kw),
    sharded=lambda: JaxShardedEngine(jax_make_mesh(8), num_slots=1 << 10, buckets=(8, 32)),
    Sharded=JaxShardedEngine,
    runner_kw={},
    backend="tpu",
    sharded_backend="tpu-sharded",
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    Cache=CudaRateLimitCache,
    loader=loader,
    Manager=Manager,
    time=port_time,
    Settings=Settings,
    Runner=port_runner.Runner,
    engine=lambda ns=64, **kw: CounterEngine(num_slots=ns, device="cpu", **kw),
    sharded=lambda: ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=1 << 10, buckets=(8, 32)),
    Sharded=ShardedCounterEngine,
    runner_kw={"device": "cpu"},
    backend="cuda",
    sharded_backend="cuda-sharded",
)
BOTH = (JAX, PORT)
OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT


def _limits(cfg, req):
    return [cfg.get_limit(req.domain, d) for d in req.descriptors]


def _cfg(P):
    return P.loader.load_config([P.loader.ConfigFile("config.p", YAML)], P.Manager())


def _request(P, pairs, hits=1):
    return P.api.RateLimitRequest("p", [P.api.Descriptor.of(p) for p in pairs], hits)


# ---------------------------------------------------------------------------
# cache-level scenarios
# ---------------------------------------------------------------------------


def per_second_bank_routing(P, buckets):
    kw = {"buckets": buckets} if buckets else {}
    main, persec = P.engine(128 if buckets else 64, **kw), P.engine(128 if buckets else 64, **kw)
    cache = P.Cache(main, time_source=P.time.PinnedTimeSource(1234), per_second_engine=persec)
    cfg = _cfg(P)
    req = _request(P, [("persec", "a"), ("perminute", "a")])
    codes = [s.code.name for s in cache.do_limit(req, _limits(cfg, req))]
    assert codes == ["OK", "OK"]
    assert (len(persec.slot_table), len(main.slot_table)) == (1, 1)
    return dict(
        codes=codes,
        persec=sorted(k for k, _s, _e in persec.slot_table.entries()),
        main=sorted(k for k, _s, _e in main.slot_table.entries()),
    )


@pytest.mark.parametrize("buckets", [(8,), None], ids=["backends", "parity"])
def test_per_second_bank_routing(buckets):
    assert per_second_bank_routing(PORT, buckets) == per_second_bank_routing(JAX, buckets)


def per_second_window_rolls(P, per_second):
    clock = P.time.PinnedTimeSource(1234)
    cache = P.Cache(
        P.engine(), time_source=clock,
        per_second_engine=P.engine() if per_second else None,
    )
    cfg = _cfg(P)
    req = _request(P, [("persec", "a")])
    limits = _limits(cfg, req)
    codes = [cache.do_limit(req, limits)[0].code.name for _ in range(3)]
    clock.now += 1  # the next second: a new window, a new key
    codes.append(cache.do_limit(req, limits)[0].code.name)
    assert codes == ["OK", "OK", "OVER_LIMIT", "OK"]
    return codes


@pytest.mark.parametrize("per_second", [False, True], ids=["one_bank", "per_second_bank"])
def test_per_second_window_rolls(per_second):
    assert per_second_window_rolls(PORT, per_second) == per_second_window_rolls(JAX, per_second)


def per_second_on_sharded_engines(P, per_second):
    """SECOND-unit rules on sharded banks: in the one bank set without a
    per-second bank, in their own sharded bank with one."""
    main = P.sharded()
    persec = P.sharded() if per_second else None
    cache = P.Cache(main, time_source=P.time.PinnedTimeSource(1234), per_second_engine=persec)
    cfg = _cfg(P)
    out = {}
    for key, n in (("persec", 3), ("limited", 6)):
        req = _request(P, [(key, "dual")])
        out[key] = [cache.do_limit(req, _limits(cfg, req))[0].code.name for _ in range(n)]
    assert out["persec"] == ["OK", "OK", "OVER_LIMIT"]
    assert out["limited"] == ["OK"] * 4 + ["OVER_LIMIT"] * 2
    out["main"] = int(main.export_counts().sum())
    if persec is not None:
        out["persec_bank"] = int(persec.export_counts().sum())
        assert (out["main"], out["persec_bank"]) == (6, 3)
    return out


@pytest.mark.parametrize("per_second", [False, True], ids=["one_bank_set", "dual_bank"])
def test_per_second_on_sharded_engines(per_second):
    assert per_second_on_sharded_engines(PORT, per_second) == per_second_on_sharded_engines(
        JAX, per_second
    )


def health_requires_every_dispatcher_healthy(P):
    """Two banks (main + per-second) both down: one recovering must not
    flip the service back to SERVING while the other is still failing.
    The JAX package calls fail() on every report, the port on the
    transition: the sequence of state CHANGES is the same."""

    class _FakeHealth:
        def __init__(self):
            self.calls = []

        def ok(self):
            self.calls.append("ok")

        def fail(self):
            self.calls.append("fail")

    main, per_second = P.engine(256, buckets=(8,)), P.engine(256, buckets=(8,))
    cache = P.Cache(main, per_second_engine=per_second, batch_window_us=100)
    try:
        health = _FakeHealth()
        cache.bind_health(health)
        d_main, d_ps = cache._dispatchers[id(main)], cache._dispatchers[id(per_second)]
        d_main.on_state(False, "bank0 down")
        d_ps.on_state(False, "bank1 down")
        both_down = list(health.calls)
        d_main.on_state(True, "bank0 back")
        one_back = list(health.calls)
        d_ps.on_state(True, "bank1 back")
        assert "ok" not in one_back and health.calls[-1] == "ok"
        assert health.calls.count("ok") == 1
        changes = [c for i, c in enumerate(health.calls) if i == 0 or c != health.calls[i - 1]]
        return dict(
            down=both_down[-1], ok_while_one_down="ok" in one_back, changes=changes
        )
    finally:
        cache.close()


def test_health_requires_every_dispatcher_healthy():
    assert health_requires_every_dispatcher_healthy(PORT) == (
        health_requires_every_dispatcher_healthy(JAX)
    )


def per_second_bank_quarantined_alone(P):
    """A failing per-second bank is quarantined on its own and answered
    by its mirror; the lane serves on; the restart forgives nothing."""
    inj = Injector()
    clock = P.time.FakeMonotonicClock(100.0)
    cache = P.Cache(
        P.engine(buckets=(8,)),
        time_source=P.time.PinnedTimeSource(1234),
        per_second_engine=inj.wrap("per_second", P.engine(buckets=(8,))),
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
    sec = _request(P, [("persec", "q")])
    minute = _request(P, [("perminute", "q")])
    try:
        codes = [cache.do_limit(sec, _limits(cfg, sec))[0].code.name]
        assert fd.snapshot_now() == 2
        inj.set("per_second", "raise")
        codes.append(cache.do_limit(sec, _limits(cfg, sec))[0].code.name)
        lane_codes = [cache.do_limit(minute, _limits(cfg, minute))[0].code.name for _ in range(2)]
        quarantined = [fd.is_quarantined(b) for b in range(2)]
        inj.heal()
        for _ in range(50):
            if not fd.is_quarantined(1):
                break
            clock.advance(0.06)
            fd.tick()
        codes.append(cache.do_limit(sec, _limits(cfg, sec))[0].code.name)
        lane_codes += [cache.do_limit(minute, _limits(cfg, minute))[0].code.name for _ in range(2)]
        assert quarantined == [False, True]
        assert codes == ["OK", "OK", "OVER_LIMIT"] and lane_codes == ["OK"] * 3 + ["OVER_LIMIT"]
        return dict(
            codes=codes, lane=lane_codes, quarantined=quarantined,
            roles=[r.role for r in fd._records], restarts=[r.restarts for r in fd._records],
            faults=dict(fd.stat_faults),
        )
    finally:
        inj.heal()
        cache.close()


def test_per_second_bank_quarantined_alone():
    assert per_second_bank_quarantined_alone(PORT) == per_second_bank_quarantined_alone(JAX)


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------


def _runner(P, tmp, **settings):
    config_dir = tmp / "ratelimit" / "config"
    config_dir.mkdir(parents=True, exist_ok=True)
    (config_dir / "p.yaml").write_text(YAML)
    base = dict(
        host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
        debug_host="127.0.0.1", debug_port=0, use_statsd=False,
        tpu_batch_window_us=200, tpu_batch_buckets=[8, 32],
        runtime_path=str(tmp), runtime_subdirectory="ratelimit",
        local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
    )
    kw = dict(P.runner_kw)
    if P is PORT and settings.get("backend_type") == "cuda-sharded":
        kw["mesh"] = make_mesh(8, "cpu")
    return P.Runner(
        P.Settings(**{**base, **settings}),
        time_source=P.time.PinnedTimeSource(1_000_000),
        **kw,
    )


def _call(runner, key, value):
    with grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}") as ch:
        req = rls_pb2.RateLimitRequest(domain="p")
        e = req.descriptors.add().entries.add()
        e.key, e.value = key, value
        return ch.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )(req, timeout=30).overall_code


def per_second_bank_wired_through_runner(P, tmp):
    r = _runner(
        P, tmp, backend_type=P.backend, tpu_num_slots=1 << 10, tpu_per_second=True,
        tpu_per_second_num_slots=1 << 10,
    )
    r.start()
    try:
        assert r.cache.per_second_engine is not None
        codes = [_call(r, "persec", "x") for _ in range(3)]
        _call(r, "perminute", "y")
        r.cache.flush()
        live = (len(r.cache.per_second_engine.slot_table), len(r.cache.engine.slot_table))
        url = f"http://127.0.0.1:{r.debug_server.bound_port}/stats"
        with urllib.request.urlopen(url, timeout=30) as resp:
            text = resp.read().decode()
        banks = sorted(
            line for line in text.splitlines() if ".bank" in line and ".live_keys" in line
        )
        assert codes == [OK, OK, OVER] and live == (1, 1)
        assert "ratelimit.tpu.bank0.live_keys: 1" in banks
        assert "ratelimit.tpu.bank1.live_keys: 1" in banks
        return dict(codes=codes, live=live, banks=banks)
    finally:
        r.stop()


def sharded_dual_bank_per_second(P, tmp):
    r = _runner(
        P, tmp, backend_type=P.sharded_backend, tpu_num_slots=1 << 10,
        tpu_per_second=True, tpu_per_second_num_slots=1 << 10,
    )
    r.start()
    try:
        assert isinstance(r.cache.engine, P.Sharded)
        assert isinstance(r.cache.per_second_engine, P.Sharded)
        persec = [_call(r, "persec", "dual") for _ in range(3)]
        limited = [_call(r, "limited", "dual") for _ in range(6)]
        r.cache.flush()
        totals = (
            int(r.cache.per_second_engine.export_counts().sum()),
            int(r.cache.engine.export_counts().sum()),
        )
        assert persec == [OK, OK, OVER] and limited == [OK] * 4 + [OVER] * 2
        assert totals == (3, 6)
        return dict(persec=persec, limited=limited, totals=totals)
    finally:
        r.stop()


@pytest.mark.parametrize(
    "scenario",
    [per_second_bank_wired_through_runner, sharded_dual_bank_per_second],
    ids=lambda f: f.__name__,
)
def test_runner_scenario_same_in_both_packages(scenario, tmp_path):
    outcomes = []
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        outcomes.append(scenario(P, d))
    assert outcomes[1] == outcomes[0]


#: Settings the environment could carry into new_settings(); each boot
#: below starts from none of them.
TOPOLOGY_ENV = (
    "BACKEND_TYPE", "TPU_NUM_LANES", "TPU_PERSECOND", "TPU_PERSECOND_NUM_SLOTS",
    "TPU_CHECKPOINT_DIR", "TPU_CHECKPOINT_INTERVAL_S", "TPU_NUM_SLOTS",
    "TPU_ALGORITHM_BANKS", "TPU_ALGORITHM_NUM_SLOTS", "KERNEL_DEADLINE_S",
    "DEVICE_FAILURE_MODE", "TPU_BATCH_WINDOW_US", "DEBUG_PROFILING",
)

TOPOLOGY_YAML = YAML + """  - key: half
    rate_limit:
      unit: hour
      requests_per_unit: 6
"""


@pytest.fixture
def topology_env(tmp_path, monkeypatch):
    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "p.yaml").write_text(TOPOLOGY_YAML)
    for name in TOPOLOGY_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in dict(
        RUNTIME_ROOT=str(tmp_path), RUNTIME_SUBDIRECTORY="ratelimit",
        HOST="127.0.0.1", PORT="0", GRPC_HOST="127.0.0.1", GRPC_PORT="0",
        DEBUG_HOST="127.0.0.1", DEBUG_PORT="0", USE_STATSD="false",
        GC_TUNING="false", TPU_NUM_SLOTS=str(1 << 12),
        TPU_PERSECOND_NUM_SLOTS=str(1 << 10), TPU_ALGORITHM_NUM_SLOTS=str(1 << 10),
        TPU_CHECKPOINT_DIR=str(tmp_path / "ckpt"),
    ).items():
        monkeypatch.setenv(name, value)
    return monkeypatch


def _boot(backend):
    kw = {"mesh": make_mesh(8, "cpu")} if backend == "cuda-sharded" else {}
    r = port_runner.Runner(
        new_settings(), time_source=PORT.time.PinnedTimeSource(1_000_000), device="cpu", **kw
    )
    r.start()
    return r


@pytest.mark.parametrize("backend", ["cuda", "cuda-sharded"])
def test_topology_boots_serves_and_restarts_without_forgiving(topology_env, backend):
    """TPU_NUM_LANES=4, TPU_PERSECOND=true and TPU_CHECKPOINT_DIR from
    the environment, every other setting at its default (the fault
    domain armed, the two algorithm banks): keys land on all four lanes
    and the SECOND-unit key only in the per-second bank; half of each
    limit, stop() (the final checkpoint), a second runner on the same
    directory admits exactly the other half; a runner with two lanes
    refuses the lane files by role and starts fresh."""
    env = topology_env
    env.setenv("BACKEND_TYPE", backend)
    env.setenv("TPU_NUM_LANES", "4")
    env.setenv("TPU_PERSECOND", "true")
    values = [f"t{i}" for i in range(16)]
    r = _boot(backend)
    try:
        cache = r.cache
        assert len(cache.lanes) == 4 and cache.per_second_engine is not None
        assert [e.model.num_slots for e in cache.lanes] == [1 << 10] * 4
        assert cache.fault_domain is not None
        assert [rec.role for rec in cache.fault_domain._records] == [
            "lane0of4", "lane1of4", "lane2of4", "lane3of4", "per_second",
            "algo_gcra", "algo_sliding_window",
        ]
        first = [_call(r, "half", v) for v in values for _ in range(3)]
        sec = [_call(r, "persec", "s") for _ in range(3)]
        cache.flush()
        assert first == [OK] * 48 and sec == [OK, OK, OVER]
        assert all(len(e.slot_table) > 0 for e in cache.lanes)
        assert sum(len(e.slot_table) for e in cache.lanes) == 16
        assert [k for k, _s, _e in cache.per_second_engine.slot_table.entries()] == [
            "p_persec_s_1000000"
        ]
        assert cache.fault_domain.summary()["faults"] == {
            "hang": 0, "exception": 0, "device_lost": 0
        }
    finally:
        r.stop()

    r = _boot(backend)
    try:
        assert [len(e.slot_table) for e in r.cache.lanes] == [
            len(e.slot_table) for e in cache.lanes
        ]
        again = {v: [_call(r, "half", v) for _ in range(4)] for v in values}
        assert all(codes == [OK] * 3 + [OVER] for codes in again.values()), again
    finally:
        r.stop()

    # Two lanes: every bank index now names another role (bank2.npz is
    # lane2of4, the per-second bank's is bank4.npz), so nothing restores.
    env.setenv("TPU_NUM_LANES", "2")
    r = _boot(backend)
    try:
        assert [len(e.slot_table) for e in r.cache.engines()] == [0] * 5
        assert [_call(r, "half", "t0") for _ in range(2)] == [OK, OK]
    finally:
        r.stop()
