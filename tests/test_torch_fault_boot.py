"""The port's runner boots with the device fault domain armed, on the
CPU.

With every fault setting at its default (KERNEL_DEADLINE_S unset, so
0.25 s) the runner starts, arms the domain over all three banks and
serves over gRPC and over its HTTP listener (/json, /healthcheck on
both the API and the debug listener); the fault settings are read from the environment;
a TPU_CHECKPOINT_DIR with no positive interval is refused.  The ``cuda-sharded`` runner arms
the domain too, and a restart of its bank rebuilds what the JAX
package's factory rebuilds from a ``tpu-sharded`` bank.
"""

import json
import urllib.request

import grpc
import pytest

from ratelimit_tpu.backends.fault_domain import (
    default_engine_factory as jax_default_engine_factory,
)
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu_torch.backends.fault_domain import default_engine_factory
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import new_settings

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

CONFIG = """domain: rl
descriptors:
  - key: fw
    rate_limit:
      unit: minute
      requests_per_unit: 3
  - key: slide
    rate_limit:
      unit: minute
      requests_per_unit: 3
      algorithm: sliding_window
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 3
      algorithm: gcra
"""

#: Settings the environment could carry into new_settings(); each test
#: starts from none of them.
FAULT_ENV = (
    "BACKEND_TYPE",
    "DEBUG_PROFILING",
    "TRACE_SAMPLE_RATE",
    "TRACE_EXPORT_JSONL",
    "KERNEL_DEADLINE_S",
    "DEVICE_FAILURE_MODE",
    "DEVICE_RESTART_BACKOFF_S",
    "DEVICE_WATCHDOG_INTERVAL_S",
    "TPU_CHECKPOINT_DIR",
    "TPU_CHECKPOINT_INTERVAL_S",
    "TPU_ALGORITHM_BANKS",
    "TPU_NUM_SLOTS",
    "TPU_BATCH_WINDOW_US",
)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT


@pytest.fixture
def env(tmp_path, monkeypatch):
    """The environment of a boot with every default, but for where the
    config lives, free local ports for the three listeners (the HTTP
    and debug defaults, 0.0.0.0:8080 and :6070, would collide between
    tests running side by side), no statsd sink, and no gc.freeze() in
    the test process."""
    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "rl.yaml").write_text(CONFIG)
    for name in FAULT_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in dict(
        RUNTIME_ROOT=str(tmp_path),
        RUNTIME_SUBDIRECTORY="ratelimit",
        HOST="127.0.0.1",
        PORT="0",
        GRPC_HOST="127.0.0.1",
        GRPC_PORT="0",
        DEBUG_HOST="127.0.0.1",
        DEBUG_PORT="0",
        USE_STATSD="false",
        GC_TUNING="false",
    ).items():
        monkeypatch.setenv(name, value)
    return monkeypatch


def _codes(runner, key, n):
    with grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}") as channel:
        call = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        req = rls_pb2.RateLimitRequest(domain="rl")
        e = req.descriptors.add().entries.add()
        e.key, e.value = key, "x"
        return [call(req, timeout=30).overall_code for _ in range(n)]


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json_codes(runner, key, n):
    body = json.dumps(
        {"domain": "rl", "descriptors": [{"entries": [{"key": key, "value": "http"}]}]}
    ).encode()
    return [_http(runner.http_server.bound_port, "/json", body)[0] for _ in range(n)]


def test_runner_boots_with_every_default_and_serves(env):
    s = new_settings()
    assert s.kernel_deadline_s == 0.25 and s.device_failure_mode == "host"
    runner = Runner(s, device="cpu")
    runner.start()
    try:
        fd = runner.cache.fault_domain
        assert fd is not None and fd.kernel_deadline_s == 0.25
        assert fd.failure_mode == "host" and fd.restart_backoff_s == 2.0
        assert fd.snapshot_interval_s == 30.0 and fd._thread is not None
        assert [r.role for r in fd._records] == ["lane0of1", "algo_gcra", "algo_sliding_window"]
        for key in ("fw", "slide", "tb"):
            assert _codes(runner, key, 4) == [OK] * 3 + [OVER], key
            assert _json_codes(runner, key, 4) == [200] * 3 + [429], key
        for port in (runner.http_server.bound_port, runner.debug_server.bound_port):
            assert _http(port, "/healthcheck") == (200, b"OK")
        summary = fd.summary()
        assert summary["faults"] == {"hang": 0, "exception": 0, "device_lost": 0}
        assert summary["fallback_decisions"] == 0 and summary["quarantined_banks"] == 0
        assert runner.health.healthy and not runner.health.degraded
        values = runner.stats_manager.store.counter_fn_values()
        assert values["ratelimit.tpu.fault.hang"] == 0
        assert values["ratelimit.tpu.fault.fallback_decisions"] == 0
    finally:
        runner.stop()
    assert runner.cache.fault_domain is None  # close() stopped the supervisor


def test_trace_and_profiling_settings_take_effect(env, tmp_path):
    """TRACE_* configure the port's tracer (ring, sampling, the JSONL
    exporter, closed at stop) and DEBUG_PROFILING opens the captures."""
    from ratelimit_tpu_torch.observability import TRACER

    jsonl = tmp_path / "traces.jsonl"
    env.setenv("TRACE_SAMPLE_RATE", "1")
    env.setenv("TRACE_RING_SIZE", "4")
    env.setenv("TRACE_EXPORT_JSONL", str(jsonl))
    env.setenv("DEBUG_PROFILING", "1")
    runner = Runner(new_settings(), device="cpu")
    runner.start()
    try:
        assert _json_codes(runner, "fw", 6) == [200] * 3 + [429] * 3
        recent = TRACER.recent()
        assert len(recent) == 4 and TRACER.sample_rate == 1.0
        assert {"http.json", "kernel.step"} <= {s["name"] for s in recent[0].spans}
        port = runner.debug_server.bound_port
        status, out = _http(port, "/debug/profile?seconds=0.1")
        assert status == 200 and b"statistical cpu profile" in out
    finally:
        runner.stop()
        TRACER.configure(sample_rate=0.0, ring_size=256)
    assert TRACER._exporters == []
    lines = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [t["root"] for t in lines] == ["http.json"] * 6


def test_fault_settings_are_read_from_the_environment(env):
    env.setenv("KERNEL_DEADLINE_S", "0.5")
    env.setenv("DEVICE_FAILURE_MODE", "deny")
    env.setenv("DEVICE_RESTART_BACKOFF_S", "1.5")
    env.setenv("DEVICE_WATCHDOG_INTERVAL_S", "0.2")
    env.setenv("TPU_CHECKPOINT_INTERVAL_S", "7")
    runner = Runner(new_settings(), device="cpu")
    runner.start()
    try:
        fd = runner.cache.fault_domain
        assert (fd.kernel_deadline_s, fd.failure_mode) == (0.5, "deny")
        assert (fd.restart_backoff_s, fd.interval_s, fd.snapshot_interval_s) == (1.5, 0.2, 7.0)
    finally:
        runner.stop()


def test_checkpoint_dir_is_still_refused(env, tmp_path):
    """Checkpoint files are ported: a TPU_CHECKPOINT_DIR is refused only
    with no positive TPU_CHECKPOINT_INTERVAL_S, as by the JAX runner."""
    env.setenv("TPU_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    env.setenv("TPU_CHECKPOINT_INTERVAL_S", "0")
    runner = Runner(new_settings(), device="cpu")
    with pytest.raises(ValueError, match="TPU_CHECKPOINT_DIR"):
        runner.start()
    runner.stop()


def test_zero_deadline_builds_no_domain(env):
    env.setenv("KERNEL_DEADLINE_S", "0")
    runner = Runner(new_settings(), device="cpu")
    runner.start()
    try:
        assert runner.cache.fault_domain is None
        assert _codes(runner, "fw", 4) == [OK] * 3 + [OVER]
    finally:
        runner.stop()


def test_cuda_sharded_runner_arms_the_domain(env):
    env.setenv("BACKEND_TYPE", "cuda-sharded")
    env.setenv("TPU_NUM_SLOTS", str(1 << 12))
    runner = Runner(new_settings(), device="cpu", mesh=make_mesh(8, "cpu"))
    runner.start()
    try:
        fd = runner.cache.fault_domain
        assert isinstance(runner.cache.engine, ShardedCounterEngine)
        assert fd is not None and fd.kernel_deadline_s == 0.25
        assert _codes(runner, "fw", 4) == [OK] * 3 + [OVER]
        assert fd.summary()["faults"] == {"hang": 0, "exception": 0, "device_lost": 0}
    finally:
        runner.stop()


def test_sharded_bank_restarts_as_the_jax_factory_rebuilds_it():
    """The JAX factory rebuilds a tpu-sharded bank as ONE table of the
    same slot count on the default device; the port's does the same
    with a cuda-sharded bank, on the old bank's device."""
    jax_old = JaxShardedEngine(jax_make_mesh(8), num_slots=1 << 10, buckets=(8, 32))
    port_old = ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=1 << 10, buckets=(8, 32))
    jax_new = jax_default_engine_factory(0, jax_old)
    port_new = default_engine_factory(0, port_old)

    def shape(e):
        return (
            type(e).__name__,
            type(e.model).__name__,
            e.model.num_slots,
            tuple(e.buckets),
            e.algorithm,
        )

    assert shape(port_new) == shape(jax_new) == (
        "CounterEngine",
        "FixedWindowModel",
        1 << 10,
        (8, 32),
        "fixed_window",
    )
    assert port_new.device == port_old.device


@pytest.mark.parametrize("algo", ["sliding_window", "gcra"])
def test_factory_rebuilds_an_algorithm_bank_fresh(algo):
    from ratelimit_tpu_torch.backends.engine import CounterEngine
    from ratelimit_tpu_torch.models.registry import get_algorithm

    old = CounterEngine(
        buckets=(8,), device="cpu", model=get_algorithm(algo).make_model(64, 0.7, device="cpu")
    )
    new = default_engine_factory(1, old)
    assert new is not old and new.algorithm == algo
    assert (new.model.num_slots, new.model.near_ratio, new.buckets) == (64, 0.7, (8,))
    assert not new.export_state()[get_algorithm(algo).state_rows[0]].any()
