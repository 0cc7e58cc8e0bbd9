"""BACKEND_TYPE=cuda-sharded through a full Runner, against the JAX
package's tpu-sharded Runner.

The JAX runner serves its bank-sharded engine over the conftest's 8
virtual CPU devices; the port's runner serves 8 banks on the CPU (a
mesh on one device, ``make_mesh(8, "cpu")``).  Both answer the same gRPC
requests, and the responses must be byte-equal."""

import grpc
import numpy as np
import pytest
import torch

from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings, SettingsError, unported_settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = """
domain: sh
descriptors:
  - key: limited
    rate_limit:
      unit: minute
      requests_per_unit: 4
  - key: persec
    rate_limit:
      unit: second
      requests_per_unit: 2
"""

COMMON = dict(
    host="127.0.0.1",
    port=0,
    grpc_host="127.0.0.1",
    grpc_port=0,
    debug_host="127.0.0.1",
    debug_port=0,
    use_statsd=False,
    tpu_num_slots=1 << 10,
    tpu_batch_window_us=200,
    tpu_batch_buckets=[8, 32],
    local_cache_size_in_bytes=0,
    expiration_jitter_max_seconds=0,
    tpu_algorithm_banks="",
    gc_tuning=False,
)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded-runtime")
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "sh.yaml").write_text(YAML)
    paths = dict(runtime_path=str(root), runtime_subdirectory="ratelimit")
    jax_runner = JaxRunner(
        JaxSettings(backend_type="tpu-sharded", **COMMON, **paths),
        time_source=JaxPinned(1_000_000),
    )
    port_runner = Runner(
        Settings(backend_type="cuda-sharded", kernel_deadline_s=0.0, **COMMON, **paths),
        time_source=PinnedTimeSource(1_000_000),
        device="cpu",
        mesh=make_mesh(8, "cpu"),
    )
    jax_runner.start()
    try:
        port_runner.start()
        try:
            yield jax_runner, port_runner
        finally:
            port_runner.stop()
    finally:
        jax_runner.stop()


def _call(runner, payload: bytes):
    """Raw bytes in, raw bytes (or the status) out."""
    with grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}") as channel:
        method = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
        )
        try:
            return method(payload, timeout=30)
        except grpc.RpcError as e:
            return (e.code(), e.details())


def _request(key, value, hits=0):
    req = rls_pb2.RateLimitRequest(domain="sh", hits_addend=hits)
    e = req.descriptors.add().entries.add()
    e.key, e.value = key, value
    return req.SerializeToString()


def _both(runners, payload):
    """Send `payload` to both runners; assert byte-equal answers and
    return the port's, decoded."""
    jax_runner, port_runner = runners
    got = _call(port_runner, payload)
    assert got == _call(jax_runner, payload)
    return rls_pb2.RateLimitResponse.FromString(got)


def test_sharded_backend_is_wired(runners):
    engine = runners[1].cache.engine
    assert isinstance(engine, ShardedCounterEngine)
    assert engine.model.num_banks == 8
    assert engine.model.num_slots == runners[0].cache.engine.model.num_slots


def test_progression_over_eight_banks(runners):
    """4/min, byte-equal with the JAX runner: four OK, then OVER."""
    answers = [_both(runners, _request("limited", "mesh")) for _ in range(6)]
    assert [a.overall_code for a in answers] == [OK] * 4 + [OVER] * 2
    assert [a.statuses[0].limit_remaining for a in answers] == [3, 2, 1, 0, 0, 0]


def test_many_keys_spread_across_banks(runners):
    """Modulo striping spreads the slot table's dense allocation: 40
    keys leave a live counter in every bank, in both packages."""
    for i in range(40):
        a = _both(runners, _request("limited", f"spread{i}"))
        assert a.overall_code == OK and a.statuses[0].limit_remaining == 3
    jax_runner, port_runner = runners
    port_runner.cache.flush()
    jax_runner.cache.flush()
    engine = port_runner.cache.engine
    counts = engine.export_counts()  # global slot order
    live = np.nonzero(counts)[0]
    assert np.unique(live % engine.model.num_banks).size == 8
    np.testing.assert_array_equal(counts, jax_runner.cache.engine.export_counts())


def test_per_second_rule(runners):
    codes = [_both(runners, _request("persec", "s")).overall_code for _ in range(3)]
    assert codes == [OK, OK, OVER]


def test_concurrent_burst_byte_equal(runners):
    """Concurrent RPCs (coalesced into multi-lane routed launches) end
    in the same counters: each key's follow-up answer is byte-equal."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [f"burst{i}" for i in range(48)]
    payloads = [_request("limited", k) for k in keys for _ in range(2)]
    for runner in runners:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda p, r=runner: _call(r, p), payloads))
    for k in keys:
        assert _both(runners, _request("limited", k)).statuses[0].limit_remaining == 1


@pytest.mark.parametrize(
    "override,refused",
    [
        (dict(backend_type="cuda-sharded"), None),
        (dict(backend_type="CUDA-SHARDED"), None),
        (dict(backend_type="cuda-sharded-write-behind"), None),
        (dict(backend_type="cuda-sharded", overload_shed_enabled=True,
              overload_promote_enabled=True, overload_backpressure_enabled=True), None),
        (dict(backend_type="cuda-sharded", cluster_handoff_enabled=True), None),
        (dict(backend_type="tpu-sharded"), "BACKEND_TYPE"),
    ],
)
def test_unported_settings_for_the_sharded_backend(tmp_path, override, refused):
    s = Settings(**{**COMMON, "kernel_deadline_s": 0.0, **override})
    msgs = unported_settings(s)
    if refused is None:
        assert msgs == []
        return
    assert any(refused in m for m in msgs), msgs
    runner = Runner(Settings(**{**COMMON, "kernel_deadline_s": 0.0,
                                "runtime_path": str(tmp_path), **override}),
                    device="cpu", mesh=make_mesh(8, "cpu"))
    with pytest.raises(SettingsError):
        runner.start()
    runner.stop()


def test_sharded_runner_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    """The default device is the card: without CUDA the runner raises
    instead of serving from the CPU; device="cpu" without a mesh serves
    one bank (one bank per card of the device)."""
    base = dict(COMMON, kernel_deadline_s=0.0, runtime_path=str(tmp_path),
                backend_type="cuda-sharded")
    if not torch.cuda.is_available():
        runner = Runner(Settings(**base))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.start()
        runner.stop()
    runner = Runner(Settings(**base), device="cpu")
    runner.start()
    try:
        assert runner.cache.engine.model.num_banks == 1
    finally:
        runner.stop()
    # A mesh on another device than the runner's is refused.
    from ratelimit_tpu_torch.parallel.sharded import Mesh
    from ratelimit_tpu_torch.runner import _make_engine

    with pytest.raises(ValueError, match="mesh is on"):
        _make_engine(Settings(**base), "cpu", Mesh(2, torch.device("cuda", 0)))
