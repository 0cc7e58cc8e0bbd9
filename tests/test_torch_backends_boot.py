"""BACKEND_TYPE=cuda-write-behind, cuda-sharded-write-behind and memory
booted through the port's Runner, against the JAX package's runner on
tpu-write-behind, tpu-sharded-write-behind and memory.

Each pair of runners serves one config from the same pinned clock, and
their gRPC and /json answers must be byte-equal.  The write-behind
banks live on the CPU (the sharded one as 8 banks on one device,
``make_mesh(8, "cpu")``, beside the JAX package's 8 virtual devices),
and after a flush both packages hold the same counters.  Then what the
runner does around the backends: TPU_NUM_LANES is ignored with a
warning under write-behind, a dead write-behind dispatcher flips health
as in the JAX package, and a stop and a boot on TPU_CHECKPOINT_DIR
forgive no hit.
"""

import json
import logging
import urllib.request

import grpc
import pytest

from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.backends.memory_cache import MemoryRateLimitCache
from ratelimit_tpu_torch.backends.write_behind import WriteBehindRateLimitCache
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = """
domain: bk
descriptors:
  - key: limited
    rate_limit:
      unit: minute
      requests_per_unit: 4
  - key: hourly
    rate_limit:
      unit: hour
      requests_per_unit: 6
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 3
      algorithm: gcra
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
    gc_tuning=False,
)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT

#: (JAX BACKEND_TYPE, the port's, the port runner's mesh: None, or the
#: number of groups its 8 banks lie in on the CPU)
PAIRS = [
    ("tpu-write-behind", "cuda-write-behind", None),
    ("tpu-sharded-write-behind", "cuda-sharded-write-behind", 1),
    ("memory", "memory", None),
    ("tpu-sharded-write-behind", "cuda-sharded-write-behind", 4),
]
PAIR_IDS = ["cuda-write-behind", "cuda-sharded-write-behind", "memory",
            "cuda-sharded-write-behind-4-groups"]


def _runtime(tmp_path_factory, name):
    root = tmp_path_factory.mktemp(name)
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "bk.yaml").write_text(YAML)
    return dict(runtime_path=str(root), runtime_subdirectory="ratelimit")


def _port_runner(backend, paths, clock=None, mesh=None, **settings):
    return Runner(
        Settings(backend_type=backend, **{**COMMON, **paths, **settings}),
        time_source=clock or PinnedTimeSource(1_000_000),
        device="cpu",
        mesh=None if mesh is None else make_mesh(8, devices=("cpu",) * mesh),
    )


@pytest.fixture(scope="module", params=PAIRS, ids=PAIR_IDS)
def runners(request, tmp_path_factory):
    jax_backend, backend, mesh = request.param
    paths = _runtime(tmp_path_factory, backend)
    jax_runner = JaxRunner(
        JaxSettings(backend_type=jax_backend, **COMMON, **paths),
        time_source=JaxPinned(1_000_000),
    )
    port_runner = _port_runner(backend, paths, mesh=mesh, tpu_warmup=True)
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
    req = rls_pb2.RateLimitRequest(domain="bk", hits_addend=hits)
    e = req.descriptors.add().entries.add()
    e.key, e.value = key, value
    return req.SerializeToString()


def _both(runners, payload):
    """`payload` to both runners; byte-equal answers, the port's decoded."""
    jax_runner, port_runner = runners
    got = _call(port_runner, payload)
    assert got == _call(jax_runner, payload)
    return rls_pb2.RateLimitResponse.FromString(got)


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(runner, key, value):
    body = json.dumps(
        {"domain": "bk", "descriptors": [{"entries": [{"key": key, "value": value}]}]}
    ).encode()
    return _http(runner.http_server.bound_port, "/json", body)


def _key_counts(engine):
    counts = engine.export_counts()
    return {k: int(counts[s]) for k, s, _e in engine.slot_table.entries()}


def test_backend_is_wired(runners):
    jax_runner, port_runner = runners
    cache = port_runner.cache
    backend = port_runner.settings.backend_type
    if backend == "memory":
        assert isinstance(cache, MemoryRateLimitCache)
        assert port_runner.checkpointer is None
        return
    assert isinstance(cache, WriteBehindRateLimitCache)
    assert not hasattr(cache, "fault_domain")  # no fault domain, as in JAX
    assert cache.engines() == [cache.engine] and cache.per_second_engine is None
    assert cache.engine.model.num_slots == jax_runner.cache.engine.model.num_slots
    if backend == "cuda-sharded-write-behind":
        assert isinstance(cache.engine, ShardedCounterEngine)
        assert cache.engine.model.num_banks == 8
        assert cache.engine.model.groups == port_runner.mesh.groups
    values = port_runner.stats_manager.store.counter_fn_values()
    assert "ratelimit.tpu.bank0.evictions" in values


def test_grpc_progression_byte_equal(runners):
    """4/min: four OK, then OVER_LIMIT, the same bytes from both."""
    answers = [_both(runners, _request("limited", "g")) for _ in range(6)]
    assert [a.overall_code for a in answers] == [OK] * 4 + [OVER] * 2
    assert [a.statuses[0].limit_remaining for a in answers] == [3, 2, 1, 0, 0, 0]


def test_json_byte_equal(runners):
    """/json: 200 four times, then 429, with equal bodies."""
    got = [[_json(r, "limited", "j") for r in runners] for _ in range(6)]
    for jax_answer, port_answer in got:
        assert port_answer == jax_answer
    assert [g[1][0] for g in got] == [200] * 4 + [429] * 2


def test_gcra_rule_is_a_fixed_window(runners):
    """Write-behind and memory count an algorithm rule as a fixed
    window, in both packages."""
    answers = [_both(runners, _request("tb", "g")) for _ in range(5)]
    assert [a.overall_code for a in answers] == [OK] * 3 + [OVER] * 2


def test_counters_after_flush(runners):
    """After a flush both packages' tables hold every hit: the same
    count per key on one table, the same total over 8 banks."""
    for i in range(12):
        _both(runners, _request("hourly", f"c{i % 3}", hits=1 + i % 2))
    jax_runner, port_runner = runners
    if port_runner.settings.backend_type == "memory":
        assert port_runner.cache._counters == jax_runner.cache._counters
        return
    for r in runners:
        r.cache.flush()
    port_engine, jax_engine = port_runner.cache.engine, jax_runner.cache.engine
    if not isinstance(port_engine, ShardedCounterEngine):
        # (The JAX sharded engine's export_counts is not in slot order.)
        assert _key_counts(port_engine) == _key_counts(jax_engine)
    assert int(port_engine.export_counts().sum()) == int(jax_engine.export_counts().sum())
    got = {k: v for k, v in _key_counts(port_engine).items() if "hourly" in k}
    assert sorted(got.values()) == [6, 6, 6]
    assert all(e[1] == 0 for e in port_runner.cache._view.values())


def test_num_lanes_ignored_under_write_behind(tmp_path_factory, caplog):
    """TPU_NUM_LANES=2 under cuda-write-behind logs the JAX runner's
    warning and builds one engine of TPU_NUM_SLOTS."""
    runner = _port_runner("cuda-write-behind", _runtime(tmp_path_factory, "lanes"),
                          tpu_num_lanes=2)
    with caplog.at_level(logging.WARNING, logger="ratelimit"):
        runner.start()
    try:
        assert any(
            "TPU_NUM_LANES=2 is ignored by backend 'cuda-write-behind'" in r.getMessage()
            for r in caplog.records
        )
        engines = runner.cache.engines()
        assert len(engines) == 1 and engines[0].model.num_slots == 1 << 10
        assert runner.checkpointer is None
    finally:
        runner.stop()


def test_dead_dispatcher_flips_health(tmp_path_factory):
    """The write-behind dispatcher's death turns /healthcheck to 500
    NOT_HEALTHY and fails the next RPC, as in the JAX package."""
    paths = _runtime(tmp_path_factory, "dead")
    jax_runner = JaxRunner(
        JaxSettings(backend_type="tpu-write-behind", **COMMON, **paths),
        time_source=JaxPinned(1_000_000),
    )
    port_runner = _port_runner("cuda-write-behind", paths)
    runners = (jax_runner, port_runner)
    for r in runners:
        r.start()
    try:
        assert _both(runners, _request("limited", "d")).overall_code == OK
        for r in runners:
            r.cache.flush()
            r.cache._dispatcher._die(RuntimeError("injected dispatcher death"))
        health = [_http(r.http_server.bound_port, "/healthcheck") for r in runners]
        assert health[0] == health[1] == (500, b"NOT_HEALTHY")
        assert not port_runner.health.healthy
        failed = [_call(r, _request("limited", "d")) for r in runners]
        assert all(f[0] == grpc.StatusCode.UNKNOWN for f in failed), failed
    finally:
        for r in runners:
            r.stop()


def test_stop_and_boot_on_checkpoint_files_is_exact(tmp_path_factory, tmp_path):
    """Three of six hourly hits, stop() (flush, then the final
    checkpoint), a second runner on the same files: exactly three more
    are admitted, the first one before any reconcile."""
    paths = _runtime(tmp_path_factory, "ckpt")
    clock = PinnedTimeSource(1_000_000)
    settings = dict(tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_interval_s=3600)
    first = _port_runner("cuda-write-behind", paths, clock, **settings)
    first.start()
    try:
        codes = [_call(first, _request("hourly", "r")) for _ in range(3)]
    finally:
        first.stop()
    assert [rls_pb2.RateLimitResponse.FromString(c).overall_code for c in codes] == [OK] * 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bank0.npz"]
    second = _port_runner("cuda-write-behind", paths, clock, **settings)
    second.start()
    try:
        (dev, pending, _exp), = second.cache._view.values()
        assert (dev, pending) == (3, 0)
        answers = [
            rls_pb2.RateLimitResponse.FromString(_call(second, _request("hourly", "r")))
            for _ in range(4)
        ]
        assert [a.overall_code for a in answers] == [OK] * 3 + [OVER]
        assert [a.statuses[0].limit_remaining for a in answers] == [2, 1, 0, 0]
    finally:
        second.stop()
