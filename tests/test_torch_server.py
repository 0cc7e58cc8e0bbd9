"""Both runners in-process on ephemeral ports, one config, one gRPC
request stream: the JAX runner (BACKEND_TYPE=tpu on the CPU) and the
port's runner (BACKEND_TYPE=cuda with its counter table on the CPU)
must answer with byte-equal ShouldRateLimit responses."""

import json

import grpc
import pytest

from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings, SettingsError
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

CONFIG = """
domain: rl
descriptors:
  - key: foo
    rate_limit:
      unit: minute
      requests_per_unit: 5
  - key: bar
    value: hourly
    rate_limit:
      unit: hour
      requests_per_unit: 3
  - key: shadowed
    shadow_mode: true
    rate_limit:
      unit: second
      requests_per_unit: 2
  - key: free
    rate_limit:
      unlimited: true
  - key: nested
    descriptors:
      - key: inner
        rate_limit:
          unit: day
          requests_per_unit: 40
"""

COMMON = dict(
    host="127.0.0.1",
    port=0,
    grpc_host="127.0.0.1",
    grpc_port=0,
    debug_host="127.0.0.1",
    debug_port=0,
    use_statsd=False,
    tpu_num_slots=1 << 12,
    tpu_batch_window_us=200,
    tpu_batch_buckets=[8, 32],
    local_cache_size_in_bytes=1 << 20,
    expiration_jitter_max_seconds=0,
    tpu_algorithm_banks="",
    kernel_deadline_s=0.0,
    gc_tuning=False,
)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtime")
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "rl.yaml").write_text(CONFIG)
    paths = dict(runtime_path=str(root), runtime_subdirectory="ratelimit")
    jax_runner = JaxRunner(
        JaxSettings(backend_type="tpu", **COMMON, **paths),
        time_source=JaxPinned(1_000_000),
    )
    port_runner = Runner(
        Settings(backend_type="cuda", **COMMON, **paths),
        time_source=PinnedTimeSource(1_000_000),
        device="cpu",
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
    with grpc.insecure_channel(
        f"127.0.0.1:{runner.grpc_server.bound_port}"
    ) as channel:
        method = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
        )
        try:
            return method(payload, timeout=30)
        except grpc.RpcError as e:
            return (e.code(), e.details())


def _request(domain, descriptors, hits=0):
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
    for entries, override in descriptors:
        d = req.descriptors.add()
        for k, v in entries:
            e = d.entries.add()
            e.key, e.value = k, v
        if override is not None:
            d.limit.requests_per_unit = override[0]
            d.limit.unit = override[1]
    return req.SerializeToString()


MINUTE = rls_pb2.RateLimitResponse.RateLimit.MINUTE
SECOND = rls_pb2.RateLimitResponse.RateLimit.SECOND


def _stream():
    foo = ([("foo", "a")], None)
    yield from [_request("rl", [foo])] * 7  # 6th and 7th OVER_LIMIT
    for i in range(4):
        yield _request(
            "rl",
            [
                ([("bar", "hourly")], None),
                ([("foo", f"k{i}")], None),
                ([("free", "x")], None),
                ([("nosuch", "x")], None),
            ],
            hits=2,
        )
    for _ in range(4):
        yield _request("rl", [([("shadowed", "s")], None)])
    for _ in range(3):
        yield _request("rl", [([("nested", "n"), ("inner", "i")], None)], hits=15)
    for _ in range(3):
        yield _request("rl", [([("foo", "ov")], (2, SECOND))])
    yield _request("rl", [([("foo", "big")], None)], hits=0xFFFFFFFF)
    yield _request("rl", [([("foo", "big")], None)])
    yield _request("", [foo])  # empty domain: UNKNOWN
    yield _request("nodomain", [foo])


def test_grpc_stream_byte_equal(runners):
    jax_runner, port_runner = runners
    answers = []
    for payload in _stream():
        want = _call(jax_runner, payload)
        got = _call(port_runner, payload)
        assert got == want
        answers.append(got)
    codes = [
        rls_pb2.RateLimitResponse.FromString(a).overall_code
        for a in answers[:7]
    ]
    OK, OVER = rls_pb2.RateLimitResponse.OK, rls_pb2.RateLimitResponse.OVER_LIMIT
    assert codes == [OK] * 5 + [OVER] * 2
    assert answers[-2][0] == grpc.StatusCode.UNKNOWN


def test_concurrent_burst_byte_equal(runners):
    """A burst of concurrent RPCs over many keys (coalesced into
    multi-lane launches by the dispatcher) ends in the same counters:
    each key's follow-up answer is byte-equal across the stacks."""
    from concurrent.futures import ThreadPoolExecutor

    jax_runner, port_runner = runners
    keys = [f"burst{i}" for i in range(48)]
    payloads = [_request("rl", [([("foo", k)], None)]) for k in keys for _ in range(3)]
    for runner in (jax_runner, port_runner):
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda p: _call(runner, p), payloads))
    for k in keys:
        probe = _request("rl", [([("foo", k)], None)])
        assert _call(port_runner, probe) == _call(jax_runner, probe)


ALGO_CONFIG = """
domain: algo
descriptors:
  - key: fx
    rate_limit: {unit: minute, requests_per_unit: 5}
  - key: slide
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: sliding_window}
  - key: tb
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: gcra}
  - key: shady
    rate_limit: {unit: minute, requests_per_unit: 5, algorithm: gcra, shadow: true}
"""


def test_default_algorithm_banks_boot_and_serve(tmp_path):
    """TPU_ALGORITHM_BANKS at its default (sliding_window,gcra): both
    runners build the two banks and answer a stream over enforcing and
    shadowed algorithm rules byte-equal, with the shadow tallies
    counted under the reference's names."""
    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "algo.yaml").write_text(ALGO_CONFIG)
    common = {k: v for k, v in COMMON.items() if k != "tpu_algorithm_banks"}
    paths = dict(runtime_path=str(tmp_path), runtime_subdirectory="ratelimit")
    assert Settings().tpu_algorithm_banks == "sliding_window,gcra"
    jax_runner = JaxRunner(
        JaxSettings(backend_type="tpu", **common, **paths),
        time_source=JaxPinned(1_000_020),
    )
    clock = PinnedTimeSource(1_000_020)
    port_runner = Runner(
        Settings(backend_type="cuda", **common, **paths),
        time_source=clock,
        device="cpu",
    )
    jax_runner.start()
    try:
        port_runner.start()
        try:
            assert sorted(port_runner.cache.algorithm_banks) == ["gcra", "sliding_window"]
            codes = {}
            for key in ("fx", "slide", "tb", "shady"):
                for _ in range(7):
                    payload = _request("algo", [([(key, "u")], None)])
                    got = _call(port_runner, payload)
                    assert got == _call(jax_runner, payload), key
                    codes.setdefault(key, []).append(
                        rls_pb2.RateLimitResponse.FromString(got).overall_code
                    )
            OK = rls_pb2.RateLimitResponse.OK
            OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
            for key in ("fx", "slide", "tb", "shady"):
                assert codes[key] == [OK] * 5 + [OVER] * 2, key
            # The 7th shady hit answers from the local over-limit cache,
            # so the candidate ran six times.
            values = port_runner.stats_manager.store.counter_fn_values()
            assert values["ratelimit.tpu.shadow.gcra.agree"] == 6
            assert values["ratelimit.tpu.shadow.gcra.diverge"] == 0
        finally:
            port_runner.stop()
    finally:
        jax_runner.stop()


@pytest.mark.parametrize(
    "override,needle",
    [
        (dict(backend_type="tpu"), "BACKEND_TYPE"),
        (dict(backend_type="tpu-write-behind"), "BACKEND_TYPE"),
        (dict(backend_type="redis"), "BACKEND_TYPE"),
    ],
)
def test_unported_settings_refused_at_boot(tmp_path, override, needle):
    """A BACKEND_TYPE the port does not serve (the JAX package's names
    among them) is the one setting still refused at boot."""
    base = dict(COMMON, runtime_path=str(tmp_path), backend_type="cuda")
    runner = Runner(Settings(**{**base, **override}), device="cpu")
    with pytest.raises(SettingsError, match=needle):
        runner.start()
    runner.stop()


PRIORITY_CONFIG = CONFIG + "priority: 3\n"


def _debug(runner, path, body=None):
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{runner.debug_server.bound_port}{path}"
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize(
    "setting",
    [
        "overload_shed_enabled",
        "overload_promote_enabled",
        "overload_backpressure_enabled",
        "cluster_handoff_enabled",
    ],
)
def test_overload_and_handoff_settings_boot_and_answer_as_jax(tmp_path, setting):
    """Each OVERLOAD_*_ENABLED and CLUSTER_HANDOFF_ENABLED boots the
    port's runner, and both runners answer the gRPC stream byte-equal
    and /debug/overload, /debug/cluster and the cluster POSTs with the
    same status and body (the export blob as the sections it packs)."""
    from ratelimit_tpu.cluster import handoff as jax_handoff

    config_dir = tmp_path / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "rl.yaml").write_text(PRIORITY_CONFIG)
    kw = dict(COMMON, runtime_path=str(tmp_path), runtime_subdirectory="ratelimit")
    kw[setting] = True
    jax_runner = JaxRunner(JaxSettings(backend_type="tpu", **kw), time_source=JaxPinned(1_000_000))
    port_runner = Runner(Settings(backend_type="cuda", **kw), time_source=PinnedTimeSource(1_000_000), device="cpu")
    jax_runner.start()
    try:
        port_runner.start()
        try:
            assert (port_runner.overload is None) == (setting == "cluster_handoff_enabled")
            for payload in _stream():
                assert _call(port_runner, payload) == _call(jax_runner, payload)
            export = json.dumps({"membership": ["B"], "self": "A"}).encode()
            for path, body in (
                ("/debug/overload", None),
                ("/debug/cluster", None),
                ("/debug/cluster/export", export),
                ("/debug/cluster/import", jax_handoff.pack_sections([])),
            ):
                (s1, b1), (s2, b2) = _debug(jax_runner, path, body), _debug(port_runner, path, body)
                assert s1 == s2, path
                if s1 == 200 and path == "/debug/cluster/export":
                    b1 = sorted(sorted(s["keys"]) for s in jax_handoff.unpack_sections(b1))
                    b2 = sorted(sorted(s["keys"]) for s in jax_handoff.unpack_sections(b2))
                elif s1 == 200:
                    b1, b2 = _masked(json.loads(b1)), _masked(json.loads(b2))
                assert b2 == b1, path
        finally:
            port_runner.stop()
    finally:
        jax_runner.stop()


def _masked(x):
    """Fields measured on a clock, masked by name."""
    if isinstance(x, dict):
        return {k: ("<t>" if k in ("at", "hold_remaining_s", "expires_in_s", "burns") else _masked(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_masked(v) for v in x]
    return x
