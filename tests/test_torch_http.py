"""The HTTP and debug listeners of the port (server/http_server.py,
server/debug_profiling.py) against the JAX package's, on the CPU.

Both runners in-process on ephemeral ports, one config, one pinned
clock, the same requests: the JAX runner (BACKEND_TYPE=tpu on the CPU)
and the port's runner (BACKEND_TYPE=cuda with its tables on the CPU).
The /json bridge answers with equal status and body bytes (OK ->
OVER_LIMIT on a fixed-window, a sliding-window and a GCRA key, unknown
descriptors, an empty domain, hostile bodies); /healthcheck, /rlconfig,
/stats, /stats.json and /metrics agree; a sampled request's trace has
the same spans in both packages' rings, kernel.step included.  Booted
at every default on the same config and requests, both runners serve
the same observability views (/debug/hotkeys, /debug/events,
/debug/launches, /debug/timeseries, /debug/incidents, /debug/slo,
/debug/flight) and the same plane families on /stats and /metrics,
masking only named fields measured in time (TIME_KEYS); with a plane's
setting at 0 its view answers the JAX server's 404.  /debug/overload,
/debug/faults without a fault domain and the cluster admin POSTs answer
with the JAX server's bytes.  The capture endpoints are gated, one at a
time, and write a torch.profiler trace.  Health follows the port's fault domain over
HTTP: a stalled bank is "OK (degraded: ...)" as in the JAX package, a
kernel defect is 500 NOT_HEALTHY.
"""

import json
import os
import threading
import time
import urllib.request
from types import SimpleNamespace

import grpc
import pytest

from ratelimit_tpu.observability import TRACER as JAX_TRACER
from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.server import http_server as jax_http
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.stats.manager import StatsStore as JaxStore
from ratelimit_tpu.utils.time import FakeMonotonicClock as JaxFakeClock
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.kernels import KernelError
from ratelimit_tpu_torch.observability import TRACER
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.server import http_server
from ratelimit_tpu_torch.server.debug_profiling import add_profiling_routes
from ratelimit_tpu_torch.service import CacheError
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.stats.manager import StatsStore
from ratelimit_tpu_torch.utils.time import FakeMonotonicClock, PinnedTimeSource
from test_torch_fault_domain import JAX, PORT, Injector, _code, _rule, make_cache

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

CONFIG = """
domain: rl
descriptors:
  - key: foo
    rate_limit:
      unit: minute
      requests_per_unit: 5
  - key: slide
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: sliding_window
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: gcra
  - key: one_per_minute
    value: something
    rate_limit:
      unit: minute
      requests_per_unit: 1
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
    tpu_algorithm_num_slots=1 << 12,
    tpu_batch_window_us=200,
    tpu_batch_buckets=[8, 32],
    local_cache_size_in_bytes=1 << 20,
    expiration_jitter_max_seconds=0,
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


def _http(port, path, body=None, headers=None, method=None):
    """(status, body bytes, headers) of one request to 127.0.0.1:`port`."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, headers=headers or {}, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _both(runners, path, body=None, debug=False, headers=None):
    """The same request to each runner's API (or debug) listener:
    [(status, body)] in the order (JAX, port)."""
    out = []
    for r in runners:
        port = (r.debug_server if debug else r.http_server).bound_port
        out.append(_http(port, path, body, headers)[:2])
    return out


def _json(domain, *descriptors, hits=0):
    req = {"domain": domain, "descriptors": [{"entries": [{"key": k, "value": v}]} for k, v in descriptors]}
    if hits:
        req["hitsAddend"] = hits
    return json.dumps(req).encode()


def _grpc(runner, key, value, metadata=None):
    with grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}") as channel:
        call = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        req = rls_pb2.RateLimitRequest(domain="rl")
        e = req.descriptors.add().entries.add()
        e.key, e.value = key, value
        return call(req, timeout=60, metadata=metadata)


# -- the /json bridge ----------------------------------------------------------


@pytest.mark.parametrize("key", ["foo", "slide", "tb"])
def test_json_progression_byte_equal(runners, key):
    """5/min: hits 1-5 answer 200, 6 and 7 answer 429, with equal body
    bytes on the fixed-window (K1), sliding-window (K4) and GCRA (K5)
    key."""
    statuses = []
    for _ in range(7):
        want, got = _both(runners, "/json", _json("rl", (key, "progress")))
        assert got == want
        statuses.append(got[0])
    assert statuses == [200] * 5 + [429] * 2


@pytest.mark.parametrize(
    "body,status",
    [
        (_json("rl", ("nosuch", "x")), 200),
        (_json("rl", ("foo", "a"), ("nosuch", "x"), ("tb", "a"), hits=2), 200),
        (_json("", ("foo", "x")), 500),
        (_json("nodomain", ("foo", "x")), 200),
    ],
    ids=["unknown_descriptor", "mixed", "empty_domain", "unknown_domain"],
)
def test_json_unknown_descriptors_and_domains_byte_equal(runners, body, status):
    want, got = _both(runners, "/json", body)
    assert got == want
    assert got[0] == status


HOSTILE = [
    b"not json {",
    b"\xff\xfe\x00\x01binary",
    b"{}",  # missing domain -> service error
    b'{"domain": 42}',
    b'{"descriptors": "nope", "domain": "rl"}',
    b'{"domain":"rl","descriptors":[{"entries":"x"}]}',
    json.dumps(
        {"domain": "rl", "descriptors": [{"entries": [{"key": "k" * 10000, "value": "v" * 10000}]}]}
    ).encode(),
    json.dumps(
        {
            "domain": "rl",
            "descriptors": [{"entries": [{"key": f"k{i}", "value": f"v{i}"}]} for i in range(300)],
        }
    ).encode(),
]


@pytest.mark.parametrize("body", HOSTILE, ids=[f"hostile{i}" for i in range(len(HOSTILE))])
def test_json_hostile_bodies_byte_equal(runners, body):
    """Malformed and hostile bodies map to the same 4xx/5xx (or 200)
    answer, byte for byte, and leave both servers healthy."""
    want, got = _both(runners, "/json", body)
    assert got == want
    assert got[0] in (200, 400, 429, 500)
    assert _both(runners, "/healthcheck") == [(200, b"OK")] * 2


def test_healthcheck_on_both_listeners(runners):
    for debug in (False, True):
        assert _both(runners, "/healthcheck", debug=debug) == [(200, b"OK")] * 2


def test_rlconfig_byte_equal(runners):
    want, got = _both(runners, "/rlconfig", debug=True)
    assert got == want
    assert got[0] == 200 and b"rl.foo" in got[1]


# -- stats and metrics ---------------------------------------------------------


def _service_lines(text):
    return {
        line.split(": ", 1)[0]: line.split(": ", 1)[1]
        for line in text.decode().splitlines()
        if line.startswith("ratelimit.service.")
    }


def test_stats_service_counters_equal(runners):
    """After the same requests, every ratelimit.service.* counter that
    both packages emit reads the same in /stats and /stats.json."""
    for _ in range(7):
        _both(runners, "/json", _json("rl", ("foo", "stats")))
    (s1, jax_text), (s2, port_text) = _both(runners, "/stats", debug=True)
    assert s1 == s2 == 200
    jax_lines, port_lines = _service_lines(jax_text), _service_lines(port_text)
    common = set(jax_lines) & set(port_lines)
    assert "ratelimit.service.rate_limit.rl.foo.total_hits" in common
    assert "ratelimit.service.rate_limit.rl.foo.over_limit" in common
    assert {n: port_lines[n] for n in common} == {n: jax_lines[n] for n in common}
    (_, jax_json), (_, port_json) = _both(runners, "/stats.json", debug=True)
    jax_stats, port_stats = json.loads(jax_json)["stats"], json.loads(port_json)["stats"]
    common = {n for n in set(jax_stats) & set(port_stats) if n.startswith("ratelimit.service.")}
    assert common >= {"ratelimit.service.rate_limit.rl.foo.total_hits"}
    assert {n: port_stats[n] for n in common} == {n: jax_stats[n] for n in common}
    assert port_stats["ratelimit.service.rate_limit.rl.foo.over_limit"] >= 2


def test_metrics_serve_phase_histograms(runners):
    """GET /metrics: the per-phase histogram families, cumulative
    buckets ending in +Inf == _count, the same request count as the
    JAX runner's."""
    for r in runners:
        _grpc(r, "foo", "metricsprobe")
    totals = []
    for r in runners:
        status, out, headers = _http(r.debug_server.bound_port, "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        text = out.decode()
        for phase in ("decode", "service", "serialize"):
            assert f"# TYPE ratelimit_server_ShouldRateLimit_phase_{phase}_ms histogram" in text
        prefix = "ratelimit_server_ShouldRateLimit_response_ms"
        counts = [
            int(l.rsplit(" ", 1)[1]) for l in text.splitlines() if l.startswith(prefix + "_bucket")
        ]
        total = int([l for l in text.splitlines() if l.startswith(prefix + "_count")][0].split()[1])
        assert counts == sorted(counts) and counts[-1] == total >= 1
        requests = [
            l for l in text.splitlines()
            if l.startswith("ratelimit_server_ShouldRateLimit_total_requests ")
        ]
        totals.append((total, requests))
    assert totals[0] == totals[1]


# -- traces ----------------------------------------------------------------------

PHASES = {"decode", "service.should_rate_limit", "backend.do_limit", "backend.dispatch", "kernel.step"}


def _trace(tracer, trace_id):
    match = [t for t in tracer.recent() if t.trace_id == trace_id]
    assert match, "the inbound traceparent's trace id is not in the ring"
    return match[-1]


@pytest.mark.parametrize("key", ["foo", "tb"])
def test_traceparent_grpc_spans_match(runners, key):
    """A gRPC request with a sampled traceparent commits a trace under
    the same id with the same span tree in both packages, kernel.step
    included; /debug/tracez shows it."""
    trace_id, parent = ("1f" if key == "foo" else "2f") * 16, "2e" * 8
    trees = []
    for r, tracer in zip(runners, (JAX_TRACER, TRACER)):
        resp = _grpc(r, key, "traceme", metadata=[("traceparent", f"00-{trace_id}-{parent}-01")])
        assert resp.overall_code == rls_pb2.RateLimitResponse.OK
        trace = _trace(tracer, trace_id)
        assert trace.parent_id == parent
        by_name = {s["name"]: s for s in trace.spans}
        assert by_name["grpc.should_rate_limit"]["parent_id"] == parent
        assert by_name["kernel.step"]["start_ms"] >= by_name["backend.do_limit"]["start_ms"]
        # Spans and their attributes (domain, descriptors, bank, lanes)
        # but the backend's class name, which names each package's cache.
        assert by_name["backend.do_limit"]["attrs"]["backend"] in (
            "TpuRateLimitCache",
            "CudaRateLimitCache",
        )
        trees.append(
            sorted(
                (s["name"], tuple(sorted((k, v) for k, v in s["attrs"].items() if k != "backend")))
                for s in trace.spans
            )
        )
        status, out, _ = _http(r.debug_server.bound_port, "/debug/tracez")
        assert status == 200 and trace_id in out.decode() and "kernel.step" in out.decode()
    assert trees[0] == trees[1]
    assert PHASES <= {name for name, _ in trees[1]}


def test_traceparent_http_json_echo(runners):
    """The /json bridge adopts an inbound traceparent and echoes one
    continuing the same trace; both packages record the same spans."""
    trace_id = "3d" * 16
    header = {"traceparent": f"00-{trace_id}-{'4c' * 8}-01"}
    names = []
    for r, tracer in zip(runners, (JAX_TRACER, TRACER)):
        status, _, headers = _http(
            r.http_server.bound_port, "/json", _json("rl", ("foo", "httptrace")), header
        )
        assert status == 200
        assert headers["traceparent"].split("-")[1] == trace_id
        names.append(sorted(s["name"] for s in _trace(tracer, trace_id).spans))
    assert names[0] == names[1]
    assert PHASES | {"http.json", "serialize"} <= set(names[1])


def test_unsampled_requests_stay_out_of_the_ring(runners):
    """No traceparent, sample rate 0: a clean request commits no trace."""
    for r, tracer in zip(runners, (JAX_TRACER, TRACER)):
        before = len(tracer.recent())
        assert _grpc(r, "nosuch", "quiet").overall_code == rls_pb2.RateLimitResponse.OK
        assert _http(r.http_server.bound_port, "/json", _json("rl", ("nosuch", "q")))[0] == 200
        assert len(tracer.recent()) == before


def test_over_limit_commits_trace_without_sampling(runners):
    """Tail-sampling override: an OVER_LIMIT decision commits with no
    traceparent and rate 0."""
    for r, tracer in zip(runners, (JAX_TRACER, TRACER)):
        codes = {_grpc(r, "one_per_minute", "something").overall_code for _ in range(3)}
        assert rls_pb2.RateLimitResponse.OVER_LIMIT in codes
        over = [t for t in tracer.recent() if t.status == "over_limit"]
        assert over and over[-1].root_name == "grpc.should_rate_limit"


# -- the debug views -------------------------------------------------------------

PLANE_VIEWS = [
    ("GET", "/debug/hotkeys"),
    ("GET", "/debug/incidents"),
    ("GET", "/debug/slo"),
    ("GET", "/debug/overload"),
    ("GET", "/debug/events"),
    ("GET", "/debug/launches"),
    ("GET", "/debug/timeseries"),
    ("GET", "/debug/flight"),
    ("GET", "/debug/faults"),
    ("POST", "/debug/cluster/export"),
    ("POST", "/debug/cluster/import"),
    ("GET", "/debug/profile?seconds=0.1"),
    ("GET", "/debug/xla_trace?seconds=0.1"),
]


@pytest.fixture(scope="module")
def planes_off(runners):
    """The JAX debug server with every plane off (no service, so no
    hot-key sketch or fault domain), with and without DEBUG_PROFILING;
    the port's runner (profiling off) and a port debug server with it
    on, beside them."""
    servers = {}
    for profiling in (False, True):
        s = jax_http.HttpServer("127.0.0.1", 0, name="jax-debug")
        jax_http.add_debug_routes(s, JaxStore(), profiling_enabled=profiling)
        servers[("jax", profiling)] = s
    s = http_server.HttpServer("127.0.0.1", 0, name="port-debug")
    http_server.add_debug_routes(s, StatsStore(), profiling_enabled=True)
    servers[("port", True)] = s
    for s in servers.values():
        s.start()
    servers[("port", False)] = runners[1].debug_server
    try:
        yield {k: s.bound_port for k, s in servers.items()}
    finally:
        for k, s in servers.items():
            if k != ("port", False):
                s.stop()


#: The views whose plane the port does not have (overload control, the
#: cluster handoff) or that answer without a backend's fault domain.
PLANES_STILL_OFF = [v for v in PLANE_VIEWS[:11] if v[1] in (
    "/debug/overload", "/debug/faults", "/debug/cluster/export", "/debug/cluster/import",
)]


@pytest.mark.parametrize("profiling", [False, True], ids=["profiling_off", "profiling_on"])
@pytest.mark.parametrize("method,path", PLANES_STILL_OFF, ids=[p for _, p in PLANES_STILL_OFF])
def test_views_of_unported_planes_answer_as_jax_with_planes_off(planes_off, profiling, method, path):
    body = b"{}" if method == "POST" else None
    want = _http(planes_off[("jax", profiling)], path, body, method=method)[:2]
    got = _http(planes_off[("port", profiling)], path, body, method=method)[:2]
    assert got == want
    assert got[0] in (403, 404)


@pytest.mark.parametrize("path", [p for _, p in PLANE_VIEWS[11:]], ids=["profile", "xla_trace"])
def test_capture_endpoints_gated_as_jax(runners, path):
    """Without DEBUG_PROFILING both runners refuse the captures with
    the same 403; threadz stays open."""
    want, got = _both(runners, path, debug=True)
    assert got == want and got[0] == 403 and b"DEBUG_PROFILING" in got[1]
    threadz = _both(runners, "/debug/threadz", debug=True)
    assert [s for s, _ in threadz] == [200, 200]


def test_debug_cluster_has_no_handoff(runners):
    (s1, jax_out), (s2, port_out) = _both(runners, "/debug/cluster", debug=True)
    assert s1 == s2 == 200
    assert json.loads(port_out) == {"handoff_enabled": False, "handoff": None}
    assert json.loads(jax_out)["handoff_enabled"] is False


def test_debug_index_lists_every_get_route(runners):
    """/debug/ (and its pprof alias) lists every GET route of the live
    router, each with a blurb, and the port's debug listener has the
    JAX runner's routes."""
    jax_runner, port_runner = runners
    routes = sorted(p for m, p in port_runner.debug_server.router.routes if m == "GET")
    assert routes == sorted(p for m, p in jax_runner.debug_server.router.routes if m == "GET")
    for path in ("/debug/", "/debug/pprof/"):
        status, out, _ = _http(port_runner.debug_server.bound_port, path)
        assert status == 200
        lines = out.decode().splitlines()[1:]
        assert [l.split()[0] for l in lines] == routes
        assert all(len(l.split()) > 1 for l in lines), lines
    assert "torch.profiler" in out.decode()


# -- the observability planes at their defaults ----------------------------------

#: Fields measured in time (stamps, durations, latency buckets, the
#: process-wide config generation): masked by name wherever they occur.
TIME_KEYS = {
    "ts_ns", "ts_mono_ns", "ts_unix", "latency_le_ms", "queue_wait_us", "launch_us",
    "complete_us", "p99_launch_ns", "captured_unix", "captured_monotonic",
    "slowest_traces", "generation", "slow", "latency_sli", "latency_burn_rate",
    "seq", "seqs",
}
#: Time-series columns measured in time: the phase latencies and RSS.
TIME_SERIES = ("p99_", "rss_mb")
#: The plane families on /stats and /metrics, by their name prefix.
PLANE_FAMILIES = {
    "flight": "ratelimit.tpu.flight.",
    "launches": "ratelimit.tpu.launch.",
    "events": "ratelimit.events.",
    "hotkeys": "ratelimit.tpu.hotkeys.",
    "timeseries": "ratelimit.tsdb.",
    "detectors": "ratelimit.incidents.",
    "slo": "ratelimit.tpu.slo.",
}
#: Stats of those families that are measured in time.
TIME_STATS = (".p99_launch_ns", ".slow", ".latency_sli", ".latency_burn_rate")


def _mask(obj):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in TIME_KEYS:
                continue
            if isinstance(k, str) and k.startswith(TIME_SERIES):
                continue
            if isinstance(k, str) and k.startswith(tuple(PLANE_FAMILIES.values())):
                if k.endswith(TIME_STATS):
                    continue
            out[k] = _mask(v)
        return out
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


class _TripOnce:
    name = "synthetic"

    def __init__(self):
        self.reasons = ["forced capture"]

    def evaluate(self):
        return self.reasons.pop(0) if self.reasons else None


def _quiet_samplers(runner, clock_cls):
    """Stop the time-series and anomaly samplers right after boot and
    put the series on a fake clock and wall, so both runners' ticks
    happen at the same points of the same traffic."""
    runner.detectors.stop()
    ts = runner.timeseries
    ts.stop()
    ts.clock = clock_cls(50.0)
    ts._wall = lambda: 1_700_000_000.0
    ts._last_mono = None


@pytest.fixture(scope="module")
def default_runners(tmp_path_factory):
    """Both runners at every default (DEBUG_PROFILING on for the flight
    capture, no fault domain: a JAX shape compiling past the deadline
    would quarantine), driven through the same traffic: gRPC and /json
    over fixed-window, sliding-window and GCRA keys past their limits,
    a config reload, two time-series ticks one fake second apart, and a
    forced incident capture."""
    root = tmp_path_factory.mktemp("runtime_defaults")
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "rl.yaml").write_text(CONFIG)
    kw = dict(COMMON, debug_profiling=True, runtime_path=str(root), runtime_subdirectory="ratelimit")
    jax_runner = JaxRunner(JaxSettings(backend_type="tpu", **kw), time_source=JaxPinned(2_000_000))
    port_runner = Runner(
        Settings(backend_type="cuda", **kw), time_source=PinnedTimeSource(2_000_000), device="cpu"
    )
    jax_runner.start()
    _quiet_samplers(jax_runner, JaxFakeClock)
    try:
        port_runner.start()
        _quiet_samplers(port_runner, FakeMonotonicClock)
        runners = (jax_runner, port_runner)
        for r in runners:
            r.timeseries.tick()
            r.service.reload_config()
        for round_ in range(2):
            for r in runners:
                for key in ("foo", "slide", "tb"):
                    for _ in range(4):
                        _grpc(r, key, "planes")
                        _http(r.http_server.bound_port, "/json", _json("rl", (key, "planes")))
                _grpc(r, "one_per_minute", "something")
                r.cache.flush()
                r.timeseries.clock.advance(1.0)
                r.timeseries.tick()
        for r in runners:
            r.detectors.detectors.append(_TripOnce())
            r.detectors.tick()
        yield runners
    finally:
        try:
            port_runner.stop()
        finally:
            jax_runner.stop()


LIVE_VIEWS = [
    "/debug/hotkeys",
    "/debug/events",
    "/debug/launches",
    "/debug/timeseries",
    "/debug/incidents",
    "/debug/slo",
    "/debug/flight?format=json",
]


def _plane_families(obj):
    return {k: v for k, v in obj.items() if k.startswith(tuple(PLANE_FAMILIES.values()))}


@pytest.mark.parametrize("path", LIVE_VIEWS)
def test_views_of_live_planes_answer_as_jax_at_defaults(default_runners, path):
    """Each view of a default-on plane answers as the JAX runner's on
    the same config and requests: the same status and body, masking the
    fields measured in time.  An incident's counters and gauges are
    compared for the plane families (the cluster tier's families exist
    only in the JAX package)."""
    (s1, want), (s2, got) = [
        _http(r.debug_server.bound_port, path)[:2] for r in default_runners
    ]
    assert s1 == s2 == 200
    want, got = json.loads(want), json.loads(got)
    if path == "/debug/incidents":
        for body in (want, got):
            body.pop("incident_dir")
            for inc in body["incidents"]:
                inc["counters"] = _plane_families(inc["counters"])
                inc["gauges"] = _plane_families(inc["gauges"])
    assert _mask(got) == _mask(want)
    checks = {
        "/debug/hotkeys": lambda b: b["tracked"] == 4 and b["keys"][0]["over_limit"] > 0,
        "/debug/events": lambda b: [e["type"] for e in b["events"]] == ["config_reload", "incident"],
        "/debug/launches": lambda b: {r["algorithm"] for r in b["launches"]}
        == {"fixed_window", "sliding_window", "gcra"},
        "/debug/timeseries": lambda b: b["series"]["launches_per_s"][-2:] == [23.0, 17.0],
        "/debug/incidents": lambda b: b["captured_total"] == 1 and b["incidents"][0]["ring"],
        "/debug/slo": lambda b: b["domains"]["rl"]["cumulative"]["requests"] == 50,
        "/debug/flight?format=json": lambda b: len(b["records"]) == 50,
    }
    assert checks[path](got), got


@pytest.mark.parametrize("endpoint", ["/stats", "/metrics"])
@pytest.mark.parametrize("family", sorted(PLANE_FAMILIES))
def test_plane_families_on_stats_and_metrics_equal(default_runners, family, endpoint):
    """/stats and /metrics carry each plane's family with the JAX
    runner's names and, but for the stats measured in time, values."""
    prefix = PLANE_FAMILIES[family]
    if endpoint == "/metrics":
        prefix = prefix.replace(".", "_")
    lines = []
    for r in default_runners:
        status, out, _ = _http(r.debug_server.bound_port, endpoint)
        assert status == 200
        sep = " " if endpoint == "/metrics" else ": "
        fam = {}
        for line in out.decode().splitlines():
            if line.startswith(prefix):
                name, value = line.rsplit(sep, 1) if sep == " " else line.split(sep, 1)
                if not name.split("{")[0].endswith(tuple(s.replace(".", "_") for s in TIME_STATS) + TIME_STATS):
                    fam[name] = value
        lines.append(fam)
    assert lines[1] == lines[0] and lines[1]


@pytest.fixture(scope="module")
def planes_zero(tmp_path_factory):
    """Both runners with every plane's setting at 0 (DEBUG_PROFILING on,
    so /debug/flight reaches its ring check)."""
    root = tmp_path_factory.mktemp("runtime_planes_zero")
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "rl.yaml").write_text(CONFIG)
    kw = dict(
        COMMON,
        debug_profiling=True,
        runtime_path=str(root),
        runtime_subdirectory="ratelimit",
        flight_recorder_size=0,
        event_journal_size=0,
        launch_recorder_size=0,
        tsdb_interval_s=0.0,
        anomaly_interval_s=0.0,
        hotkeys_top_k=0,
    )
    jax_runner = JaxRunner(JaxSettings(backend_type="tpu", **kw), time_source=JaxPinned(2_000_000))
    port_runner = Runner(
        Settings(backend_type="cuda", **kw), time_source=PinnedTimeSource(2_000_000), device="cpu"
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


@pytest.mark.parametrize("path", LIVE_VIEWS)
def test_views_with_the_plane_at_zero_answer_as_jax(planes_zero, path):
    """With a plane's setting at 0 its view answers the JAX runner's
    bytes: 404 for the recorders, the journal, the series and the
    sketch; the SLO engine and the detectors are always built, as in
    the JAX runner, and answer 200 with no captures."""
    jax_runner, port_runner = planes_zero
    for r in planes_zero:
        assert r.flight is None and r.launches is None and r.events is None
        assert r.timeseries is None and r.cache.hotkeys is None
    (s1, want), (s2, got) = [_http(r.debug_server.bound_port, path)[:2] for r in planes_zero]
    assert s1 == s2
    if s1 == 200:
        assert _mask(json.loads(got)) == _mask(json.loads(want))
        assert path in ("/debug/incidents", "/debug/slo")
    else:
        assert (s2, got) == (404, want)


def test_replies_leave_without_waiting_for_an_ack():
    """The handler turns Nagle's algorithm off on every connection: a
    reply is two writes, and with Nagle on a keep-alive client's
    delayed ACK holds the second one back (~40 ms a request)."""
    import http.client
    import socket

    s = http_server.HttpServer("127.0.0.1", 0, name="nodelay")
    s.add_route(
        "GET",
        "/nodelay",
        lambda h: h._reply(
            200, str(h.connection.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)).encode()
        ),
    )
    s.start()
    conn = http.client.HTTPConnection("127.0.0.1", s.bound_port, timeout=30)
    try:
        for _ in range(2):  # twice on one keep-alive connection
            conn.request("GET", "/nodelay")
            resp = conn.getresponse()
            assert (resp.status, resp.read()) == (200, b"1")
    finally:
        conn.close()
        s.stop()


# -- the capture endpoints with DEBUG_PROFILING --------------------------------------


@pytest.fixture
def captures(tmp_path):
    s = http_server.HttpServer("127.0.0.1", 0, name="debug-open")
    add_profiling_routes(s, artifacts_dir=str(tmp_path), profiling_enabled=True)
    s.start()
    try:
        yield s.bound_port
    finally:
        s.stop()


def test_profile_and_torch_trace_captures(captures, tmp_path):
    status, out, _ = _http(captures, "/debug/profile?seconds=0.2")
    assert status == 200 and b"statistical cpu profile" in out
    status, out, _ = _http(captures, "/debug/xla_trace?seconds=0.1")
    assert status == 200, out
    trace_dir = out.decode().splitlines()[0].split("trace written to ")[1]
    assert os.path.dirname(trace_dir) == str(tmp_path)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def _wait_for_frame(name, timeout=30.0):
    """Block until some thread is running the function `name`."""
    import sys

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for frame in sys._current_frames().values():
            while frame is not None:
                if frame.f_code.co_name == name:
                    return
                frame = frame.f_back
        time.sleep(0.005)
    raise AssertionError(f"no thread entered {name}")


def test_one_capture_at_a_time(captures):
    """A capture request while another runs answers 409 from the gate
    (never a 500 from a second profiler session)."""
    first = {}
    t = threading.Thread(
        target=lambda: first.update(r=_http(captures, "/debug/xla_trace?seconds=2")[:2])
    )
    t.start()
    _wait_for_frame("torch_trace")  # the first capture holds the gate
    second = [_http(captures, p)[:2] for p in ("/debug/xla_trace?seconds=0.1", "/debug/profile?seconds=0.1")]
    t.join(timeout=60)
    assert not t.is_alive()
    assert [s for s, _ in second] == [409, 409]
    assert first["r"][0] == 200


# -- health through the fault domain, over HTTP ------------------------------------


def _serve_health(cache, health, http_mod):
    s = http_mod.HttpServer("127.0.0.1", 0, name="health")
    http_mod.add_healthcheck(s, health)
    http_mod.add_debug_routes(s, StatsStore(), SimpleNamespace(cache=cache))
    s.start()
    return s


def _stalled_bank_over_http(P, http_mod):
    inj, clock = Injector(), P.time.FakeMonotonicClock(100.0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    health = P.Health()
    cache.bind_health(health)
    rule = _rule(P, P.Manager())
    s = _serve_health(cache, health, http_mod)
    try:
        before = _http(s.bound_port, "/healthcheck")[:2]
        assert _code(P, cache, rule) == "OK"
        inj.set("lane0", "hang")
        assert _code(P, cache, rule) == "OK"  # the mirror answers
        during = _http(s.bound_port, "/healthcheck")[:2]
        status, faults, _ = _http(s.bound_port, "/debug/faults")
        assert status == 200
        return before, during, json.loads(faults)
    finally:
        inj.heal()
        s.stop()
        cache.close()


def test_stalled_bank_reads_degraded_over_http():
    """A hung launch quarantines the bank: /healthcheck answers 200
    "OK (degraded: ...)" in both packages, and /debug/faults has the
    JAX package's keys and counts."""
    want = _stalled_bank_over_http(JAX, jax_http)
    got = _stalled_bank_over_http(PORT, http_server)
    assert got[0] == want[0] == (200, b"OK")
    assert got[1] == want[1] and got[1][1].startswith(b"OK (degraded: ")
    assert sorted(got[2]) == sorted(want[2])
    assert [sorted(b) for b in got[2]["banks"]] == [sorted(b) for b in want[2]["banks"]]
    for key in ("faults", "quarantined_banks", "fallback_decisions"):
        assert got[2][key] == want[2][key], key
    assert got[2]["faults"]["hang"] == 1 and got[2]["quarantined_banks"] == 1


def test_kernel_defect_reads_not_healthy_over_http():
    """A kernel that fails to launch (no sticky code) raises CacheError
    and, after unhealthy_after failures, /healthcheck answers 500
    NOT_HEALTHY on the port; the mirror hides nothing."""
    inj, clock = Injector(), FakeMonotonicClock(100.0)
    cache = make_cache(PORT, inj, deadline=0.2, clock=clock)
    health = PORT.Health()
    cache.bind_health(health)
    rule = _rule(PORT, PORT.Manager())
    s = _serve_health(cache, health, http_server)
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", KernelError("k: CUDA launch failed with error 1", code=1))
        for _ in range(3):
            with pytest.raises(CacheError):
                _code(PORT, cache, rule)
        clock.advance(1.0)
        cache.fault_domain.tick()
        # The RPC is answered before its dispatcher counts the failure:
        # wait (bounded) for the third one to reach the health checker.
        deadline = time.monotonic() + 10
        while health.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _http(s.bound_port, "/healthcheck")[:2] == (500, b"NOT_HEALTHY")
        summary = json.loads(_http(s.bound_port, "/debug/faults")[1])
        assert summary["quarantined_banks"] == 0 and summary["fallback_decisions"] == 0
        inj.heal()
        assert _code(PORT, cache, rule) == "OK"
        assert _http(s.bound_port, "/healthcheck")[:2] == (200, b"OK")
    finally:
        inj.heal()
        s.stop()
        cache.close()
