"""The port's cluster proxy (ratelimit_tpu_torch/cluster/proxy.py) and
fleet view (cluster/fleet.py) against the JAX package's, on the CPU.

The JAX package's tests/test_cluster_proxy.py scenarios run through
both packages' proxies: membership from a replicas file and from SRV,
the gRPC health Check and Watch, the sub-call ceiling, the debug
listener (/stats.json, /healthcheck, /debug/events, /fleet.json), the
handoff age and outage ages, the traceparent and correlation-id joins
across the hop, and the parser's defaults.  The fleet merges of
tests/test_events_fleet.py run through both aggregators on the same
scraped bodies.

One module-scoped stack holds two JAX runners and two port runners
(device="cpu") and four proxies over real gRPC: the JAX proxy in front
of the JAX runners, the port's in front of the port's, and both mixes
-- the port's proxy in front of the JAX runners and the JAX proxy in
front of the port's.  Every proxy gives byte-equal replies to the same
request sequence, and a mixed proxy routes every key to the owner its
replicas' own package picks.  Last, ``python -m
ratelimit_tpu_torch.cluster.proxy`` in a subprocess serves in front of
a port runner, maps no torch library, and exits 0 on SIGTERM.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import grpc
import pytest

import ratelimit_tpu.cluster.fleet as jax_fleet
import ratelimit_tpu.cluster.proxy as jax_proxy
import ratelimit_tpu.cluster.router as jax_router
import ratelimit_tpu.observability as jax_obs
import ratelimit_tpu.utils.srv as jax_srv
import ratelimit_tpu_torch.cluster.fleet as port_fleet
import ratelimit_tpu_torch.cluster.proxy as port_proxy
import ratelimit_tpu_torch.cluster.router as port_router
import ratelimit_tpu_torch.observability as port_obs
import ratelimit_tpu_torch.utils.srv as port_srv
from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402
from grpchealth.v1 import health_pb2  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(name="jax", proxy=jax_proxy, router=jax_router, fleet=jax_fleet, obs=jax_obs, srv=jax_srv)
PORT = SimpleNamespace(name="port", proxy=port_proxy, router=port_router, fleet=port_fleet, obs=port_obs,
                       srv=port_srv)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
SERVING = health_pb2.HealthCheckResponse.SERVING
NOT_SERVING = health_pb2.HealthCheckResponse.NOT_SERVING

YAML = """
domain: px
descriptors:
  - key: limited
    rate_limit:
      unit: minute
      requests_per_unit: 3
"""

COMMON = dict(
    host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
    debug_host="127.0.0.1", debug_port=0, use_statsd=False,
    tpu_num_slots=1 << 12, tpu_batch_window_us=200, tpu_batch_buckets=[8, 32],
    local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
)


def both(scenario, *args):
    """Run `scenario(P, *args)` through each package; the observations
    must be equal.  Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _runtime(tmp_path_factory, name):
    root = tmp_path_factory.mktemp(name)
    (root / "ratelimit" / "config").mkdir(parents=True)
    (root / "ratelimit" / "config" / "px.yaml").write_text(YAML)
    return dict(runtime_path=str(root), runtime_subdirectory="ratelimit")


def _jax_runner(paths, **kw):
    settings = {**COMMON, "backend_type": "tpu", **kw, **paths}
    return JaxRunner(JaxSettings(**settings), time_source=JaxPinned(1_000_000))


def _port_runner(paths, **kw):
    settings = {**COMMON, "backend_type": "cuda", **kw, **paths}
    return Runner(Settings(**settings), time_source=PinnedTimeSource(1_000_000), device="cpu")


def _grpc_addr(r):
    return f"127.0.0.1:{r.grpc_server.bound_port}"


def _call(addr, request_pb, metadata=None):
    with grpc.insecure_channel(addr) as channel:
        method = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        return method(request_pb, timeout=30, metadata=metadata)


def _status(fn):
    try:
        return fn()
    except grpc.RpcError as e:
        return (e.code(), e.details())


def _request(value, domain="px"):
    req = rls_pb2.RateLimitRequest(domain=domain)
    e = req.descriptors.add().entries.add()
    e.key, e.value = "limited", value
    return req


def _health(addr):
    with grpc.insecure_channel(addr) as ch:
        check = ch.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        return check(health_pb2.HealthCheckRequest(), timeout=10).status


def _get_json(url):
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


# -- the stack: two runners of each package, four proxies ---------------------

#: (proxy package, replica package) of each proxy in the stack.
TOPOLOGIES = [("jax", "jax"), ("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    made, proxies = [], {}
    try:
        runners = {"jax": [], "port": []}
        for i in range(2):
            for name, make in (("jax", _jax_runner), ("port", _port_runner)):
                r = make(_runtime(tmp_path_factory, f"{name}{i}"))
                r.start()
                made.append(r)
                runners[name].append(r)
        for proxy_pkg, replica_pkg in TOPOLOGIES:
            P = JAX if proxy_pkg == "jax" else PORT
            addrs = [_grpc_addr(r) for r in runners[replica_pkg]]
            router = P.proxy.build_router(addrs)
            server, bound = P.proxy.make_server(router, "127.0.0.1", 0)
            server.start()
            proxies[(proxy_pkg, replica_pkg)] = SimpleNamespace(
                P=P, router=router, server=server, addr=f"127.0.0.1:{bound}",
                replicas=runners[replica_pkg], addrs=addrs,
            )
        yield SimpleNamespace(runners=runners, proxies=proxies)
    finally:
        for p in proxies.values():
            p.server.stop(grace=None)
            p.router.close()
        for r in made:
            r.stop()


def test_every_proxy_enforces_one_limit_with_byte_equal_replies(stack):
    """Through each proxy's own gRPC server, a 3/min key over two
    replicas admits three and refuses the fourth; the four proxies'
    replies to the same sequence are byte-equal (each on a key of its
    own, since two proxies share each pair of runners)."""
    replies = {}
    for topo, p in stack.proxies.items():
        resps = [_call(p.addr, _request(f"joint-{'-'.join(topo)}")) for _ in range(4)]
        assert [r.overall_code for r in resps] == [OK] * 3 + [OVER]
        replies[topo] = [r.SerializeToString() for r in resps]
    assert len(set(map(tuple, replies.values()))) == 1, replies


@pytest.mark.parametrize("topo", TOPOLOGIES[2:], ids=["port-proxy-jax-replicas", "jax-proxy-port-replicas"])
def test_mixed_proxy_routes_every_key_to_the_same_owner(stack, topo):
    """A mixed proxy picks, for 300 keys, the owner its replicas'
    own package's proxy picks; and on the wire the hits land there:
    after two hits through the mixed proxy a direct hit on that owner
    counts the third, and its answer is byte-equal to what the same
    three hits through the replicas' own package's proxy give."""
    mixed = stack.proxies[topo]
    native = stack.proxies[(topo[1], topo[1])]
    assert mixed.addrs == native.addrs
    reqs = [_request(f"own{i}") for i in range(300)]
    owners = [mixed.router.owner_for("px", q.descriptors[0]) for q in reqs]
    assert owners == [native.router.owner_for("px", q.descriptors[0]) for q in reqs]
    assert set(owners) == {0, 1}
    for i in range(8):
        via_mixed, via_native = _request(f"land-m{i}-{topo[0]}"), _request(f"land-n{i}-{topo[0]}")
        owner = mixed.router.owner_for("px", via_mixed.descriptors[0])
        for _ in range(2):
            _call(mixed.addr, via_mixed)
            _call(native.addr, via_native)
        direct = _call(mixed.addrs[owner], via_mixed)
        other = _call(mixed.addrs[1 - owner], via_mixed)
        assert direct.statuses[0].limit_remaining == 0  # the third hit
        assert other.statuses[0].limit_remaining == 2  # a fresh counter
        native_owner = native.router.owner_for("px", via_native.descriptors[0])
        third = _call(native.addrs[native_owner], via_native)
        assert direct.SerializeToString() == third.SerializeToString()


def test_proxy_propagates_replica_errors(stack):
    """An empty domain is the replica's UNKNOWN error, not a
    proxy-wrapped one: through each router and each proxy server alike."""
    req = _request("x", domain="")
    seen = {}
    for topo, p in stack.proxies.items():
        via_router = _status(lambda: p.router.should_rate_limit(req))
        via_server = _status(lambda: _call(p.addr, req))
        assert via_router[0] == via_server[0] == grpc.StatusCode.UNKNOWN
        assert "domain" in via_router[1]
        seen[topo] = (via_router, via_server)
    assert len(set(seen.values())) == 1, seen


def test_proxy_serves_grpc_health(stack):
    assert {topo: _health(p.addr) for topo, p in stack.proxies.items()} == {
        topo: SERVING for topo in TOPOLOGIES
    }


def test_traceparent_propagates_proxy_to_replica(stack):
    """A sampled inbound traceparent rides proxy -> replica metadata:
    the replica's trace carries the caller's trace id and parents onto
    the proxy's root span, whichever package each hop runs."""
    seen = {}
    for i, (topo, p) in enumerate(stack.proxies.items()):
        ptracer = p.P.obs.TRACER
        rtracer = (jax_obs if topo[1] == "jax" else port_obs).TRACER
        ptracer.clear()
        rtracer.clear()
        tid = f"{i + 1:02x}" * 16
        sid = "cd" * 8
        _call(p.addr, _request(f"tracehop{i}"), [("traceparent", f"00-{tid}-{sid}-01")])
        proxy_t = [t for t in ptracer.recent() if t.trace_id == tid and t.root_name == "proxy.should_rate_limit"]
        replica_t = [t for t in rtracer.recent() if t.trace_id == tid and t.root_name == "grpc.should_rate_limit"]
        assert len(proxy_t) == 1 and len(replica_t) == 1, (topo, proxy_t, replica_t)
        root = [s for s in proxy_t[0].spans if s["name"] == "proxy.should_rate_limit"][0]
        seen[topo] = (
            proxy_t[0].sampled, replica_t[0].sampled, proxy_t[0].parent_id == sid,
            replica_t[0].parent_id == root["span_id"],
            tuple(sorted(s["name"] for s in proxy_t[0].spans)),
        )
    assert set(seen.values()) == {(True, True, True, True, ("proxy.should_rate_limit",))}, seen


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=["-".join(t) for t in TOPOLOGIES])
def test_proxy_fleet_json_merges_two_live_replicas(stack, topo):
    """/fleet.json scrapes both replicas' debug listeners through the
    admin map and merges them, whichever package serves either side;
    the shape is the same as the JAX proxy's over JAX replicas."""
    p = stack.proxies[topo]
    admin_urls = {
        _grpc_addr(r): f"http://127.0.0.1:{r.debug_server.bound_port}" for r in p.replicas
    }
    journal = p.P.obs.EventJournal(size=16)
    journal.emit("membership_change", old=[], new=sorted(admin_urls))
    holder = p.P.proxy.RouterHolder(p.router, events=journal)
    srv = p.P.proxy.start_debug_server(holder, "127.0.0.1", 0, admin_urls=admin_urls, events=journal)
    try:
        _call(p.addr, _request(f"fleet-{'-'.join(topo)}"))
        fleet = _get_json(f"http://127.0.0.1:{srv.bound_port}/fleet.json")
    finally:
        srv.stop()
    assert set(fleet["replicas"]) == set(admin_urls)
    for rid in admin_urls:
        scraped = fleet["replicas"][rid]
        assert scraped["metrics"]["up"] is True and "domains" in scraped["slo"]
        assert not any("error" in v for v in scraped.values() if isinstance(v, dict)), scraped
    assert "px" in fleet["slo"]["domains"] and fleet["slo"]["domains"]["px"]["replicas"] >= 1
    assert fleet["faults"]["quarantined_banks"] == []
    assert fleet["proxy"]["replicas"] == 2
    assert [e["type"] for e in fleet["events"] if e["replica"] == "_proxy"] == ["membership_change"]
    assert sorted(fleet) == ["cluster", "events", "faults", "hotkeys", "proxy", "replicas", "slo", "timeseries"]
    for rid in admin_urls:
        assert sorted(fleet["replicas"][rid]) == sorted(s for s, _ in port_fleet.REPLICA_ENDPOINTS)


# -- scenarios on fake transports, through both packages ----------------------


def _tagging_fake(addr):
    def call(req, timeout_s=None):
        resp = rls_pb2.RateLimitResponse(overall_code=OK)
        for _ in req.descriptors:
            s = resp.statuses.add()
            s.code = OK
            s.limit_remaining = int(addr.rsplit(":", 1)[1])
        return resp

    return call


def _empty(req, timeout_s=None):
    return rls_pb2.RateLimitResponse()


def _dead(req, timeout_s=None, metadata=None):
    raise ConnectionError("down")


def _ok(req, timeout_s=None, metadata=None):
    resp = rls_pb2.RateLimitResponse(overall_code=OK)
    for _ in req.descriptors:
        resp.statuses.add(code=OK)
    return resp


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_live_membership_change_via_replicas_file(tmp_path):
    def scenario(P):
        def build(addrs):
            return P.router.ReplicaRouter(addrs, [_tagging_fake(a) for a in addrs])

        f = tmp_path / f"replicas-{P.name}.txt"
        f.write_text("r0:1\nr1:2\n")
        holder = P.proxy.RouterHolder(build(P.proxy.read_replicas_file(str(f))))
        _thread, stop = P.proxy.watch_replicas_file(holder, str(f), poll_s=0.05)
        try:
            keys = [f"m{i}" for i in range(40)]
            before = {k: holder.should_rate_limit(_request(k)).statuses[0].limit_remaining for k in keys}
            assert set(before.values()) == {1, 2}
            f.write_text("r0:1\nr1:2\nr2:3\n")
            assert _wait(lambda: holder.replica_ids == ["r0:1", "r1:2", "r2:3"])
            holder.swap(build(["r0:1", "r1:2", "r2:3"]), grace_s=0.1)
            after = {k: holder.should_rate_limit(_request(k)).statuses[0].limit_remaining for k in keys}
            moved = [k for k in keys if after[k] != before[k]]
            assert {after[k] for k in moved} == {3} and 1 <= len(moved) <= len(keys) // 2
            return before, after
        finally:
            stop.set()
            holder.close()

    both(scenario)


def test_proxy_health_reflects_replica_liveness():
    def scenario(P):
        router = P.router.ReplicaRouter(["d0:1", "d1:2"], [_dead, _dead], eject_after=1, readmit_after_s=60.0)
        holder = P.proxy.RouterHolder(router)
        server, bound = P.proxy.make_server(holder, "127.0.0.1", 0)
        server.start()
        try:
            addr = f"127.0.0.1:{bound}"
            first = _health(addr)
            resp = _call(addr, _request("dead"))
            assert router.live_replica_count() == 0
            return first, resp.SerializeToString(), _health(addr)
        finally:
            server.stop(grace=None)
            router.close()

    assert both(scenario)[::2] == (SERVING, NOT_SERVING)


def test_proxy_health_watch_streams_transitions():
    def scenario(P):
        router = P.router.ReplicaRouter(["r0:1"], [_dead], eject_after=1)
        server, port = P.proxy.make_server(router, "127.0.0.1", 0)
        server.start()
        got, done = [], threading.Event()

        def watcher():
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                watch = ch.unary_stream(
                    "/grpc.health.v1.Health/Watch",
                    request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
                    response_deserializer=health_pb2.HealthCheckResponse.FromString,
                )
                for resp in watch(health_pb2.HealthCheckRequest(), timeout=15):
                    got.append(resp.status)
                    if len(got) >= 2:
                        done.set()
                        return

        try:
            t = threading.Thread(target=watcher, daemon=True)
            t.start()
            assert _wait(lambda: got)
            router.should_rate_limit(_request("watch"))
            assert done.wait(10)
            return list(got)
        finally:
            server.stop(grace=None)
            router.close()

    assert both(scenario) == [SERVING, NOT_SERVING]


def test_proxy_subcall_deadline_ceiling_is_configurable():
    def scenario(P):
        seen = []

        class _FakeMethod:
            def __call__(self, request, timeout=None, metadata=None):
                seen.append((timeout, metadata))
                return rls_pb2.RateLimitResponse()

        class _FakeChannel:
            def unary_unary(self, *a, **kw):
                return _FakeMethod()

        call = P.proxy.grpc_transport(_FakeChannel())
        for t in (2.0, None, 120.0):
            call(rls_pb2.RateLimitRequest(), timeout_s=t)
        P.proxy.grpc_transport(_FakeChannel(), max_subcall_s=300.0)(rls_pb2.RateLimitRequest(), timeout_s=120.0)
        tok = P.proxy.grpc_transport(_FakeChannel(), auth_token="s3")
        tok(rls_pb2.RateLimitRequest())
        tok(rls_pb2.RateLimitRequest(), metadata=[("x-ratelimit-corr", "00")])
        return seen

    got = both(scenario)
    assert [t for t, _ in got[:4]] == [2.0, 30.0, 30.0, 120.0]
    assert got[4][1] == (("authorization", "Bearer s3"),)


def test_watcher_retries_empty_file(tmp_path):
    def scenario(P):
        f = tmp_path / f"replicas-{P.name}.txt"
        f.write_text("a:1\n")
        holder = P.proxy.RouterHolder(P.router.ReplicaRouter(["a:1"], [_empty]))
        built = []

        def build(addrs):
            built.append(list(addrs))
            return P.router.ReplicaRouter(addrs, [_empty] * len(addrs))

        t, stop = P.proxy.watch_replicas_file(holder, str(f), poll_s=0.05, build=build)
        try:
            f.write_text("")
            os.utime(str(f), (1_000_000, 1_000_000))
            time.sleep(0.2)
            kept = list(holder.replica_ids)
            f.write_text("a:1\nb:2\n")
            os.utime(str(f), (1_000_000, 1_000_000))
            assert _wait(lambda: holder.replica_ids == ["a:1", "b:2"])
            return kept, list(holder.replica_ids), built
        finally:
            stop.set()
            t.join(timeout=5)
            holder.close()

    assert both(scenario)[0] == ["a:1"]


def test_watcher_keeps_membership_on_unparseable_entry(tmp_path):
    def scenario(P):
        bad = tmp_path / f"bad-{P.name}.txt"
        bad.write_text("a:1\nnot-an-address\n")
        with pytest.raises(ValueError, match="unparseable") as err:
            P.proxy.read_replicas_file(str(bad))
        f = tmp_path / f"replicas-{P.name}.txt"
        f.write_text("a:1\n")
        holder = P.proxy.RouterHolder(P.router.ReplicaRouter(["a:1"], [_empty]))

        def build(addrs):
            return P.router.ReplicaRouter(addrs, [_empty] * len(addrs))

        t, stop = P.proxy.watch_replicas_file(holder, str(f), poll_s=0.05, build=build)
        try:
            f.write_text("a:1\nb:\ngarbage\n")
            os.utime(str(f), (1_000_000, 1_000_000))
            time.sleep(0.25)
            kept = list(holder.replica_ids)
            f.write_text("a:1\nb:2\n")
            os.utime(str(f), (1_000_000, 1_000_000))
            assert _wait(lambda: holder.replica_ids == ["a:1", "b:2"])
            return str(err.value).replace(str(bad), "<file>"), kept
        finally:
            stop.set()
            t.join(timeout=5)
            holder.close()

    assert both(scenario)[1] == ["a:1"]


def test_srv_membership_growth_shrink_and_keep_old_on_error():
    def scenario(P):
        def build(addrs):
            return P.router.ReplicaRouter(addrs, [_ok] * len(addrs))

        answers = {"v": ["r0:1", "r1:2"]}

        def resolve(record):
            assert record == "_rl._tcp.cluster.local"
            if answers["v"] == "boom":
                raise P.srv.SrvError("dns timeout")
            return list(answers["v"])

        holder = P.proxy.RouterHolder(build(["r0:1", "r1:2"]))
        _t, stop = P.proxy.watch_replicas_srv(
            holder, "_rl._tcp.cluster.local", refresh_s=0.05, build=build, resolve=resolve
        )
        seen = []
        try:
            answers["v"] = ["r0:1", "r1:2", "r2:3"]
            assert _wait(lambda: set(holder.replica_ids) == {"r0:1", "r1:2", "r2:3"})
            seen.append(sorted(holder.replica_ids))
            answers["v"] = "boom"
            time.sleep(0.3)
            seen.append(sorted(holder.replica_ids))
            seen.append(holder.should_rate_limit(_request("srv-key")).SerializeToString())
            answers["v"] = []
            time.sleep(0.3)
            seen.append(sorted(holder.replica_ids))
            answers["v"] = ["r0:1", "r2:3"]
            assert _wait(lambda: set(holder.replica_ids) == {"r0:1", "r2:3"})
            seen.append(sorted(holder.replica_ids))
            return seen
        finally:
            stop.set()
            holder.close()

    got = both(scenario)
    assert got[1] == got[3] == ["r0:1", "r1:2", "r2:3"]


def test_srv_initial_resolution_retries_until_populated():
    def scenario(P):
        calls = {"n": 0}

        def resolve(record):
            calls["n"] += 1
            if calls["n"] == 1:
                raise P.srv.SrvError("dns timeout")
            if calls["n"] == 2:
                return []
            return ["r0:1", "r0:1", "r1:2"]

        addrs = P.proxy.resolve_srv_initial("_rl._tcp.x", retry_s=0.01, resolve=resolve)
        stop = threading.Event()
        stop.set()
        with pytest.raises(P.srv.SrvError) as err:
            P.proxy.resolve_srv_initial("_rl._tcp.x", retry_s=0.01, resolve=lambda r: [], stop=stop)
        return addrs, calls["n"], str(err.value)

    assert both(scenario)[:2] == (["r0:1", "r1:2"], 3)


def test_proxy_debug_listener_serves_stats_and_health():
    def scenario(P):
        holder = P.proxy.RouterHolder(P.router.ReplicaRouter(["r0:1"], [_dead], eject_after=1))
        srv = P.proxy.start_debug_server(holder, "127.0.0.1", 0)
        try:
            base = f"http://127.0.0.1:{srv.bound_port}"
            first = _get_json(base + "/stats.json")
            health = urllib.request.urlopen(base + "/healthcheck", timeout=5).status
            holder.should_rate_limit(_request("dbg"))
            second = _get_json(base + "/stats.json")
            cluster = _get_json(base + "/debug/cluster")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/healthcheck", timeout=5)
            missing = []
            for path in ("/debug/events", "/debug/flight", "/fleet.json"):
                with pytest.raises(urllib.error.HTTPError) as e404:
                    urllib.request.urlopen(base + path, timeout=5)
                missing.append(e404.value.code)
            for snap in (second, cluster):
                for s in snap["replica_states"]:
                    s["open_since_s"] = s["open_since_s"] is not None
            return first, health, second, cluster, err.value.code, missing
        finally:
            srv.stop()
            holder.close()

    first, health, second, _, code, _ = both(scenario)
    assert first["replica_ids"] == ["r0:1"] and first["live_replicas"] == 1 and health == 200
    assert second["live_replicas"] == 0 and second["ejections"] == 1 and code == 500


def test_arg_parser_is_the_jax_proxy_parser():
    """Every flag, default, choice and requirement of the JAX proxy's
    command line, the debug listener on loopback by default."""

    def scenario(P):
        p = P.proxy.build_arg_parser()
        actions = [
            (a.option_strings, a.dest, a.default, a.choices, a.required, a.type and a.type.__name__, a.help)
            for a in p._actions
        ]
        args = vars(p.parse_args(["--replicas", "r0:1"]))
        assert args["host"] == "0.0.0.0" and args["debug_host"] == "127.0.0.1"
        assert "UNAUTHENTICATED" in p.format_help()
        return actions, args

    both(scenario)


def test_proxy_stats_shape_handoff_age_and_circuit_open_since():
    def scenario(P):
        journal = P.obs.EventJournal(size=32)
        holder = P.proxy.RouterHolder(
            P.router.ReplicaRouter(["r0:1", "r1:2"], [_dead, _ok], eject_after=1, readmit_after_s=60.0),
            handoff=lambda old, new: {
                "old": old, "new": new, "moved_keys": 2, "imported": 2,
                "merged": 0, "dropped": 0, "duration_s": 0.01,
            },
            events=journal,
        )
        srv = P.proxy.start_debug_server(holder, "127.0.0.1", 0, events=journal)
        try:
            base = f"http://127.0.0.1:{srv.bound_port}"
            snap0 = _get_json(base + "/stats.json")
            assert "last_handoff_age_s" not in snap0
            for _ in range(3):
                holder.should_rate_limit(_request("shape"))
            snap1 = _get_json(base + "/stats.json")
            states = {s["id"]: s for s in snap1["replica_states"]}
            assert isinstance(states["r0:1"]["open_since_s"], float)
            holder.swap(P.router.ReplicaRouter(["r0:1", "r1:2", "r2:3"], [_ok, _ok, _ok]), grace_s=0.1)
            assert _wait(lambda: holder.last_handoff is not None)
            snap2 = _get_json(base + "/stats.json")
            assert isinstance(snap2["last_handoff_age_s"], float)
            events = _get_json(base + "/debug/events")
            for snap in (snap0, snap1, snap2):
                snap.pop("last_handoff_age_s", None)
                for s in snap["replica_states"]:
                    s["open_since_s"] = s["open_since_s"] is not None
            for e in events["events"]:
                for k in [k for k in e if k.startswith("ts_")]:
                    e[k] = "<t>"
            return snap0, snap1, snap2, events
        finally:
            srv.stop()
            holder.close()

    *_, events = both(scenario)
    types = [e["type"] for e in events["events"]]
    assert types == ["membership_change", "handoff_begin", "handoff_end"]


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=["-".join(t) for t in TOPOLOGIES])
def test_corr_id_joins_proxy_ring_replica_ring_and_span_tree(tmp_path_factory, topo):
    """The proxy mints one correlation id, stamps it into its flight
    ring and carries it in x-ratelimit-corr to the owner (a memory
    runner with FLIGHT_CORR_ENABLED), where the same hex16 id lands in
    the replica's ring and its span attrs -- across the packages too."""
    P = JAX if topo[0] == "jax" else PORT
    make = _jax_runner if topo[1] == "jax" else _port_runner
    rtracer = (jax_obs if topo[1] == "jax" else port_obs).TRACER
    r = make(_runtime(tmp_path_factory, "corr"), backend_type="memory",
             flight_recorder_size=64, flight_corr_enabled=True)
    r.start()
    proxy_flight = P.obs.make_flight_recorder(64)
    router = P.proxy.build_router([_grpc_addr(r)], flight=proxy_flight)
    server, bound = P.proxy.make_server(router, "127.0.0.1", 0, flight=proxy_flight)
    server.start()
    try:
        rtracer.clear()
        resp = _call(f"127.0.0.1:{bound}", _request("corrjoin"),
                     [("traceparent", f"00-{'12' * 16}-{'34' * 8}-01")])
        assert resp.overall_code == OK
        proxy_recs = proxy_flight.snapshot_dicts()
        corr = proxy_recs[0]["corr"]
        assert len(corr) == 16 and int(corr, 16) != 0
        assert corr in [rec.get("corr") for rec in r.flight.snapshot_dicts()]
        traces = [t for t in rtracer.recent()
                  if t.root_name == "grpc.should_rate_limit" and t.trace_id == "12" * 16]
        root = [s for s in traces[0].spans if s["name"] == "grpc.should_rate_limit"][0]
        assert root["attrs"]["corr"] == corr
        assert proxy_recs[0]["lane"] == 0 and proxy_recs[0]["code"] == OK
    finally:
        server.stop(grace=None)
        router.close()
        r.stop()


# -- the fleet merges of tests/test_events_fleet.py ---------------------------


def _bodies():
    """The JAX fleet test's scraped bodies (the same bytes for both
    aggregators) and its stats-only holder."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_events_fleet as tef

    return tef._replica_bodies, tef._Holder


def _make_agg(P, admin_urls, journal=None, fail=()):
    replica_bodies, _ = _bodies()
    fetched = []

    def fetch(url):
        fetched.append(url)
        for rid, base in admin_urls.items():
            if url.startswith(base):
                path = url[len(base):]
                if (rid, path) in fail:
                    raise ConnectionError("scrape down")
                return replica_bodies(rid)[path]
        raise AssertionError(f"unexpected url {url}")

    return P.fleet.FleetAggregator(admin_urls, timeout_s=1.0, events=journal, fetch=fetch), fetched


ADMIN = {"r0:1": "http://h0:6070", "r1:2": "http://h1:6070"}


def test_fleet_merges_slo_hotkeys_faults_events():
    def scenario(P):
        _, Holder = _bodies()
        journal = P.obs.EventJournal(size=8, wall=lambda: 75.0)
        journal.emit("membership_change", old=["r0:1"], new=["r0:1", "r1:2"])
        agg, fetched = _make_agg(P, ADMIN, journal=journal)
        holder = Holder({"replicas": 2, "replica_states": [
            {"id": "r0:1", "state": "closed"}, {"id": "r1:2", "state": "closed"},
        ]})
        fleet = agg.fleet(holder)
        for e in fleet["events"]:
            if e["replica"] == "_proxy":
                e["ts_mono_ns"] = "<t>"
        return fleet, fetched

    fleet, _ = both(scenario)
    chat = fleet["slo"]["domains"]["chat"]
    assert chat["requests"] == 200 and chat["burn_rate"] == pytest.approx(1.25)
    assert fleet["hotkeys"]["keys"][0]["key"] == "chat/user_u1"
    assert [(e["replica"], e["type"]) for e in fleet["events"]] == [
        ("r1:2", "bank_quarantine"), ("_proxy", "membership_change"), ("r0:1", "bank_quarantine"),
    ]


def test_fleet_merges_timeseries_summaries_from_live_replicas():
    def scenario(P):
        _, Holder = _bodies()
        agg, _ = _make_agg(P, ADMIN)
        fleet = agg.fleet(Holder({"replicas": 2, "replica_states": []}))
        json.dumps(fleet["timeseries"])
        return fleet

    fleet = both(scenario)
    assert fleet["timeseries"]["r0:1"]["summary"]["decisions_per_s"]["last"] == 1000.0


def test_fleet_skips_open_circuits_and_degrades_per_endpoint():
    def scenario(P):
        _, Holder = _bodies()
        agg, fetched = _make_agg(P, ADMIN, fail=(("r0:1", "/debug/slo"),))
        fleet = agg.fleet(Holder({"replica_states": [
            {"id": "r0:1", "state": "closed"},
            {"id": "r1:2", "state": "open", "open_since_s": 3.2},
        ]}))
        return fleet, fetched

    fleet, fetched = both(scenario)
    assert fleet["replicas"]["r1:2"] == {"skipped": "circuit open"}
    assert not any("h1:6070" in u for u in fetched)
    assert "error" in fleet["replicas"]["r0:1"]["slo"] and fleet["slo"]["domains"] == {}


# -- the proxy process --------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_proxy_main_serves_in_its_own_process_and_exits_zero_on_sigterm(tmp_path_factory):
    """``python -m ratelimit_tpu_torch.cluster.proxy`` in front of a port
    runner: it answers through its gRPC port and its debug listener,
    its process maps no torch library, and SIGTERM ends it with 0."""
    r = _port_runner(_runtime(tmp_path_factory, "main"))
    r.start()
    port, debug_port = _free_port(), _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ratelimit_tpu_torch.cluster.proxy",
         "--replicas", _grpc_addr(r), "--host", "127.0.0.1", "--port", str(port),
         "--debug-port", str(debug_port), "--flight-recorder-size", "16"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        addr = f"127.0.0.1:{port}"
        deadline = time.monotonic() + 30
        # Up once gRPC health answers SERVING and the debug listener,
        # which main starts after the gRPC server, answers too.
        while True:
            try:
                if _health(addr) == SERVING and _get_json(f"http://127.0.0.1:{debug_port}/stats.json"):
                    break
            except (grpc.RpcError, OSError):
                pass
            assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()
            time.sleep(0.1)
        codes = [_call(addr, _request("main")).overall_code for _ in range(4)]
        assert codes == [OK] * 3 + [OVER]
        stats = _get_json(f"http://127.0.0.1:{debug_port}/stats.json")
        assert stats["replica_ids"] == [_grpc_addr(r)] and stats["live_replicas"] == 1
        flight = _get_json(f"http://127.0.0.1:{debug_port}/debug/flight")
        assert [rec["code"] for rec in flight["records"]] == [OVER, OK, OK, OK]
        with open(f"/proc/{proc.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libc10" not in maps
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err[-2000:]
        assert "cluster proxy serving" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        r.stop()
