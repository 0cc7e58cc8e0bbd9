"""The port's rendezvous router (ratelimit_tpu_torch/cluster/router.py)
against the JAX package's, on the CPU.

Every scenario of the JAX package's tests/test_cluster_router.py and of
the routing half of tests/test_cluster_handoff.py (the failure-mode
matrix and its aliases, the local over-limit cache, same-owner retries
against the caller's deadline, the forwarding window, the edge cases,
the fault injector driving ejection) runs through both packages'
routers with the same fake transports, seeded ``random.Random`` and
fake ``sleep``.  Each scenario keeps the JAX test's checks and returns
its observations -- owners, merged responses as wire bytes, ``stats()``
dicts, call counts, sleeps, the exceptions raised -- which must be
equal between the packages; only ``open_since_s``, the age of an outage
on the monotonic clock, is masked.  Beyond them: ``owner_for`` on
10,000 seeded descriptors over two to five replica ids, and two port
runners (device="cpu") jointly enforcing one limit behind the port's
router over real gRPC, beside two JAX runners behind the JAX router.
"""

import random
import socket
import threading
import time
from types import SimpleNamespace

import grpc
import pytest

import ratelimit_tpu.cluster.faults as jax_faults
import ratelimit_tpu.cluster.hashing as jax_hashing
import ratelimit_tpu.cluster.proxy as jax_proxy
import ratelimit_tpu.cluster.router as jax_router
import ratelimit_tpu_torch.cluster.faults as port_faults
import ratelimit_tpu_torch.cluster.hashing as port_hashing
import ratelimit_tpu_torch.cluster.proxy as port_proxy
import ratelimit_tpu_torch.cluster.router as port_router
from ratelimit_tpu.limiter.cache_key import build_stem as jax_build_stem
from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.limiter.cache_key import build_stem
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

JAX = SimpleNamespace(
    name="jax", router=jax_router, faults=jax_faults, hashing=jax_hashing,
    proxy=jax_proxy, build_stem=jax_build_stem,
)
PORT = SimpleNamespace(
    name="port", router=port_router, faults=port_faults, hashing=port_hashing,
    proxy=port_proxy, build_stem=build_stem,
)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT
MINUTE = rls_pb2.RateLimitResponse.RateLimit.MINUTE


def both(scenario, *args):
    """Run `scenario(P, *args)` through each package; the observations
    must be equal.  Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def wire(resp):
    return resp.SerializeToString()


def stats(router):
    """stats() with the outage ages (monotonic durations) masked."""
    st = router.stats()
    st["replica_states"] = [
        {**s, "open_since_s": None if s["open_since_s"] is None else "<t>"}
        for s in st["replica_states"]
    ]
    return st


def raised(fn):
    """The exception `fn()` raises, as (class name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the observation itself
        return type(e).__name__, str(e)
    raise AssertionError("expected an exception")


def _request(domain, descriptors, hits=0):
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
    for entries in descriptors:
        d = req.descriptors.add()
        for k, v in entries:
            e = d.entries.add()
            e.key, e.value = k, v
    return req


def _fake_service(code, remaining=3):
    def call(req, timeout_s=None):
        resp = rls_pb2.RateLimitResponse(overall_code=code)
        for _ in req.descriptors:
            s = resp.statuses.add()
            s.code = code
            s.current_limit.requests_per_unit = 5
            s.current_limit.unit = MINUTE
            s.limit_remaining = remaining
        return resp

    return call


def _ok_response(n):
    resp = rls_pb2.RateLimitResponse(overall_code=OK)
    for _ in range(n):
        resp.statuses.add().code = OK
    return resp


def _ok(req, timeout_s=None):
    return _ok_response(len(req.descriptors))


def _one_per_owner(router, tag, domain="basic"):
    """One descriptor owned by each of the router's two replicas."""
    want = {0: None, 1: None}
    i = 0
    while None in want.values():
        d = [("key1", f"{tag}{i}")]
        owner = router.owner_for(domain, _request(domain, [d]).descriptors[0])
        if want[owner] is None:
            want[owner] = d
        i += 1
    return [want[0], want[1]]


class _Code:
    def __init__(self, name):
        self.name = name


class _StatusError(Exception):
    """An error carrying a gRPC status name, as a transport raises it."""

    status = "UNKNOWN"

    def code(self):
        return _Code(self.status)

    def details(self):
        return "rate limit domain must not be empty"


class _Deadline(_StatusError):
    status = "DEADLINE_EXCEEDED"


# -- pure routing -----------------------------------------------------------


def test_owner_for_agrees_on_10000_seeded_descriptors():
    """The same seeded descriptors (one to three entries, five domains)
    over two to five replica ids get the same owner from both routers,
    and the owner is the rendezvous owner of the cache-key stem."""
    rng = random.Random(20261017)
    descs = []
    for _ in range(10_000):
        domain = f"d{rng.randrange(5)}"
        entries = [
            (f"k{rng.randrange(8)}", f"v{rng.randrange(1 << 20)}")
            for _ in range(rng.randint(1, 3))
        ]
        descs.append((domain, _request(domain, [entries]).descriptors[0]))

    def owners(P):
        out = {}
        for n in range(2, 6):
            ids = [f"10.0.0.{i}:8081" for i in range(n)]
            r = P.router.ReplicaRouter(ids, [_ok] * n)
            try:
                out[n] = [r.owner_for(d, desc) for d, desc in descs]
                for (d, desc), o in zip(descs[:500], out[n][:500]):
                    stem = P.build_stem("", d, desc.entries)
                    assert P.router.routing_key(d, desc) == stem
                    assert P.hashing.owner_of(stem, ids) == o
            finally:
                r.close()
        return out

    got = both(owners)
    for n, os_ in got.items():
        assert set(os_) == set(range(n))  # every replica owns some keys


def test_rendezvous_is_order_independent_and_stable():
    def scenario(P):
        ids = ["10.0.0.1:8081", "10.0.0.2:8081", "10.0.0.3:8081"]
        keys = [f"d|k_{i}" for i in range(200)]
        owners = {k: ids[P.router.owner_of(k, ids)] for k in keys}
        shuffled = [ids[2], ids[0], ids[1]]
        for k in keys:
            assert shuffled[P.router.owner_of(k, shuffled)] == owners[k]
        return owners

    both(scenario)


def test_rendezvous_membership_change_moves_about_one_nth():
    def scenario(P):
        ids = [f"r{i}" for i in range(4)]
        keys = [f"d|k_{i}" for i in range(2000)]
        before = {k: ids[P.router.owner_of(k, ids)] for k in keys}
        grown = ids + ["r4"]
        after = {k: grown[P.router.owner_of(k, grown)] for k in keys}
        moved = [k for k in keys if after[k] != before[k]]
        assert 250 <= len(moved) <= 600
        assert {after[k] for k in moved} == {"r4"}
        return after

    both(scenario)


def test_routing_key_matches_cache_key_granularity():
    def scenario(P):
        r = _request("dom", [[("a", "1"), ("b", "2")]])
        key = P.router.routing_key("dom", r.descriptors[0])
        assert key == "dom_a_1_b_2_"
        assert key == P.build_stem("", "dom", r.descriptors[0].entries)
        assert P.hashing.stem_of_cache_key(key + "1700000040") == key
        assert P.hashing.stem_of_cache_key("pfx:" + key + "1700000040", "pfx:") == key
        return key

    both(scenario)


# -- merge semantics with fake transports -------------------------------------


def test_merge_preserves_order_and_ors_codes():
    def scenario(P):
        r = P.router.ReplicaRouter(["a", "b"], [_fake_service(OK), _fake_service(OVER, remaining=0)])
        try:
            resp = r.should_rate_limit(_request("basic", _one_per_owner(r, "v")))
            assert resp.overall_code == OVER
            assert [s.code for s in resp.statuses] == [OK, OVER]
            return wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_merge_takes_headers_of_the_minimum_remaining():
    """Headers follow the sub-response holding the smallest remaining,
    an OVER_LIMIT one winning a tie; statuses keep request order."""

    def replica(code, remaining, tag):
        def call(req, timeout_s=None):
            resp = _fake_service(code, remaining)(req)
            h = resp.response_headers_to_add.add()
            h.key, h.value = "x-ratelimit-remaining", f"{tag}-{remaining}"
            return resp

        return call

    def scenario(P, codes):
        r = P.router.ReplicaRouter(
            ["a", "b"], [replica(codes[0], 2, "a"), replica(codes[1], 2, "b")]
        )
        try:
            descs = _one_per_owner(r, "hdr")
            return [wire(r.should_rate_limit(_request("basic", order))) for order in (descs, descs[::-1])]
        finally:
            r.close()

    for codes in ((OK, OK), (OK, OVER), (OVER, OK)):
        both(scenario, codes)


def test_expired_deadline_fails_fast_without_replica_calls():
    def scenario(P):
        calls = []

        def transport(req, timeout_s=None):
            calls.append(timeout_s)
            return _ok_response(len(req.descriptors))

        r = P.router.ReplicaRouter(["a"], [transport])
        try:
            req = _request("basic", [[("key1", "dl")]])
            resp = r.should_rate_limit(req, timeout_s=5.0)
            assert calls and 0 < calls[0] <= 5.0
            calls.clear()
            err = raised(lambda: r.should_rate_limit(req, timeout_s=0.0))
            assert err[0] == "DeadlineExceededError" and calls == []
            return wire(resp), err, calls
        finally:
            r.close()

    both(scenario)


# -- replica health and failover ----------------------------------------------


class _FlakyTransport:
    """Fake replica that can be killed and revived; counts calls."""

    def __init__(self, code=OK):
        self.dead = False
        self.calls = 0
        self._inner = _fake_service(code)

    def __call__(self, req, timeout_s=None):
        self.calls += 1
        if self.dead:
            raise ConnectionError("replica down")
        return self._inner(req, timeout_s)


def _router3(P, **kw):
    fakes = [_FlakyTransport() for _ in range(3)]
    r = P.router.ReplicaRouter(
        ["r0:1", "r1:2", "r2:3"],
        fakes,
        eject_after=kw.pop("eject_after", 2),
        readmit_after_s=kw.pop("readmit_after_s", 30.0),
        **kw,
    )
    return r, fakes


def _spread_requests(n=40):
    return [_request("basic", [[("key1", f"fo{i}")]]) for i in range(n)]


def test_dead_replica_fails_over_and_ejects():
    def scenario(P):
        r, fakes = _router3(P)
        try:
            reqs = _spread_requests()
            first = [wire(r.should_rate_limit(q)) for q in reqs]
            assert all(f.calls > 0 for f in fakes)
            fakes[1].dead = True
            during = [wire(r.should_rate_limit(q)) for q in reqs]
            assert r.live_replica_count() == 2
            calls = [f.calls for f in fakes]
            fakes[1].calls = 0
            for q in reqs:
                r.should_rate_limit(q)
            assert fakes[1].calls == 0
            st = stats(r)
            assert st["ejections"] == 1 and st["live_replicas"] == 2
            assert st["failovers"] > 0 and st["fallback_descriptors"] == 0
            return first, during, calls, st
        finally:
            r.close()

    both(scenario)


def test_ejected_replica_readmitted_on_recovery():
    def scenario(P):
        r, fakes = _router3(P, readmit_after_s=0.05)
        try:
            reqs = _spread_requests()
            fakes[2].dead = True
            for q in reqs:
                r.should_rate_limit(q)
            assert r.live_replica_count() == 2
            fakes[2].dead = False
            deadline = time.monotonic() + 5
            while r.live_replica_count() < 3 and time.monotonic() < deadline:
                for q in reqs:
                    r.should_rate_limit(q)
                time.sleep(0.06)
            st = stats(r)
            assert st["live_replicas"] == 3 and fakes[2].calls > 0
            assert st["readmissions"] == 1
            # After readmission every key is back on its own owner.
            return st["readmissions"], st["ejections"], [wire(r.should_rate_limit(q)) for q in reqs]
        finally:
            r.close()

    both(scenario)


@pytest.mark.parametrize("policy", ["open", "closed"])
def test_all_dead_failure_policy_open_and_closed(policy):
    def scenario(P):
        r, fakes = _router3(P, failure_policy=policy)
        try:
            for f in fakes:
                f.dead = True
            req = _request("basic", [[("key1", "a")], [("key1", "b")]])
            for _ in range(4):
                r.should_rate_limit(req)
            assert r.live_replica_count() == 0
            resp = r.should_rate_limit(req)
            want = OK if policy == "open" else OVER
            assert [s.code for s in resp.statuses] == [want, want]
            assert r.stats()["fallback_descriptors"] >= 2
            return wire(resp), stats(r), [f.calls for f in fakes]
        finally:
            r.close()

    both(scenario)


def test_application_errors_propagate_without_ejection():
    def scenario(P):
        calls = {"n": 0}

        def app_error_transport(req, timeout_s=None):
            calls["n"] += 1
            raise _StatusError()

        r = P.router.ReplicaRouter(["r0:1"], [app_error_transport], eject_after=1)
        try:
            req = _request("basic", [[("key1", "x")]])
            errs = [raised(lambda: r.should_rate_limit(req)) for _ in range(5)]
            assert r.live_replica_count() == 1 and calls["n"] == 5
            return errs, calls["n"], stats(r)
        finally:
            r.close()

    both(scenario)


def test_failover_is_transparent_mid_stream():
    def scenario(P):
        fakes = [_FlakyTransport() for _ in range(2)]
        seen = {"n": 0}

        def counting(req, timeout_s=None):
            resp = rls_pb2.RateLimitResponse()
            for _ in req.descriptors:
                seen["n"] += 1
                code = OK if seen["n"] <= 5 else OVER
                resp.statuses.add().code = code
                resp.overall_code = max(resp.overall_code, code)
            return resp

        r = P.router.ReplicaRouter(["r0:1", "r1:2"], [fakes[0], counting], eject_after=1)
        try:
            key = next(
                q for q in (_request("basic", [[("key1", f"mv{i}")]]) for i in range(50))
                if r.owner_for("basic", q.descriptors[0]) == 0
            )
            fakes[0].dead = True
            codes = [r.should_rate_limit(key).statuses[0].code for _ in range(7)]
            assert codes == [OK] * 5 + [OVER] * 2
            return codes, stats(r)
        finally:
            r.close()

    both(scenario)


def test_tight_caller_deadline_does_not_eject():
    def scenario(P):
        def slow(req, timeout_s=None):
            raise _Deadline()

        r = P.router.ReplicaRouter(["r0:1"], [slow], eject_after=1)
        try:
            req = _request("basic", [[("key1", "x")]])
            errs = [raised(lambda: r.should_rate_limit(req, timeout_s=0.5)) for _ in range(5)]
            assert r.live_replica_count() == 1
            resp = r.should_rate_limit(req, timeout_s=60.0)
            assert resp.overall_code == OK and r.live_replica_count() == 0
            return errs, wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_half_open_probe_is_single_flight_per_period():
    def scenario(P):
        r, fakes = _router3(P, readmit_after_s=0.2)
        try:
            fakes[0].dead = True
            for q in _spread_requests():
                r.should_rate_limit(q)
            assert r.live_replica_count() == 2
            time.sleep(0.25)
            first, claimed = r._candidates_claiming()
            assert 0 in first and 0 in claimed
            second, _ = r._candidates_claiming()
            assert 0 not in second
            r._release_probes(claimed)
            third, _ = r._candidates_claiming()
            assert 0 in third
            return first, claimed, second, third
        finally:
            r.close()

    both(scenario)


def test_low_transport_ceiling_still_ejects_hung_replicas():
    def scenario(P):
        def blackholed(req, timeout_s=None):
            raise _Deadline()

        req = _request("basic", [[("key1", "x")]])
        r = P.router.ReplicaRouter(["r0:1"], [blackholed], eject_after=1, transport_ceiling_s=1.0)
        r2 = P.router.ReplicaRouter(["r0:1"], [blackholed], eject_after=1, transport_ceiling_s=1.0)
        try:
            resp = r.should_rate_limit(req)
            assert resp.overall_code == OK and r.live_replica_count() == 0
            err = raised(lambda: r2.should_rate_limit(req, timeout_s=0.3))
            assert r2.live_replica_count() == 1
            return wire(resp), stats(r), err, stats(r2)
        finally:
            r.close()
            r2.close()

    both(scenario)


def test_programming_errors_propagate_without_ejection():
    def scenario(P):
        calls = {"n": 0}

        def buggy_wrapper(req, timeout_s=None):
            calls["n"] += 1
            raise TypeError("unexpected keyword argument 'metadata'")

        r = P.router.ReplicaRouter(["r0:1"], [buggy_wrapper], eject_after=1)
        try:
            req = _request("basic", [[("key1", "x")]])
            errs = [raised(lambda: r.should_rate_limit(req)) for _ in range(3)]
            assert r.live_replica_count() == 1 and calls["n"] == 3
            return errs, stats(r)
        finally:
            r.close()

    both(scenario)


def test_zero_descriptor_walk_is_time_bounded():
    def scenario(P):
        attempts = []

        def dead(i):
            def t(req, timeout_s=None):
                attempts.append((i, timeout_s is not None and timeout_s <= 5.0))
                raise ConnectionError("down")

            return t

        def healthy(req, timeout_s=None):
            attempts.append(("ok", timeout_s is not None and timeout_s <= 5.0))
            return rls_pb2.RateLimitResponse(overall_code=OK)

        r = P.router.ReplicaRouter(["r0:1", "r1:1", "r2:1"], [dead(0), dead(1), healthy], eject_after=0)
        try:
            resp = r.should_rate_limit(rls_pb2.RateLimitRequest(domain="basic"))
            assert resp.overall_code == OK and attempts[-1][0] == "ok"
            assert all(ok for _i, ok in attempts)
            first = (wire(resp), list(attempts))
        finally:
            r.close()
        attempts.clear()
        r = P.router.ReplicaRouter([f"r{i}:1" for i in range(5)], [dead(i) for i in range(5)], eject_after=0)
        try:
            resp = r.should_rate_limit(rls_pb2.RateLimitRequest(domain="basic"))
            assert resp.overall_code == OK and len(attempts) == 5
            return first, (wire(resp), sorted(attempts), stats(r))
        finally:
            r.close()

    both(scenario)


def test_socket_timeout_respects_hang_floor():
    def scenario(P):
        def slow(req, timeout_s=None):
            raise socket.timeout("timed out")

        r = P.router.ReplicaRouter(["r0:1"], [slow], eject_after=1)
        try:
            req = _request("basic", [[("key1", "x")]])
            errs = [raised(lambda: r.should_rate_limit(req, timeout_s=0.5)) for _ in range(3)]
            assert r.live_replica_count() == 1
            resp = r.should_rate_limit(req, timeout_s=60.0)
            assert resp.overall_code == OK and r.live_replica_count() == 0
            return errs, wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_empty_walk_probe_timeout_never_undercuts_hang_floor():
    def scenario(P):
        seen = []

        def hung(i):
            def t(req, timeout_s=None):
                seen.append(i)
                raise _Deadline()

            return t

        def healthy(req, timeout_s=None):
            seen.append("ok")
            return rls_pb2.RateLimitResponse(overall_code=OK)

        r = P.router.ReplicaRouter(["r0:1", "r1:1", "r2:1"], [hung(0), hung(1), healthy], eject_after=1)
        r._EMPTY_PROBE_TIMEOUT_S = 0.5
        assert r._probe_timeout_s() == 5.0
        try:
            resp = r.should_rate_limit(rls_pb2.RateLimitRequest(domain="basic"))
            assert resp.overall_code == OK and seen[-1] == "ok"
            assert r.live_replica_count() == 1
            first = (wire(resp), list(seen), stats(r))
        finally:
            r.close()

        def slow(req, timeout_s=None):
            time.sleep(0.25)
            raise _Deadline()

        r2 = P.router.ReplicaRouter(["r0:1"], [slow], eject_after=1)
        r2._EMPTY_PROBE_TIMEOUT_S = 0.5
        try:
            err = raised(lambda: r2.should_rate_limit(rls_pb2.RateLimitRequest(domain="basic"), timeout_s=0.2))
            assert err[0] == "DeadlineExceededError"
            assert r2.live_replica_count() == 1
            return first, err, stats(r2)
        finally:
            r2.close()

    both(scenario)


def test_clamped_probe_expiry_never_ejects_healthy_replica():
    def scenario(P):
        def hung_or_clamped(req, timeout_s=None):
            raise _Deadline()

        r = P.router.ReplicaRouter(["r0:1", "r1:1"], [hung_or_clamped, hung_or_clamped], eject_after=1)
        r._EMPTY_WALK_BUDGET_S = 0.2
        r._EMPTY_PROBE_TIMEOUT_S = 5.0
        try:
            t0 = time.monotonic()
            resp = r.should_rate_limit(rls_pb2.RateLimitRequest(domain="basic"))
            assert resp.overall_code == OK and r.live_replica_count() == 2
            assert time.monotonic() - t0 < 2.0
            return wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_retired_pool_degrades_to_inline_fanout():
    def scenario(P):
        r = P.router.ReplicaRouter(["a", "b"], [_fake_service(OK), _fake_service(OK)])
        r._pool.shutdown(wait=False)
        try:
            resp = r.should_rate_limit(_request("basic", _one_per_owner(r, "rp")))
            assert resp.overall_code == OK and len(resp.statuses) == 2
            return wire(resp)
        finally:
            r.close()

    both(scenario)


def test_flight_and_events_record_the_same_transitions():
    """With a flight recorder and a journal, both routers stamp the same
    degraded and forwarded records and the same eject / readmit events
    (time fields dropped)."""
    import ratelimit_tpu.observability as jax_obs
    import ratelimit_tpu_torch.observability as port_obs

    def scenario(P):
        obs = jax_obs if P is JAX else port_obs
        flight = obs.make_flight_recorder(64)
        journal = obs.EventJournal(size=64)
        fakes = [_FlakyTransport(), _FlakyTransport()]
        r = P.router.ReplicaRouter(
            ["a", "b"], fakes, eject_after=1, readmit_after_s=0.05, flight=flight, events=journal
        )
        try:
            descs = _one_per_owner(r, "fl")
            r.begin_forwarding(["a"])
            r.should_rate_limit(_request("basic", descs))
            r.end_forwarding()
            fakes[0].dead = fakes[1].dead = True
            r.should_rate_limit(_request("basic", descs))
            fakes[0].dead = fakes[1].dead = False
            time.sleep(0.06)
            r.should_rate_limit(_request("basic", descs))
            recs = [
                {k: v for k, v in rec.items() if k in ("domain", "code", "hits", "stem_hash", "lane")}
                for rec in flight.snapshot_dicts()
            ]
            # Sub-calls to the two owners run on two threads: the two
            # ejections (and readmissions) land in either order.
            events = sorted(
                ({k: v for k, v in e.items() if k != "seq" and not k.startswith("ts_")}
                 for e in journal.snapshot()),
                key=lambda e: (e["type"], e["replica"]),
            )
            return recs, events, stats(r)
        finally:
            r.close()

    recs, events, _ = both(scenario)
    assert [e["type"] for e in events] == ["replica_eject"] * 2 + ["replica_readmit"] * 2
    codes = {rec["code"] for rec in recs}
    assert {port_obs.FLIGHT_CODE_DEGRADED, port_obs.FLIGHT_CODE_FORWARDED} <= codes


# -- the routing half of the JAX handoff tests --------------------------------


def _req(descs, domain="basic"):
    return _request(domain, descs)


class _SwitchableReplica:
    """Answers OVER for one hot descriptor value and OK otherwise;
    flips to dead (the package's FaultStatusError UNAVAILABLE)."""

    def __init__(self, P, hot_value):
        self.P = P
        self.hot_value = hot_value
        self.dead = False

    def __call__(self, req, timeout_s=None):
        if self.dead:
            raise self.P.faults.FaultStatusError("UNAVAILABLE", "killed")
        resp = rls_pb2.RateLimitResponse()
        over_any = False
        for d in req.descriptors:
            if any(e.value == self.hot_value for e in d.entries):
                s = resp.statuses.add()
                s.code = OVER
                s.current_limit.requests_per_unit = 5
                s.current_limit.unit = MINUTE
                over_any = True
            else:
                resp.statuses.add().code = OK
        resp.overall_code = OVER if over_any else OK
        return resp


@pytest.mark.parametrize(
    "mode,hot_code,cold_code",
    [("allow", OK, OK), ("deny", OVER, OVER), ("local-cache", OVER, OK)],
)
def test_failure_mode_matrix(mode, hot_code, cold_code):
    def scenario(P):
        replica = _SwitchableReplica(P, "hot")
        r = P.router.ReplicaRouter(["a"], [replica], eject_after=1, readmit_after_s=60.0, failure_policy=mode)
        try:
            two = _req([[("key1", "hot")], [("key1", "cold")]])
            healthy = r.should_rate_limit(two)
            assert [s.code for s in healthy.statuses] == [OVER, OK]
            replica.dead = True
            degraded = r.should_rate_limit(two)
            assert [s.code for s in degraded.statuses] == [hot_code, cold_code]
            st = stats(r)
            assert st["fallback_descriptors"] == 2 and st["failure_mode"] == mode
            if mode == "local-cache":
                assert st["degraded_denials"] == 1
            again = r.should_rate_limit(_req([[("key1", "hot")]]))
            assert again.statuses[0].code == hot_code
            return wire(healthy), wire(degraded), st, wire(again), stats(r)
        finally:
            r.close()

    both(scenario)


def test_failure_mode_aliases_and_validation():
    def scenario(P):
        out = []
        for policy in ("open", "closed", "allow", "deny", "local-cache"):
            r = P.router.ReplicaRouter(["a"], [_ok], failure_policy=policy)
            out.append((r.failure_policy, r.over_limit_cache is not None))
            r.close()
        out.append(raised(lambda: P.router.ReplicaRouter(["a"], [_ok], failure_policy="bogus")))
        assert out[:2] == [("allow", False), ("deny", False)]
        return out, P.router.ReplicaRouter.FAILURE_MODES

    both(scenario)


def test_local_cache_entries_expire():
    def scenario(P):
        t = [0.0]
        c = P.router.OverLimitCache(capacity=2, clock=lambda: t[0])
        c.put("a_", 60.0)
        seen = [c.hit("a_")]
        t[0] = 61.0
        seen.append(c.hit("a_"))
        c.put("x_", 10.0)
        c.put("y_", 99.0)
        c.put("z_", 50.0)
        seen += [len(c), c.hit("x_"), c.hit("y_"), c.stat_hits, c.stat_inserts]
        assert seen[:5] == [True, False, 2, False, True]
        return seen

    both(scenario)


class _FlakyOnce:
    def __init__(self, P, n_failures=1):
        self.P = P
        self.n_failures = n_failures
        self.calls = 0

    def __call__(self, req, timeout_s=None):
        self.calls += 1
        if self.calls <= self.n_failures:
            raise self.P.faults.FaultStatusError("UNAVAILABLE", "transient blip")
        return _ok_response(len(req.descriptors))


def test_transient_failure_retried_with_backoff():
    def scenario(P):
        sleeps = []
        flaky = _FlakyOnce(P, 2)
        r = P.router.ReplicaRouter(
            ["a"], [flaky], eject_after=5, retry_max=3, retry_base_s=0.05,
            rng=random.Random(7), sleep=sleeps.append,
        )
        try:
            resp = r.should_rate_limit(_req([[("key1", "v")]]))
            st = stats(r)
            assert resp.statuses[0].code == OK and flaky.calls == 3
            assert st["retries"] == 2 and st["failovers"] == 0 and st["ejections"] == 0
            assert 0.025 <= sleeps[0] < 0.075 and 0.05 <= sleeps[1] < 0.15
            return wire(resp), sleeps, st
        finally:
            r.close()

    both(scenario)


def test_retry_never_sleeps_past_caller_deadline():
    def scenario(P):
        sleeps = []
        always_down = _FlakyOnce(P, 10**6)
        r = P.router.ReplicaRouter(
            ["a"], [always_down], eject_after=0, retry_max=5,
            retry_base_s=10.0, sleep=sleeps.append, failure_policy="allow",
        )
        try:
            resp = r.should_rate_limit(_req([[("key1", "v")]]), timeout_s=0.25)
            assert sleeps == [] and always_down.calls == 1
            assert resp.statuses[0].code == OK and r.stats()["retries"] == 0
            return wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_retry_stops_when_circuit_opens():
    def scenario(P):
        sleeps = []
        always_down = _FlakyOnce(P, 10**6)
        r = P.router.ReplicaRouter(
            ["a"], [always_down], eject_after=1, retry_max=5,
            retry_base_s=0.001, sleep=sleeps.append,
        )
        try:
            resp = r.should_rate_limit(_req([[("key1", "v")]]))
            assert always_down.calls == 1 and sleeps == []
            return wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_forwarding_window_routes_moved_keys_to_old_owner():
    def scenario(P):
        calls = {"a": 0, "b": 0}

        def replica(name):
            def call(req, timeout_s=None):
                calls[name] += len(req.descriptors)
                return _ok_response(len(req.descriptors))

            return call

        r = P.router.ReplicaRouter(["a", "b"], [replica("a"), replica("b")])
        try:
            moved = next(
                d for d in ([("key1", f"v{i}")] for i in range(100))
                if P.hashing.owner_id(P.router.routing_key("basic", _req([d]).descriptors[0]), ["a", "b"]) == "b"
            )
            r.begin_forwarding(["a"])
            assert r.stats()["forwarding_active"]
            r.should_rate_limit(_req([moved]))
            during = dict(calls)
            assert during == {"a": 1, "b": 0} and r.stats()["forwarded"] == 1
            r.end_forwarding()
            r.should_rate_limit(_req([moved]))
            assert calls == {"a": 1, "b": 1}
            return moved, during, dict(calls), stats(r)
        finally:
            r.close()

    both(scenario)


def test_forwarding_skips_departed_or_dead_old_owner():
    def scenario(P):
        calls = {"b": 0}

        def b_replica(req, timeout_s=None):
            calls["b"] += len(req.descriptors)
            return _ok_response(len(req.descriptors))

        r = P.router.ReplicaRouter(["b"], [b_replica])
        try:
            r.begin_forwarding(["a"])
            resp = r.should_rate_limit(_req([[("key1", "v")]]))
            assert resp.statuses[0].code == OK and calls["b"] == 1
            assert r.stats()["forwarded"] == 0
            return wire(resp), stats(r)
        finally:
            r.close()

    both(scenario)


def test_single_replica_cluster_owns_everything():
    def scenario(P):
        owner_calls = []

        def only(req, timeout_s=None):
            owner_calls.append(len(req.descriptors))
            return _ok_response(len(req.descriptors))

        r = P.router.ReplicaRouter(["solo"], [only])
        try:
            resp = r.should_rate_limit(_req([[("a", "1")], [("b", "2")], [("c", "3")]]))
            assert len(resp.statuses) == 3 and owner_calls == [3]
            assert r.stats()["live_replicas"] == 1
            return wire(resp), owner_calls, stats(r)
        finally:
            r.close()

    both(scenario)


def test_duplicate_replica_ids_rejected():
    def scenario(P):
        errs = [
            raised(lambda: P.router.ReplicaRouter(["a", "a"], [_ok, _ok])),
            raised(lambda: P.router.ReplicaRouter([], [])),
            raised(lambda: P.router.ReplicaRouter(["a"], [_ok, _ok])),
        ]
        assert "unique" in errs[0][1]
        return errs

    both(scenario)


def test_fault_injector_modes():
    def scenario(P):
        log = []

        def inner(req, timeout_s=None):
            log.append(timeout_s)
            return "resp"

        inj = P.faults.FaultInjector(sleep=lambda s: None)
        t = inj.wrap("r1", inner)
        out = [t("req")]
        inj.kill("r1")
        out.append(raised(lambda: t("req")))
        inj.heal("r1")
        out.append(t("req"))
        waits = []
        inj2 = P.faults.FaultInjector(sleep=waits.append)
        t2 = inj2.wrap("r1", inner)
        inj2.hang("r1", 3600.0)
        try:
            t2("req", timeout_s=7.0)
        except P.faults.FaultStatusError as e:
            out.append(e.code().name)
        assert waits == [7.0]
        inj2.delay("r1", 0.5)
        out.append(t2("req"))
        inj2.partition("r1", "r2")
        out += [waits, inj2.mode_of("r2"), log]
        assert out[1][0] == "FaultStatusError" and out[3] == "DEADLINE_EXCEEDED"
        return out

    both(scenario)


def test_fault_injection_drives_ejection_and_recovery():
    def scenario(P):
        inj = P.faults.FaultInjector()
        r = P.router.ReplicaRouter(
            ["a", "b"], [inj.wrap("a", _ok), inj.wrap("b", _ok)],
            eject_after=2, readmit_after_s=0.05,
        )
        try:
            inj.kill("a")
            for i in range(12):
                r.should_rate_limit(_req([[("key1", f"v{i}")]]))
            st = stats(r)
            assert st["ejections"] == 1 and st["live_replicas"] == 1
            assert {s["id"]: s["state"] for s in st["replica_states"]}["b"] == "closed"
            inj.heal("a")
            for i in range(200):
                r.should_rate_limit(_req([[("key1", f"w{i}")]]))
                if r.stats()["readmissions"] == 1:
                    break
                time.sleep(0.01)
            after = r.stats()
            assert after["readmissions"] == 1 and after["live_replicas"] == 2
            return st, after["readmissions"], after["live_replicas"]
        finally:
            r.close()

    both(scenario)


# -- the real thing: two runners of each package, one limit each --------------

YAML = """
domain: basic
descriptors:
  - key: key1
    rate_limit:
      unit: minute
      requests_per_unit: 5
"""

COMMON = dict(
    host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
    debug_host="127.0.0.1", debug_port=0, use_statsd=False,
    tpu_num_slots=1 << 12, tpu_batch_window_us=200, tpu_batch_buckets=[8, 32],
    local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Two JAX runners behind the JAX router and two port runners
    (device="cpu") behind the port's, each router over its own package's
    production gRPC transport."""
    made = []
    out = {}
    try:
        for P, make in (
            (JAX, lambda s: JaxRunner(JaxSettings(backend_type="tpu", **s), time_source=JaxPinned(1_000_000))),
            (PORT, lambda s: Runner(Settings(backend_type="cuda", **s),
                                    time_source=PinnedTimeSource(1_000_000), device="cpu")),
        ):
            runners = []
            for i in range(2):
                root = tmp_path_factory.mktemp(f"{P.name}{i}")
                (root / "ratelimit" / "config").mkdir(parents=True)
                (root / "ratelimit" / "config" / "basic.yaml").write_text(YAML)
                r = make(dict(COMMON, runtime_path=str(root), runtime_subdirectory="ratelimit"))
                r.start()
                made.append(r)
                runners.append(r)
            ids = [f"127.0.0.1:{r.grpc_server.bound_port}" for r in runners]
            router = P.router.ReplicaRouter(
                ids, [P.proxy.grpc_transport(grpc.insecure_channel(a)) for a in ids]
            )
            out[P.name] = SimpleNamespace(runners=runners, router=router, ids=ids)
        yield out
    finally:
        for c in out.values():
            c.router.close()
        for r in made:
            r.stop()


def _on(clusters, P):
    return clusters[P.name]


def test_two_runners_jointly_enforce_one_limit(clusters):
    def scenario(P):
        c = _on(clusters, P)
        resps = [c.router.should_rate_limit(_request("basic", [[("key1", "joint")]])) for _ in range(6)]
        assert [r.overall_code for r in resps] == [OK] * 5 + [OVER]
        req = _request("basic", [[("key1", "joint")]])
        owner = c.router.owner_for("basic", req.descriptors[0])
        direct = c.router.transports[1 - owner](req)
        assert direct.overall_code == OK and direct.statuses[0].limit_remaining == 4
        # The owner's index depends on the runners' ports, so it is not
        # an observation shared between the packages.
        return [wire(r) for r in resps], wire(direct)

    both(scenario)


def test_split_request_merges_across_replicas(clusters):
    def scenario(P):
        c = _on(clusters, P)
        descs = _one_per_owner(c.router, "split")
        resp = c.router.should_rate_limit(_request("basic", descs))
        assert resp.overall_code == OK and len(resp.statuses) == 2
        assert all(s.current_limit.requests_per_unit == 5 and s.limit_remaining == 4 for s in resp.statuses)
        return wire(resp)

    both(scenario)


def test_concurrent_load_through_router_counts_exactly(clusters):
    def scenario(P):
        c = _on(clusters, P)
        keys = [f"conc{i}" for i in range(6)]
        ok_counts = {k: 0 for k in keys}
        totals = {k: 0 for k in keys}
        lock = threading.Lock()
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(15):
                    k = keys[rng.randrange(len(keys))]
                    resp = c.router.should_rate_limit(_request("basic", [[("key1", k)]]))
                    with lock:
                        totals[k] += 1
                        ok_counts[k] += resp.overall_code == OK
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors, errors
        for k in keys:
            assert ok_counts[k] == min(totals[k], 5), (k, ok_counts[k], totals[k])
        return ok_counts, totals

    both(scenario)


def test_routers_over_either_cluster_pick_the_same_owners(clusters):
    """The port's router over the JAX runners' addresses and the JAX
    router over the port's would each pick, for 500 keys, the owner
    index its own package's router picks over those addresses."""
    reqs = [_request("basic", [[("key1", f"own{i}")]]) for i in range(500)]
    for c in clusters.values():
        j = jax_router.ReplicaRouter(c.ids, [_ok, _ok])
        p = port_router.ReplicaRouter(c.ids, [_ok, _ok])
        try:
            owners = [j.owner_for("basic", q.descriptors[0]) for q in reqs]
            assert owners == [p.owner_for("basic", q.descriptors[0]) for q in reqs]
            assert owners == [c.router.owner_for("basic", q.descriptors[0]) for q in reqs]
            assert set(owners) == {0, 1}
        finally:
            j.close()
            p.close()
