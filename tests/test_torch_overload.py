"""The overload controller (ratelimit_tpu_torch/overload/controller.py)
and its seams against the JAX package's, on the CPU.

Every scenario of the JAX package's tests/test_overload.py runs through
both packages on the same seeded inputs and FakeMonotonicClocks, with
the JAX test's own checks, and each scenario's observations -- the
controller's summary (the /debug/overload body), shed answers, the
promotion set, counters, statsd lines, flight records, HTTP statuses
and bodies -- must be equal between the packages.  Wall-clock fields
are masked by name (WALL_KEYS); on fake clocks none differ.  The
port's own contracts ride along: the controller touches no tensor, and
a promoted or a shed request dispatches no torch operator.
"""

import json
import socket
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
from torch.utils._python_dispatch import TorchDispatchMode

import ratelimit_tpu.observability as jax_obs
import ratelimit_tpu.overload as jax_overload
import ratelimit_tpu_torch.observability as port_obs
import ratelimit_tpu_torch.overload as port_overload
from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.server import http_server as jax_http
from ratelimit_tpu.service import RateLimitService as JaxService
from ratelimit_tpu.stats import manager as jax_manager
from ratelimit_tpu.stats import statsd as jax_statsd
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.server import http_server
from ratelimit_tpu_torch.service import RateLimitService
from ratelimit_tpu_torch.stats import manager
from ratelimit_tpu_torch.stats import statsd
from ratelimit_tpu_torch.utils import time as port_time

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    loader=jax_loader,
    obs=jax_obs,
    ov=jax_overload,
    mgr=jax_manager,
    time=jax_time,
    http=jax_http,
    statsd=jax_statsd,
    Service=JaxService,
    cache=lambda clock: TpuRateLimitCache(JaxEngine(num_slots=1 << 10), clock),
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    loader=loader,
    obs=port_obs,
    ov=port_overload,
    mgr=manager,
    time=port_time,
    http=http_server,
    statsd=statsd,
    Service=RateLimitService,
    cache=lambda clock: CudaRateLimitCache(CounterEngine(num_slots=1 << 10, device="cpu"), clock),
)

SLOW_MS = 500.0  # over the default 50ms latency SLO threshold
FAST_MS = 1.0
#: Fields measured on a wall clock, masked wherever they occur.
WALL_KEYS = {"at", "hold_remaining_s", "expires_in_s"}


def masked(x):
    if isinstance(x, dict):
        return {k: ("<t>" if k in WALL_KEYS else masked(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [masked(v) for v in x]
    return x


def both(scenario, *args):
    """Run `scenario(P, *args)` through each package; the observations
    must be equal.  Returns the port's."""
    want = masked(scenario(JAX, *args))
    got = masked(scenario(PORT, *args))
    assert got == want
    return got


def make_controller(P, **kw):
    clock = kw.pop("clock", P.time.FakeMonotonicClock(100.0))
    mgr = kw.pop("manager", P.mgr.Manager())
    slo = P.obs.SloEngine(mgr, clock=clock)
    kw.setdefault("shed_enabled", True)
    kw.setdefault("shed_burn_threshold", 8.0)
    kw.setdefault("shed_min_requests", 10)
    kw.setdefault("shed_ewma_alpha", 1.0)  # undamped: deterministic math
    ctrl = P.ov.OverloadController(slo=slo, clock=clock, **kw)
    return ctrl, slo, clock, mgr


def drive(slo, domain, n, ms):
    for _ in range(n):
        slo.observe(domain, over_limit=False, latency_ms=ms)


def admit(ctrl, domain):
    """admit() as data: (reason, whether a gate came back)."""
    reason, gate = ctrl.admit(domain)
    return reason, gate is not None


# -- priority config key ------------------------------------------------------


def test_priority_key_parses_and_defaults():
    def scenario(P):
        cfg = P.loader.load_config(
            [
                P.loader.ConfigFile(
                    "a",
                    "domain: paying\npriority: 3\ndescriptors:\n"
                    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 10}\n",
                ),
                P.loader.ConfigFile(
                    "b",
                    "domain: plain\ndescriptors:\n"
                    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 10}\n",
                ),
                P.loader.ConfigFile(
                    "c",
                    "domain: sheddable\npriority: 0\ndescriptors:\n"
                    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 10}\n",
                ),
            ],
            P.mgr.Manager(),
        )
        assert cfg.priorities == {
            "paying": 3,
            "plain": P.ov.DEFAULT_DOMAIN_PRIORITY,
            "sheddable": 0,
        }
        return cfg.priorities

    both(scenario)


@pytest.mark.parametrize("priority", ["high", -1, True, 1.5])
def test_priority_key_rejects_non_uint(priority):
    yaml = (
        f"domain: d\npriority: {json.dumps(priority)}\ndescriptors:\n"
        "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 10}\n"
    )

    def scenario(P):
        with pytest.raises(P.loader.ConfigError, match="priority|error checking config") as e:
            P.loader.load_config([P.loader.ConfigFile("a", yaml)], P.mgr.Manager())
        return str(e.value)

    both(scenario)


def test_priority_key_rejected_on_descriptors():
    yaml = (
        "domain: d\ndescriptors:\n"
        "  - key: k\n    priority: 2\n"
        "    rate_limit: {unit: hour, requests_per_unit: 10}\n"
    )

    def scenario(P):
        with pytest.raises(P.loader.ConfigError, match="domain-level") as e:
            P.loader.load_config([P.loader.ConfigFile("a", yaml)], P.mgr.Manager())
        return str(e.value)

    both(scenario)


# -- shed lifecycle -----------------------------------------------------------


def test_burn_crossing_sheds_lowest_priority_first_and_recovers():
    def scenario(P):
        ctrl, slo, clock, _ = make_controller(P)
        slo.set_domains(["paying", "guest"])
        ctrl.set_priorities({"paying": 2, "guest": 0})
        log = []
        ctrl.tick()
        assert not ctrl.shedding
        assert ctrl.admit("guest") == (None, None)
        drive(slo, "paying", 50, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        assert ctrl.shedding and ctrl.shed_floor_priority == 2
        log.append(ctrl.summary())
        assert ctrl.admit("guest")[0] == P.ov.REASON_SLO_BURN
        assert ctrl.admit("stranger")[0] == P.ov.REASON_SLO_BURN
        assert ctrl.admit("paying") == (None, None)
        for _ in range(2):
            drive(slo, "paying", 50, FAST_MS)
            clock.advance(1.0)
            ctrl.tick()
            log.append(ctrl.summary())
        assert not ctrl.shedding
        assert ctrl.admit("guest") == (None, None)
        assert ctrl.shed_transitions == 2
        return log

    both(scenario)


def test_unshed_hysteresis_holds_floor_in_the_band():
    def scenario(P):
        ctrl, slo, clock, _ = make_controller(P)
        slo.set_domains(["paying"])
        ctrl.set_priorities({"paying": 2})
        ctrl.tick()
        states = []

        def tick_with_slow_fraction(frac, n=1000):
            drive(slo, "paying", int(n * frac), SLOW_MS)
            drive(slo, "paying", n - int(n * frac), FAST_MS)
            clock.advance(1.0)
            ctrl.tick()
            states.append((ctrl.shedding, ctrl.summary()["shed"]["burns"]))

        tick_with_slow_fraction(0.006)  # burn 6: inside the band
        tick_with_slow_fraction(0.02)  # burn 20: trips
        tick_with_slow_fraction(0.006)  # in the band: holds
        tick_with_slow_fraction(0.001)  # burn 1 < clear 4: releases
        assert [s for s, _ in states] == [False, True, True, False]
        return states

    both(scenario)


def test_shed_floor_never_reaches_top_priority():
    def scenario(P):
        ctrl, slo, clock, _ = make_controller(P)
        slo.set_domains(["gold", "silver", "bronze"])
        ctrl.set_priorities({"gold": 3, "silver": 2, "bronze": 1})
        ctrl.tick()
        for _ in range(10):
            drive(slo, "gold", 50, SLOW_MS)
            clock.advance(1.0)
            ctrl.tick()
        assert ctrl.shed_floor_priority == 3
        assert ctrl.admit("gold") == (None, None)
        assert ctrl.admit("silver")[0] == P.ov.REASON_SLO_BURN
        assert ctrl.admit("bronze")[0] == P.ov.REASON_SLO_BURN
        return ctrl.summary()

    both(scenario)


def test_shed_domains_recovering_do_not_vote_to_unshed():
    def scenario(P):
        ctrl, slo, clock, _ = make_controller(P)
        slo.set_domains(["paying", "guest"])
        ctrl.set_priorities({"paying": 2, "guest": 0})
        ctrl.tick()
        drive(slo, "paying", 50, SLOW_MS)
        drive(slo, "guest", 50, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        assert ctrl.shedding
        drive(slo, "paying", 50, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        assert ctrl.shedding
        return ctrl.summary()

    both(scenario)


def test_thin_traffic_never_sheds():
    def scenario(P):
        ctrl, slo, clock, _ = make_controller(P, shed_min_requests=20)
        slo.set_domains(["paying"])
        ctrl.set_priorities({"paying": 2})
        ctrl.tick()
        drive(slo, "paying", 5, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        assert not ctrl.shedding
        return ctrl.summary()

    both(scenario)


def test_per_domain_reason_counters_and_folding():
    def scenario(P):
        ctrl, slo, clock, mgr = make_controller(P)
        ctrl.register_stats(mgr.store)
        slo.set_domains(["paying", "guest"])
        ctrl.set_priorities({"paying": 2, "guest": 0})
        ctrl.tick()
        drive(slo, "paying", 50, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        ctrl.admit("guest")
        ctrl.admit("guest")
        ctrl.admit("total-stranger")
        counters = mgr.store.counters()
        assert counters["ratelimit.overload.shed.guest.slo_burn"] == 2
        assert counters["ratelimit.overload.shed._other.slo_burn"] == 1
        assert counters["ratelimit.overload.shed_total"] == 3
        assert "ratelimit.overload.shed.total-stranger.slo_burn" not in counters
        assert mgr.store.gauges()["ratelimit.overload.shedding"] == 1
        return {
            k: v
            for k, v in {**counters, **mgr.store.gauges()}.items()
            if k.startswith("ratelimit.overload.")
        }

    both(scenario)


# -- promotion ----------------------------------------------------------------


def test_promotion_ttl_expiry_and_capacity():
    def scenario(P):
        clock = P.time.FakeMonotonicClock(0.0)
        promo = P.ov.PromotionCache(ttl_s=2.0, capacity=2, clock=clock)
        log = []
        promo.promote("a")
        assert promo.contains("a") and promo.hits == 1
        clock.advance(3.0)
        assert not promo.contains("a") and promo.expirations == 1
        promo.promote("b")
        clock.advance(1.0)
        promo.promote("c")
        promo.promote("d")
        log.append(promo.live())
        assert promo.evictions == 1
        assert not promo.contains("b")
        assert promo.contains("c") and promo.contains("d")
        assert len(promo) == 2
        log.append((promo.promotions, promo.hits, promo.expirations, promo.evictions))
        return log

    both(scenario)


def test_promotion_tick_uses_per_tick_deltas():
    def scenario(P):
        clock = P.time.FakeMonotonicClock(0.0)
        sketch = P.obs.HotKeySketch(8)
        ctrl = P.ov.OverloadController(
            hotkeys=sketch,
            clock=clock,
            promote_enabled=True,
            promote_ttl_s=5.0,
            promote_over_share=0.5,
            promote_min_hits=10,
        )
        bad = sketch.track("stem_bad")
        was_bad = sketch.track("stem_was_bad")
        was_bad.hits, was_bad.over_limit = 1000, 900
        ctrl.tick()
        assert ctrl.promotion.contains("stem_was_bad")
        first = ctrl.summary()["promotion"]
        clock.advance(10.0)
        ctrl.promotion.sweep()
        bad.hits += 100
        bad.over_limit += 80
        was_bad.hits += 100
        ctrl.tick()
        assert ctrl.promotion.contains("stem_bad")
        assert not ctrl.promotion.contains("stem_was_bad")
        return first, ctrl.summary()["promotion"]

    both(scenario)


CONFIG_D = (
    "domain: d\ndescriptors:\n"
    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 10}\n"
)


def _status(s):
    return (int(s.code), s.limit_remaining, s.duration_until_reset)


def test_promotion_short_circuits_device_in_do_limit_resolved():
    def scenario(P):
        mono = P.time.FakeMonotonicClock(0.0)
        cache = P.cache(P.time.PinnedTimeSource(1234))
        cfg = P.loader.load_config([P.loader.ConfigFile("a", CONFIG_D)], P.mgr.Manager())
        req = P.api.RateLimitRequest("d", [P.api.Descriptor.of(("k", "v"))], 1)
        out = []
        try:
            statuses, limits, _ = cache.do_limit_resolved(req, cfg)
            assert statuses[0].code is P.api.Code.OK
            out.append(_status(statuses[0]))
            rule = limits[0]
            over_before = rule.stats.over_limit.value()
            promo = P.ov.PromotionCache(ttl_s=5.0, capacity=8, clock=mono)
            cache.promotion = promo
            rd = cache.resolver._entries[("d", req.descriptors[0].entries)]
            promo.promote(rd.stem)
            statuses, _, _ = cache.do_limit_resolved(req, cfg)
            assert statuses[0].code is P.api.Code.OVER_LIMIT
            assert statuses[0].limit_remaining == 0
            assert promo.hits == 1
            assert rule.stats.over_limit.value() == over_before + 1
            assert rule.stats.over_limit_with_local_cache.value() == 1
            out.append(_status(statuses[0]))
            mono.advance(10.0)
            statuses, _, _ = cache.do_limit_resolved(req, cfg)
            assert statuses[0].code is P.api.Code.OK
            out.append(_status(statuses[0]))
            out.append((rd.stem, promo.hits, promo.expirations))
        finally:
            cache.close()
        return out

    both(scenario)


# -- backpressure -------------------------------------------------------------


def test_backpressure_ratchet_and_release():
    def scenario(P):
        clock = P.time.FakeMonotonicClock(0.0)
        ctrl = P.ov.OverloadController(
            clock=clock,
            backpressure_enabled=True,
            backpressure_tokens=4,
            backpressure_max_wait_s=0.0,
            backpressure_hold_s=10.0,
        )
        ctrl.set_priorities({"d": 2})
        log = [admit(ctrl, "d")]
        ctrl.on_detector_trip("error_rate", "not a backpressure trigger")
        log.append(admit(ctrl, "d"))
        ctrl.on_detector_trip("queue_saturation", "queue hwm 900 >= 512")
        assert ctrl.bp_trips == 1
        reason, gate = ctrl.admit("d")
        assert reason is None and gate is not None
        ctrl.on_detector_trip("latency_spike", "p99 40x baseline")
        s = ctrl.summary()["backpressure"]
        assert s["active"] and s["level"] == 2 and s["tokens"] == 2
        log.append(s)
        g2 = ctrl.admit("d")[1]
        g3 = ctrl.admit("d")[1]
        assert g2 is not None and g3 is not None
        reason, g4 = ctrl.admit("d")
        assert reason == P.ov.REASON_BACKPRESSURE and g4 is None
        g2.release()
        log.append(admit(ctrl, "d"))
        gate.release()
        clock.advance(11.0)
        ctrl.tick()
        assert ctrl.admit("d") == (None, None)
        log.append(ctrl.summary())
        assert ctrl.summary()["backpressure"]["active"] is False
        return log

    both(scenario)


def test_detector_trips_reach_the_controller_through_the_sampler():
    def scenario(P):
        class Trip:
            name = "queue_saturation"

            def __init__(self):
                self.reasons = ["depth 900"] * 3

            def evaluate(self):
                return self.reasons.pop(0) if self.reasons else None

        clock = P.time.FakeMonotonicClock(0.0)
        ctrl = P.ov.OverloadController(
            clock=clock,
            backpressure_enabled=True,
            backpressure_tokens=8,
            backpressure_max_wait_s=0.0,
            backpressure_hold_s=60.0,
        )
        dets = P.obs.AnomalyDetectors(
            P.mgr.StatsStore(), [Trip()], clock=clock, cooldown_s=60.0, overload=ctrl
        )
        assert len(dets.tick()) == 1
        assert ctrl.bp_trips == 1 and ctrl.ticks == 1
        clock.advance(1.0)
        dets.tick()
        assert ctrl.bp_trips == 2
        assert ctrl.summary()["backpressure"]["level"] == 2
        return ctrl.summary()

    both(scenario)


# -- service integration ------------------------------------------------------


class _Runtime:
    def __init__(self, files):
        self._files = files

    def snapshot(self):
        files = self._files

        class Snap:
            def keys(self):
                return sorted(files)

            def get(self, key):
                return files.get(key, "")

        return Snap()

    def add_update_callback(self, fn):
        pass


SERVICE_YAML = (
    "domain: paying\npriority: 2\ndescriptors:\n"
    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 1000}\n"
)
GUEST_YAML = (
    "domain: guest\npriority: 0\ndescriptors:\n"
    "  - key: k\n    rate_limit: {unit: hour, requests_per_unit: 1000}\n"
)


def build_service(P, clock, with_overload=False, mono=None, **ctrl_kw):
    cache = P.cache(clock)
    mgr = P.mgr.Manager()
    svc = P.Service(
        _Runtime({"config.a": SERVICE_YAML, "config.b": GUEST_YAML}), cache, mgr, clock=clock
    )
    ctrl = None
    if with_overload:
        mono = mono or P.time.FakeMonotonicClock(0.0)
        slo = P.obs.SloEngine(mgr, clock=mono)
        ctrl_kw.setdefault("shed_enabled", True)
        ctrl = P.ov.OverloadController(slo=slo, clock=mono, **ctrl_kw)
        svc.overload = ctrl
        ctrl.set_priorities(svc.get_current_config().priorities)
    return svc, cache, ctrl, mgr


def _response(resp):
    return (
        int(resp.overall_code),
        resp.shed_reason,
        [_status(s) for s in resp.statuses],
        [(h.key, h.value) for h in resp.response_headers_to_add],
    )


def test_service_shed_response_shape_and_priorities_adopted():
    def scenario(P):
        svc, cache, ctrl, _ = build_service(P, P.time.PinnedTimeSource(1_700_000_000), True)
        try:
            assert ctrl._priorities == {"paying": 2, "guest": 0}
            ctrl._floor = 1
            ctrl._recompute_shed_locked()
            req = P.api.RateLimitRequest(
                "guest", [P.api.Descriptor.of(("k", "a")), P.api.Descriptor.of(("k", "b"))], 1
            )
            resp = svc.should_rate_limit(req)
            assert resp.overall_code is P.api.Code.OVER_LIMIT
            assert resp.shed_reason == P.ov.REASON_SLO_BURN
            assert len(resp.statuses) == 2
            assert all(s.code is P.api.Code.OVER_LIMIT for s in resp.statuses)
            ok = svc.should_rate_limit(
                P.api.RateLimitRequest("paying", [P.api.Descriptor.of(("k", "a"))], 1)
            )
            assert ok.overall_code is P.api.Code.OK and ok.shed_reason is None
            return _response(resp), _response(ok), ctrl.summary()
        finally:
            cache.close()

    both(scenario)


def test_shed_is_not_softened_by_shadow_mode_and_carries_no_headers():
    """The service's shed contract beyond the JAX test's: global shadow
    mode does not turn a shed into OK, no RateLimit-* header rides on
    it, and the reload path feeds set_priorities."""

    def scenario(P):
        svc, cache, ctrl, _ = build_service(P, P.time.PinnedTimeSource(1_700_000_000), True)
        try:
            svc.global_shadow_mode = True
            svc.headers_enabled = True
            ctrl._floor = 1
            ctrl._recompute_shed_locked()
            shed = svc.should_rate_limit(
                P.api.RateLimitRequest("guest", [P.api.Descriptor.of(("k", "a"))], 1)
            )
            assert shed.overall_code is P.api.Code.OVER_LIMIT
            assert shed.response_headers_to_add == []
            ctrl._priorities = {}
            svc.reload_config()
            assert ctrl._priorities == {"paying": 2, "guest": 0}
            return _response(shed), ctrl.summary()
        finally:
            cache.close()

    both(scenario)


def test_backpressure_gate_released_into_the_gate_admit_returned():
    """A request admitted through the gate gives its permit back into
    that gate object after the backend leg, even when a ratchet
    rebuilt the gate in between; a backend error releases it too."""

    def scenario(P):
        mono = P.time.FakeMonotonicClock(0.0)
        svc, cache, ctrl, _ = build_service(
            P, P.time.PinnedTimeSource(1_700_000_000), True, mono=mono,
            shed_enabled=False, backpressure_enabled=True, backpressure_tokens=2,
            backpressure_max_wait_s=0.0,
        )
        try:
            ctrl.on_detector_trip("queue_saturation", "hwm")
            gate = ctrl._bp_gate
            seen = []
            decide = svc._decide

            def ratchet_then_decide(request):
                # A trip lands while the request holds its permit.
                ctrl.on_detector_trip("latency_spike", "p99")
                seen.append(ctrl._bp_gate is gate)
                return decide(request)

            svc._decide = ratchet_then_decide
            resp = svc.should_rate_limit(
                P.api.RateLimitRequest("paying", [P.api.Descriptor.of(("k", "a"))], 1)
            )
            svc._decide = decide
            # The old gate got its permit back: both of its 2 are free.
            assert gate.acquire(blocking=False) and gate.acquire(blocking=False)
            return _response(resp), seen, ctrl.summary()["backpressure"]
        finally:
            cache.close()

    assert both(scenario)[1] == [False]


def test_decisions_byte_identical_with_idle_controller_attached():
    reqs = [
        (dom, f"v{i % 7}", 1 + i % 3)
        for i, dom in enumerate(["paying", "guest", "stranger"] * 40)
    ]

    def scenario(P):
        svc_a, cache_a, _, _ = build_service(P, P.time.PinnedTimeSource(1_700_000_000))
        svc_b, cache_b, ctrl, _ = build_service(
            P, P.time.PinnedTimeSource(1_700_000_000), True,
            promote_enabled=True, backpressure_enabled=True, backpressure_max_wait_s=0.0,
        )
        cache_b.promotion = ctrl.promotion
        out = []
        try:
            for dom, value, hits in reqs:
                req = P.api.RateLimitRequest(dom, [P.api.Descriptor.of(("k", value))], hits)
                ra = _response(svc_a.should_rate_limit(req))
                rb = _response(svc_b.should_rate_limit(req))
                assert ra == rb and rb[1] is None
                out.append(rb)
        finally:
            cache_a.close()
            cache_b.close()
        return out

    both(scenario)


def _post_json(port, domain):
    body = json.dumps(
        {"domain": domain, "descriptors": [{"entries": [{"key": "k", "value": "x"}]}]}
    ).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/json", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_shed_code_stamped_into_flight_ring_via_json_transport():
    def scenario(P):
        svc, cache, ctrl, _ = build_service(P, P.time.PinnedTimeSource(1_700_000_000), True)
        flight = P.obs.make_flight_recorder(64)
        ctrl._floor = 1
        ctrl._recompute_shed_locked()
        server = P.http.HttpServer("127.0.0.1", 0, name="overload-test")
        P.http.add_json_handler(server, svc, flight=flight, slo=None)
        server.start()
        try:
            shed = _post_json(server.bound_port, "guest")
            assert shed[0] == 429
            recs = flight.snapshot_dicts()
            assert recs[0]["code"] == P.obs.FLIGHT_CODE_SHED == 8
            assert recs[0]["shed"] is True and recs[0]["domain"] == "guest"
            ok = _post_json(server.bound_port, "paying")
            recs = flight.snapshot_dicts()
            assert recs[0]["code"] == int(P.api.Code.OK) and "shed" not in recs[0]
            rows = [
                {k: v for k, v in r.items() if k not in ("seq", "ts_ns", "latency_le_ms")}
                for r in recs
            ]
            return shed, ok, rows
        finally:
            server.stop()
            cache.close()

    both(scenario)


# -- statsd parity ------------------------------------------------------------


def test_statsd_flushes_overload_counters_as_deltas():
    def scenario(P):
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(5)
        port = recv.getsockname()[1]
        ctrl, slo, clock, mgr = make_controller(P, promote_enabled=True)
        ctrl.register_stats(mgr.store)
        slo.set_domains(["paying", "guest"])
        ctrl.set_priorities({"paying": 2, "guest": 0})
        ctrl.tick()
        drive(slo, "paying", 50, SLOW_MS)
        clock.advance(1.0)
        ctrl.tick()
        ctrl.admit("guest")
        ctrl.admit("guest")
        ctrl.promotion.promote("stem_x")
        exporter = P.statsd.StatsdExporter(mgr.store, "127.0.0.1", port, interval_s=60)
        try:
            exporter.flush()
            lines = set(recv.recv(65536).decode().split("\n"))
            assert "ratelimit.overload.shed.guest.slo_burn:2|c" in lines
            assert "ratelimit.overload.shed_total:2|c" in lines
            assert "ratelimit.overload.promotion.promoted:1|c" in lines
            ctrl.admit("guest")
            exporter.flush()
            second = set(recv.recv(65536).decode().split("\n"))
            assert "ratelimit.overload.shed.guest.slo_burn:1|c" in second
            assert not any("promotion.promoted" in line for line in second)
        finally:
            exporter.stop()
            recv.close()
        overload = lambda ls: sorted(x for x in ls if x.startswith("ratelimit.overload."))  # noqa: E731
        return overload(lines), overload(second)

    both(scenario)


# -- debug endpoints ----------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_debug_overload_endpoint_and_404_when_unwired():
    def scenario(P):
        ctrl, slo, clock, mgr = make_controller(
            P, promote_enabled=True, backpressure_enabled=True, backpressure_max_wait_s=0.0
        )
        ctrl.set_priorities({"paying": 2})
        ctrl.promotion.promote("stem_x")
        out = []
        for kw in ({"overload": ctrl}, {}):
            server = P.http.HttpServer("127.0.0.1", 0, name="ov-debug")
            P.http.add_debug_routes(server, mgr.store, **kw)
            server.start()
            try:
                status, body = _get(server.bound_port, "/debug/overload")
            finally:
                server.stop()
            if kw:
                body = json.loads(body)
                assert status == 200
                assert body["enabled"] == {"shed": True, "promotion": True, "backpressure": True}
                assert body["shed"]["priorities"] == {"paying": 2}
                assert [e["key"] for e in body["promotion"]["live"]] == ["stem_x"]
                assert body["backpressure"]["active"] is False
            else:
                assert status == 404
            out.append((status, body))
        return out

    both(scenario)


def test_debug_flight_endpoint_gated_and_jsonl():
    def scenario(P):
        flight = P.obs.make_flight_recorder(32)
        flight.note(0xABCD, 1)
        flight.record("d1", 1, 1, 0.5)
        flight.record("d2", 2, 3, 7.0)
        out = []
        for kw, path in (
            (dict(flight=flight), "/debug/flight"),
            (dict(profiling_enabled=True, flight=flight), "/debug/flight?format=jsonl"),
            (dict(profiling_enabled=True, flight=flight), "/debug/flight?format=json"),
            (dict(profiling_enabled=True), "/debug/flight"),
        ):
            server = P.http.HttpServer("127.0.0.1", 0, name="fl")
            P.http.add_debug_routes(server, P.mgr.StatsStore(), **kw)
            server.start()
            try:
                status, body = _get(server.bound_port, path)
            finally:
                server.stop()
            if status == 200 and "jsonl" in path:
                recs = [json.loads(ln) for ln in body.decode().splitlines() if ln]
                assert [r["domain"] for r in recs] == ["d1", "d2"]
                assert recs[0]["stem_hash"] == f"{0xABCD:08x}" and recs[1]["hits"] == 3
                body = [{k: v for k, v in r.items() if k not in ("seq", "ts_ns")} for r in recs]
            elif status == 200:
                doc = json.loads(body)
                assert doc["capacity"] == 32 and len(doc["records"]) == 2
                body = len(doc["records"])
            out.append((status, body))
        assert [s for s, _ in out] == [403, 200, 200, 404]
        return out

    both(scenario)


# -- the port's own contracts -------------------------------------------------


class _NoTorchOps(TorchDispatchMode):
    """Fails on any torch operator dispatched while it is active."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"a promoted or shed request ran torch op {func}")


def test_promoted_and_shed_requests_run_no_torch_op():
    """A promoted descriptor is answered from the host's promotion set
    and a shed request before any backend work: neither dispatches a
    torch operator, so neither reaches a kernel or its plain version.
    The controller's tick, summary and admit touch no tensor either."""
    mono = port_time.FakeMonotonicClock(0.0)
    svc, cache, ctrl, _ = build_service(
        PORT, port_time.PinnedTimeSource(1_700_000_000), True, mono=mono,
        promote_enabled=True, promote_min_hits=1,
    )
    cache.promotion = ctrl.promotion
    try:
        req = api.RateLimitRequest("paying", [api.Descriptor.of(("k", "hot"))], 1)
        assert svc.should_rate_limit(req).overall_code is api.Code.OK  # warms the resolver
        rd = cache.resolver._entries[("paying", req.descriptors[0].entries)]
        ctrl.promotion.promote(rd.stem)
        with _NoTorchOps():
            promoted = svc.should_rate_limit(req)
            ctrl._floor = 1
            ctrl._recompute_shed_locked()
            shed = svc.should_rate_limit(
                api.RateLimitRequest("guest", [api.Descriptor.of(("k", "x"))], 1)
            )
            ctrl.tick()
            ctrl.summary()
        assert promoted.overall_code is api.Code.OVER_LIMIT and promoted.shed_reason is None
        assert shed.shed_reason == port_overload.REASON_SLO_BURN
    finally:
        cache.close()


def test_controller_public_names_match_the_jax_module():
    import ratelimit_tpu.overload.controller as jc
    import ratelimit_tpu_torch.overload.controller as pc

    assert sorted(port_overload.__all__) == sorted(jax_overload.__all__)
    for name in ("OverloadController", "PromotionCache"):
        assert getattr(port_overload, name).__module__ == pc.__name__
    for name in jax_overload.__all__:
        if name not in ("OverloadController", "PromotionCache"):
            assert getattr(pc, name) == getattr(jc, name), name
