"""The SLO engine and the anomaly detectors of the port
(ratelimit_tpu_torch/observability/{slo,detectors}.py) against the JAX
package's, on synthetic time.

Every scenario of the JAX package's tests/test_detectors_slo.py runs
through both packages on a FakeMonotonicClock with the same seeded
inputs (numpy): detector verdicts and reasons, incident JSON in memory
and on disk, the SLO summary and its metric families must be equal.
One field cannot match and is masked by name: an incident's
``captured_unix`` (the wall clock at capture, and the file name built
from it).  The /debug/slo and /debug/incidents views answer with the
same bytes.  A detector tick and an incident capture dispatch no torch
op: nothing on the sampler thread may wait on a bank's stream.
"""

import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

import ratelimit_tpu.observability as jax_obs
import ratelimit_tpu.observability.detectors as jax_detectors
import ratelimit_tpu.observability.prometheus as jax_prom
import ratelimit_tpu.server.http_server as jax_http
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
import ratelimit_tpu_torch.observability as obs
import ratelimit_tpu_torch.observability.detectors as detectors
import ratelimit_tpu_torch.observability.prometheus as prom
import ratelimit_tpu_torch.server.http_server as http_server
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time

JAX = SimpleNamespace(
    obs=jax_obs, det=jax_detectors, stats=jax_stats, time=jax_time, prom=jax_prom, http=jax_http
)
PORT = SimpleNamespace(
    obs=obs, det=detectors, stats=stats, time=port_time, prom=prom, http=http_server
)

#: Incident fields that are wall-clock stamps: masked by name.
WALL_FIELDS = ("captured_unix",)


def _mask(incident):
    return {k: v for k, v in incident.items() if k not in WALL_FIELDS}


def make_slo(P, **kw):
    mgr = P.stats.Manager()
    clock = kw.pop("clock", P.time.FakeMonotonicClock(1000.0))
    return P.obs.SloEngine(mgr, clock=clock, **kw), mgr, clock


class TripOnce:
    name = "synthetic"

    def __init__(self, reasons=()):
        self.reasons = list(reasons)

    def evaluate(self):
        return self.reasons.pop(0) if self.reasons else None


# ---------------------------------------------------------------------------
# scenarios: each runs on one package and returns its outcome
# ---------------------------------------------------------------------------


def ewma_and_quantiles(P):
    e = P.obs.Ewma(alpha=0.5)
    rng = np.random.default_rng(1)
    values = [e.value] + [e.update(float(x)) for x in rng.uniform(0, 100, 20)]
    bounds = (1.0, 2.0, 4.0)
    q = [
        P.det.quantile_from_counts(bounds, [0, 10, 0, 0], 0.5),
        P.det.quantile_from_counts(bounds, [0, 0, 0, 0], 0.99),
        P.det.quantile_from_counts(bounds, [0, 0, 0, 5], 0.99),
    ]
    hb = P.stats.Histogram.DEFAULT_BOUNDS
    for _ in range(10):
        counts = rng.integers(0, 50, len(hb) + 1).tolist()
        q.append(P.det.quantile_from_counts(hb, counts, float(rng.uniform(0.5, 1.0))))
    return values, q


def latency_spike_needs_baseline_then_trips(P):
    hist = P.stats.StatsStore().histogram("rt_ms")
    det = P.obs.LatencySpikeDetector(hist, factor=4.0, min_samples=10)

    def tick_with(ms, n=50):
        for _ in range(n):
            hist.observe(ms)
        return det.evaluate()

    out = [det.evaluate(), tick_with(2.0), tick_with(2.0), tick_with(400.0)]
    assert out[:3] == [None] * 3 and "p99 latency" in out[3]
    return out, det.baseline.value


def latency_spike_ignores_thin_traffic(P):
    hist = P.stats.StatsStore().histogram("rt_ms")
    det = P.obs.LatencySpikeDetector(hist, factor=4.0, min_samples=10)
    out = [det.evaluate()]
    for _ in range(3):
        hist.observe(1.0)
    out.append(det.evaluate())
    for _ in range(3):
        hist.observe(500.0)
    out.append(det.evaluate())
    assert out == [None] * 3
    return out


def latency_spike_on_seeded_latencies(P):
    """A seeded log-normal latency stream with a 0.25 s stall in one
    tick: the verdict of every tick, and the baseline after each."""
    hist = P.stats.StatsStore().histogram("rt_ms")
    det = P.obs.LatencySpikeDetector(hist, factor=4.0, min_samples=20)
    rng = np.random.default_rng(7)
    out = []
    for tick in range(12):
        ms = rng.lognormal(np.log(2.0), 0.3, 60)
        if tick == 8:
            ms[:5] = 250.0  # five RPCs held by a stalled bank
        for x in ms:
            hist.observe(float(x))
        out.append((det.evaluate(), det.baseline.value))
    assert out[8][0] is not None
    return out


def over_limit_surge_per_domain(P):
    engine, _mgr, _clock = make_slo(P)
    engine.set_domains(["api", "web"])
    det = P.obs.OverLimitSurgeDetector(engine, factor=4.0, min_requests=10)

    def traffic(domain, total, over):
        for i in range(total):
            engine.observe(domain, over_limit=i < over, latency_ms=1.0)

    out = []
    traffic("api", 100, 2)
    out.append(det.evaluate())
    traffic("api", 100, 2)
    out.append(det.evaluate())
    traffic("api", 100, 90)
    out.append(det.evaluate())
    assert "'api'" in out[2] and "web" not in out[2]
    return out


def queue_saturation_threshold(P):
    depths = [0, 100, 900, 511, 512]
    det = P.obs.QueueSaturationDetector(lambda: depths.pop(0), threshold=512)
    return [det.evaluate() for _ in range(5)]


def error_rate(P):
    store = P.stats.StatsStore()
    det = P.obs.ErrorRateDetector(store, threshold=0.05, min_errors=5)
    requests = store.counter("ratelimit_server.ShouldRateLimit.total_requests")
    errors = store.counter("ratelimit.service.call.should_rate_limit.redis_error")
    service_errors = store.counter("ratelimit.service.call.should_rate_limit.service_error")
    out = []
    requests.add(100)
    out.append(det.evaluate())
    requests.add(100)
    errors.add(50)
    out.append(det.evaluate())
    errors.add(2)
    out.append(det.evaluate())
    requests.add(10)
    service_errors.add(30)
    out.append(det.evaluate())
    return out


def tick_captures_incident_with_evidence(P, tmp_path):
    clock = P.time.FakeMonotonicClock(50.0)
    engine, mgr, _ = make_slo(P, clock=clock)
    engine.set_domains(["api"])
    engine.observe("api", over_limit=True, latency_ms=3.0)
    flight = P.obs.make_flight_recorder(32, clock=clock)
    flight.note(0xBEEF, 0)
    flight.record("api", 2, 1, 3.0)
    events = P.obs.make_event_journal(16, clock=clock, wall=lambda: 1.7e9)
    events.emit("config_reload", generation=1, domains=1)
    ts = P.obs.make_timeseries(1.0, 10.0, clock=clock, wall=lambda: 1.7e9)
    ts.add_gauge("g", lambda: 3.0)
    ts.tick()
    dets = P.obs.AnomalyDetectors(
        mgr.store,
        [TripOnce(["synthetic anomaly for test"])],
        flight=flight,
        slo=engine,
        incident_dir=str(tmp_path),
        incident_max=4,
        clock=clock,
        events=events,
        timeseries=ts,
    )
    captured = dets.tick()
    assert len(captured) == 1
    files = sorted(tmp_path.glob("incident_*.json"))
    on_disk = [_mask(json.loads(f.read_text())) for f in files]
    return dict(
        captured=[_mask(i) for i in captured],
        on_disk=on_disk,
        retained=[_mask(i) for i in dets.incidents()],
        journal_after=events.snapshot(),
        count=dets.captured,
    )


def cooldown_suppresses_repeat_trips(P):
    clock = P.time.FakeMonotonicClock(0.0)
    dets = P.obs.AnomalyDetectors(
        P.stats.StatsStore(), [TripOnce(["a", "b", "c"])], cooldown_s=60.0, clock=clock
    )
    out = [len(dets.tick())]
    clock.advance(10)
    out.append(len(dets.tick()))
    clock.advance(60)
    out.append(len(dets.tick()))
    assert out == [1, 0, 1]
    return out, [_mask(i) for i in dets.incidents()]


def incident_retention_is_bounded(P, tmp_path):
    clock = P.time.FakeMonotonicClock(0.0)
    dets = P.obs.AnomalyDetectors(
        P.stats.StatsStore(),
        [TripOnce([f"r{i}" for i in range(10)])],
        incident_dir=str(tmp_path),
        incident_max=3,
        cooldown_s=0.0,
        clock=clock,
    )
    for _ in range(10):
        dets.tick()
        clock.advance(1)
    files = sorted(tmp_path.glob("incident_*.json"))
    return dict(
        captured=dets.captured,
        retained=[_mask(i) for i in dets.incidents()],
        on_disk=sorted(json.loads(f.read_text())["id"] for f in files),
    )


def detector_exceptions_do_not_kill_the_tick(P):
    class Broken:
        name = "broken"

        def evaluate(self):
            raise RuntimeError("boom")

    dets = P.obs.AnomalyDetectors(
        P.stats.StatsStore(), [Broken(), TripOnce(["fine"])], clock=P.time.FakeMonotonicClock(0.0)
    )
    return [i["reason"] for i in dets.tick()]


def register_stats_counts_captures(P):
    store = P.stats.StatsStore()
    dets = P.obs.AnomalyDetectors(store, [TripOnce(["x"])], clock=P.time.FakeMonotonicClock(0.0))
    dets.register_stats(store)
    dets.tick()
    return store.counters(), store.gauges()


def slo_windows_and_burn_rate(P):
    engine, _mgr, clock = make_slo(P, target=0.99, window_s=100.0, latency_threshold_ms=10.0)
    engine.set_domains(["api"])
    for i in range(98):
        engine.observe("api", over_limit=False, latency_ms=50.0 if i < 10 else 1.0)
    for _ in range(2):
        engine.observe_error("api")
    engine.roll()
    out = [engine.summary()]
    for _ in range(12):
        clock.advance(10.0)
        for _ in range(10):
            engine.observe("api", over_limit=False, latency_ms=1.0)
        engine.roll()
    out.append(engine.summary())
    w = out[0]["domains"]["api"]["window"]
    assert w["burn_rate"] == pytest.approx(2.0) and w["latency_burn_rate"] == pytest.approx(10.0)
    return out


def slo_seeded_traffic_over_three_domains(P):
    """Seeded traffic over configured and stranger domains, with
    errors, over-limit and slow answers, rolled on a fake clock: the
    summary after every roll, and the float gauges."""
    engine, mgr, clock = make_slo(P, target=0.995, window_s=60.0, latency_threshold_ms=5.0)
    engine.set_domains(["a", "b", "c"])
    rng = np.random.default_rng(11)
    domains = ["a", "b", "c", "stranger"]
    out = []
    for _ in range(8):
        for _ in range(200):
            d = domains[int(rng.integers(0, 4))]
            if rng.random() < 0.02:
                engine.observe_error(d)
            else:
                engine.observe(d, bool(rng.random() < 0.3), float(rng.lognormal(0.5, 1.0)))
        clock.advance(float(rng.uniform(5, 20)))
        engine.roll()
        out.append(engine.summary())
    out.append(mgr.store.float_gauges())
    out.append(mgr.store.counters())
    return out


def slo_idle_domain_reads_healthy(P):
    engine, _mgr, _clock = make_slo(P)
    engine.set_domains(["idle"])
    engine.roll()
    return engine.summary()


def slo_unconfigured_domain_folds_into_other(P):
    engine, mgr, _clock = make_slo(P)
    engine.set_domains(["api"])
    engine.observe("unconfigured", over_limit=False, latency_ms=1.0)
    engine.observe("another-stranger", over_limit=True, latency_ms=1.0)
    s = mgr.slo_stats("_other")
    return (s.requests, s.over_limit, engine.domains(), sorted(mgr.store.counters()))


def slo_metric_families_on_store(P):
    engine, mgr, _clock = make_slo(P, target=0.999)
    engine.set_domains(["api"])
    engine.observe("api", over_limit=True, latency_ms=1.0)
    text = P.prom.render(mgr.store)
    assert "# TYPE ratelimit_tpu_slo_api_burn_rate gauge" in text
    return mgr.store.counters(), mgr.store.float_gauges(), text


SCENARIOS = [
    ewma_and_quantiles,
    latency_spike_needs_baseline_then_trips,
    latency_spike_ignores_thin_traffic,
    latency_spike_on_seeded_latencies,
    over_limit_surge_per_domain,
    queue_saturation_threshold,
    error_rate,
    cooldown_suppresses_repeat_trips,
    detector_exceptions_do_not_kill_the_tick,
    register_stats_counts_captures,
    slo_windows_and_burn_rate,
    slo_seeded_traffic_over_three_domains,
    slo_idle_domain_reads_healthy,
    slo_unconfigured_domain_folds_into_other,
    slo_metric_families_on_store,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


@pytest.mark.parametrize(
    "scenario",
    [tick_captures_incident_with_evidence, incident_retention_is_bounded],
    ids=lambda f: f.__name__,
)
def test_incident_capture_same_in_both_packages(scenario, tmp_path):
    want = scenario(JAX, tmp_path / "jax")
    got = scenario(PORT, tmp_path / "port")
    assert got == want


def test_manager_slo_interning_is_idempotent_and_bounded():
    mgr = stats.Manager()
    a = mgr.slo_stats("d")
    assert mgr.slo_stats("d") is a
    for i in range(stats.MAX_SLO_DOMAINS + 10):
        mgr.slo_stats(f"flood-{i}")
    assert mgr.slo_stats("one-more").domain == "_other"


# ---------------------------------------------------------------------------
# the debug views
# ---------------------------------------------------------------------------


def _serve(P, **planes):
    srv = P.http.HttpServer("127.0.0.1", 0, name="debug")
    P.http.add_debug_routes(srv, planes.pop("store"), **planes)
    srv.start()
    return srv


def _get(srv, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.bound_port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _views(P, tmp_path):
    clock = P.time.FakeMonotonicClock(10.0)
    engine, mgr, _ = make_slo(P, clock=clock)
    engine.set_domains(["api"])
    for i in range(30):
        engine.observe("api", over_limit=i % 3 == 0, latency_ms=float(i))
    engine.observe_error("api")
    dets = P.obs.AnomalyDetectors(
        mgr.store, [TripOnce(["why"])], slo=engine, incident_dir=str(tmp_path), clock=clock
    )
    dets.tick()
    on = _serve(P, store=mgr.store, slo=engine, detectors=dets)
    off = _serve(P, store=mgr.store)
    try:
        out = {}
        for name, srv in (("on", on), ("off", off)):
            for path in ("/debug/slo", "/debug/incidents"):
                status, body = _get(srv, path)
                if status == 200 and path == "/debug/incidents":
                    body = json.loads(body)
                    body["incident_dir"] = None
                    body["incidents"] = [_mask(i) for i in body["incidents"]]
                out[(name, path)] = (status, body)
        return out
    finally:
        on.stop()
        off.stop()


def test_debug_slo_and_incidents_views_equal(tmp_path):
    want = _views(JAX, tmp_path / "jax")
    got = _views(PORT, tmp_path / "port")
    assert got == want
    assert got[("off", "/debug/slo")][0] == 404
    assert got[("on", "/debug/incidents")][1]["captured_total"] == 1


# ---------------------------------------------------------------------------
# nothing on the sampler thread touches a tensor
# ---------------------------------------------------------------------------


class _NoTorchOps(TorchDispatchMode):
    """Fails on any torch operator dispatched while it is active."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the sampler ran torch op {func}")


def test_tick_capture_and_sample_run_no_torch_op(tmp_path):
    """A detector tick, an incident capture and a time-series sample
    over a port cache on the CPU (its engines hold torch tensors) read
    host counters and rings only: no torch operator is dispatched, so a
    bank stalled on its stream can never hold the sampler."""
    from ratelimit_tpu_torch.api import Descriptor, RateLimitRequest
    from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
    from ratelimit_tpu_torch.backends.engine import CounterEngine
    from ratelimit_tpu_torch.config.loader import ConfigFile, load_config

    mgr = stats.Manager()
    cache = CudaRateLimitCache(
        CounterEngine(num_slots=64, buckets=(8,), device="cpu"),
        time_source=port_time.PinnedTimeSource(1000),
        batch_window_us=100,
        kernel_deadline_s=0.25,
        fault_interval_s=0,
        hotkeys_top_k=8,
    )
    clock = port_time.FakeMonotonicClock(5.0)
    flight = obs.make_flight_recorder(64, clock=clock)
    launches = obs.make_launch_recorder(64, clock=clock)
    events = obs.make_event_journal(64, clock=clock)
    cache.flight = flight
    cache.attach_launch_recorder(launches)
    cache.fault_domain.events = events
    cache.register_stats(mgr.store)
    try:
        cfg = load_config(
            [ConfigFile("config.c", "domain: d\ndescriptors:\n  - key: k\n    rate_limit:\n      unit: minute\n      requests_per_unit: 3\n")],
            mgr,
        )
        for _ in range(5):
            cache.do_limit_resolved(RateLimitRequest("d", [Descriptor.of(("k", "x"))], 1), cfg)
            flight.record("d", 1, 1, 0.5)
        cache.flush()
        slo = obs.SloEngine(mgr, clock=clock)
        slo.set_domains(["d"])
        ts = obs.make_timeseries(1.0, 10.0, clock=clock)
        obs.register_default_series(ts, mgr.store, cache=cache, launches=launches, rss=False)
        dets = obs.AnomalyDetectors(
            mgr.store,
            [
                obs.LatencySpikeDetector(mgr.store.histogram("ratelimit_server.ShouldRateLimit.response_ms")),
                obs.OverLimitSurgeDetector(slo),
                obs.QueueSaturationDetector(cache.queue_hwm_drain),
                obs.ErrorRateDetector(mgr.store),
                TripOnce(["forced"]),
            ],
            flight=flight,
            slo=slo,
            incident_dir=str(tmp_path),
            clock=clock,
            events=events,
            timeseries=ts,
        )
        with _NoTorchOps():
            for _ in range(3):
                clock.advance(1.0)
                ts.tick()
                captured = dets.tick()
                if captured:
                    assert captured[0]["ring"] and captured[0]["timeseries"]
            mgr.store.gauges()
        assert dets.captured == 1
        assert ts.snapshot()["series"]["slot_fill_pct"][-1] is not None
    finally:
        cache.close()
