"""The in-process time-series store of the port
(ratelimit_tpu_torch/observability/timeseries.py) against the JAX
package's, on a FakeMonotonicClock and a fixed wall clock.

Every scenario of the JAX package's tests/test_timeseries.py runs
through both packages: the same seeded sources (numpy) sampled by the
same ticks give equal columnar snapshots, cursors, summaries and stats,
exactly.  The default series over each package's cache (bank fill,
intake depth, launch and per-algorithm rates) are the same names and,
on the same traffic, the same values; /debug/timeseries answers with
the same bytes; the sampler thread ticks and stops.
"""

import json
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.api as jax_api
import ratelimit_tpu.config.loader as jax_loader
import ratelimit_tpu.observability as jax_obs
import ratelimit_tpu.server.http_server as jax_http
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
import ratelimit_tpu_torch.api as api
import ratelimit_tpu_torch.config.loader as loader
import ratelimit_tpu_torch.observability as obs
import ratelimit_tpu_torch.server.http_server as http_server
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine

JAX = SimpleNamespace(
    obs=jax_obs,
    stats=jax_stats,
    time=jax_time,
    http=jax_http,
    api=jax_api,
    loader=jax_loader,
    cache=lambda: TpuRateLimitCache(
        JaxEngine(num_slots=128, buckets=(8,)), jax_time.PinnedTimeSource(7000), batch_window_us=100
    ),
)
PORT = SimpleNamespace(
    obs=obs,
    stats=stats,
    time=port_time,
    http=http_server,
    api=api,
    loader=loader,
    cache=lambda: CudaRateLimitCache(
        CounterEngine(num_slots=128, buckets=(8,), device="cpu"),
        port_time.PinnedTimeSource(7000),
        batch_window_us=100,
    ),
)


def _store(P, interval=5.0, retention=30.0, start=100.0, wall_start=1000.0):
    clock = P.time.FakeMonotonicClock(start)
    wall = [wall_start]
    ts = P.obs.TimeSeriesStore(interval, retention, clock=clock, wall=lambda: wall[0])
    return ts, clock, wall


def _advance(clock, wall, dt):
    clock.advance(dt)
    wall[0] += dt


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def zero_interval_disables(P):
    out = [P.obs.make_timeseries(n, 3600) is None for n in (0, -1, 5)]
    with pytest.raises(ValueError):
        P.obs.TimeSeriesStore(0, 3600)
    return out


def duplicate_series_rejected(P):
    ts, _, _ = _store(P)
    ts.add_gauge("x", lambda: 1)
    with pytest.raises(ValueError) as e:
        ts.add_counter("x", lambda: 1)
    return str(e.value)


def gauge_verbatim_counter_differentiated(P):
    ts, clock, wall = _store(P)
    depth, total = [7], [0]
    ts.add_gauge("queue_depth", lambda: depth[0])
    ts.add_counter("decisions_per_s", lambda: total[0])
    ts.tick()
    depth[0], total[0] = 9, 500
    _advance(clock, wall, 5.0)
    ts.tick()
    snap = ts.snapshot()
    assert snap["series"]["decisions_per_s"] == [None, 100.0]
    return snap


def histogram_delta_p99_is_per_tick(P):
    ts, clock, wall = _store(P)
    hist = P.stats.StatsStore().histogram("rt_ms")
    ts.add_histogram_p99("p99", hist)
    ts.tick()
    for _ in range(100):
        hist.observe(1.0)
    _advance(clock, wall, 5.0)
    ts.tick()
    for _ in range(100):
        hist.observe(300.0)
    _advance(clock, wall, 5.0)
    ts.tick()
    _advance(clock, wall, 5.0)
    ts.tick()  # nothing observed since the last tick
    return ts.snapshot()


def retention_wraparound_keeps_newest_window(P):
    ts, clock, wall = _store(P, interval=5.0, retention=20.0)
    n = [0]
    ts.add_gauge("n", lambda: n[0])
    for i in range(11):
        n[0] = i
        ts.tick()
        _advance(clock, wall, 5.0)
    return ts.snapshot(), ts.slots


def since_cursor_and_series_filter(P):
    ts, clock, wall = _store(P)
    ts.add_gauge("a", lambda: 1)
    ts.add_gauge("b", lambda: 2)
    for _ in range(4):
        ts.tick()
        _advance(clock, wall, 5.0)
    return [
        ts.snapshot(since=2),
        ts.snapshot(since=4),
        ts.snapshot(series=["b", "missing"]),
    ]


def summary_last_avg_max_and_empty_series(P):
    ts, clock, wall = _store(P)
    vals = iter([3.0, 9.0, 6.0])
    ts.add_gauge("g", lambda: next(vals))
    ts.add_counter("never", lambda: 0)
    for _ in range(3):
        ts.tick()
        _advance(clock, wall, 5.0)
    return ts.summary()


def broken_source_lands_nan_not_raise(P):
    ts, clock, wall = _store(P)

    def boom():
        raise RuntimeError("source broke")

    class BadHist:
        def snapshot(self):
            raise RuntimeError("hist broke")

    ts.add_gauge("bad", boom)
    ts.add_counter("bad_rate", boom)
    ts.add_histogram_p99("bad_hist", BadHist())
    ts.add_gauge("good", lambda: 5)
    ts.tick()
    _advance(clock, wall, 5.0)
    ts.tick()
    return ts.snapshot()


def register_stats_family(P):
    ts, clock, wall = _store(P)
    ts.add_gauge("g", lambda: 1)
    store = P.stats.StatsStore()
    ts.register_stats(store)
    ts.tick()
    _advance(clock, wall, 5.0)
    ts.tick()
    return store.gauges(), store.counters()


def seeded_sources(P):
    """Seeded gauge, counter and histogram sources over 40 ticks of a
    24-slot ring."""
    ts, clock, wall = _store(P, interval=1.0, retention=24.0)
    rng = np.random.default_rng(23)
    g, c = [0.0], [0.0]
    hist = P.stats.StatsStore().histogram("h")
    ts.add_gauge("g", lambda: g[0])
    ts.add_counter("c", lambda: c[0])
    ts.add_histogram_p99("h", hist)
    for _ in range(40):
        g[0] = float(rng.normal(50, 10))
        c[0] += float(rng.integers(0, 1000))
        for x in rng.lognormal(0.5, 1.0, int(rng.integers(0, 60))):
            hist.observe(float(x))
        _advance(clock, wall, float(rng.uniform(0.5, 1.5)))
        ts.tick()
    return ts.snapshot(), ts.snapshot(since=30, series=["h"]), ts.summary()


SCENARIOS = [
    zero_interval_disables,
    duplicate_series_rejected,
    gauge_verbatim_counter_differentiated,
    histogram_delta_p99_is_per_tick,
    retention_wraparound_keeps_newest_window,
    since_cursor_and_series_filter,
    summary_last_avg_max_and_empty_series,
    broken_source_lands_nan_not_raise,
    register_stats_family,
    seeded_sources,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


# ---------------------------------------------------------------------------
# the default series over each package's cache
# ---------------------------------------------------------------------------

YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 4
"""


def default_series_over_the_cache(P):
    """register_default_series over a real cache with a launch
    recorder: the same names, and on the same traffic the same values
    (decisions/s, launches/s, per-algorithm rates, intake depth, bank
    fill); the phase p99s see no traffic here, RSS is the process's."""
    mgr = P.stats.Manager()
    cache = P.cache()
    launches = P.obs.make_launch_recorder(64)
    cache.attach_launch_recorder(launches)
    ts, clock, wall = _store(P, interval=1.0, retention=10.0)
    P.obs.register_default_series(ts, mgr.store, cache=cache, launches=launches, rss=False)
    cfg = P.loader.load_config([P.loader.ConfigFile("config.c", YAML)], mgr)
    requests = mgr.store.counter("ratelimit_server.ShouldRateLimit.total_requests")
    try:
        ts.tick()
        for n in (3, 7, 2):
            for i in range(n):
                req = P.api.RateLimitRequest("d", [P.api.Descriptor.of(("k", f"v{i}"))], 1)
                cache.do_limit_resolved(req, cfg)
                requests.inc()
            cache.flush()
            _advance(clock, wall, 1.0)
            ts.tick()
    finally:
        cache.close()
    return ts.series_names(), ts.snapshot()


def test_default_series_same_in_both_packages():
    names, snap = default_series_over_the_cache(PORT)
    assert (names, snap) == default_series_over_the_cache(JAX)
    assert {"launches_per_s", "queue_depth", "slot_fill_pct", "decisions_per_s.gcra"} <= set(names)
    assert snap["series"]["launches_per_s"][1:] == [3.0, 7.0, 2.0]


def test_default_series_without_a_cache():
    store = stats.StatsStore()
    ts, _, _ = _store(PORT)
    obs.register_default_series(ts, store)
    names = ts.series_names()
    for name in ("decisions_per_s", "p99_decode_ms", "p99_service_ms", "p99_serialize_ms", "p99_response_ms", "rss_mb"):
        assert name in names
    assert "launches_per_s" not in names and "queue_depth" not in names
    ts.tick()
    assert ts.snapshot()["series"]["rss_mb"][0] > 0


def test_sampler_thread_ticks_and_stops():
    ts = obs.TimeSeriesStore(0.01, 1.0)
    ts.add_gauge("g", lambda: 1)
    ts.start()
    try:
        deadline = time.monotonic() + 5.0
        while ts.snapshot()["seq"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        ts.stop()
    seq = ts.snapshot()["seq"]
    assert seq >= 3
    time.sleep(0.05)
    assert ts.snapshot()["seq"] == seq
    ts.stop()


# ---------------------------------------------------------------------------
# /debug/timeseries
# ---------------------------------------------------------------------------


def _views(P):
    ts, clock, wall = _store(P)
    n = [1.0]
    ts.add_gauge("a", lambda: n[0])
    ts.add_gauge("b", lambda: 2 * n[0])
    for _ in range(3):
        ts.tick()
        n[0] += 1.5
        _advance(clock, wall, 5.0)
    out = {}
    for store in (ts, None):
        srv = P.http.HttpServer("127.0.0.1", 0, name="ts-dbg")
        P.http.add_debug_routes(srv, P.stats.StatsStore(), timeseries=store)
        srv.start()
        try:
            for q in ("", "?since=1", "?series=b", "?series=a,b&since=2", "?summary=1", "?since=x"):
                url = f"http://127.0.0.1:{srv.bound_port}/debug/timeseries{q}"
                try:
                    with urllib.request.urlopen(url, timeout=10) as r:
                        got = (r.status, r.read())
                except urllib.error.HTTPError as e:
                    got = (e.code, e.read())
                out[(store is not None, q)] = got
        finally:
            srv.stop()
    return out


def test_debug_timeseries_view_equal():
    want = _views(JAX)
    got = _views(PORT)
    assert got == want
    assert json.loads(got[(True, "?series=b")][1])["series"] == {"b": [2.0, 5.0, 8.0]}
    assert got[(True, "?since=x")][0] == 400 and got[(False, "")][0] == 404
