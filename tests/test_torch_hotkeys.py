"""The hot-key sketch of the port (ratelimit_tpu_torch/observability/
hotkeys.py) and its feed on the CUDA cache's resolution fast path,
against the JAX package's.

Every scenario of the JAX package's tests/test_hotkeys.py runs through
both packages: the Space-Saving sketch on the same seeded streams
(numpy), which must give equal snapshots, error bounds, evictions and
stats, exactly; and the serving feed, a RateLimitService over each
package's cache (TpuRateLimitCache on the JAX CPU backend, the port's
CudaRateLimitCache on the CPU), which must give equal decisions and an
equal ``/debug/hotkeys`` body.
"""

import json
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.api as jax_api
import ratelimit_tpu.observability.hotkeys as jax_hotkeys
import ratelimit_tpu.server.http_server as jax_http
import ratelimit_tpu.service as jax_service
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
import ratelimit_tpu_torch.api as api
import ratelimit_tpu_torch.observability.hotkeys as hotkeys
import ratelimit_tpu_torch.server.http_server as http_server
import ratelimit_tpu_torch.service as service
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine

JAX = SimpleNamespace(
    hk=jax_hotkeys,
    api=jax_api,
    http=jax_http,
    service=jax_service,
    stats=jax_stats,
    time=jax_time,
    cache=lambda clock, k, **kw: TpuRateLimitCache(
        JaxEngine(num_slots=1 << 10), clock, hotkeys_top_k=k, **kw
    ),
)
PORT = SimpleNamespace(
    hk=hotkeys,
    api=api,
    http=http_server,
    service=service,
    stats=stats,
    time=port_time,
    cache=lambda clock, k, **kw: CudaRateLimitCache(
        CounterEngine(num_slots=1 << 10, device="cpu"), clock, hotkeys_top_k=k, **kw
    ),
)


def feed(sketch, stream, hits=1):
    for key in stream:
        e = sketch.track(key)
        e.hits += hits
        sketch.observed += hits


def skewed_stream(seed=7, n=20_000, heavy=("hot-a", "hot-b", "hot-c")):
    """3 heavy hitters carry ~60% of the traffic, a tail of 2000 keys
    the rest (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    out = []
    for u, h, t in zip(rng.random(n), rng.integers(0, 3, n), rng.integers(0, 2000, n)):
        out.append(heavy[int(h)] if u < 0.6 else f"tail-{int(t)}")
    return out


# ---------------------------------------------------------------------------
# the sketch
# ---------------------------------------------------------------------------


def exact_counts_when_under_capacity(P):
    sketch = P.hk.HotKeySketch(capacity=16)
    feed(sketch, ["a"] * 5 + ["b"] * 3 + ["c"])
    return sketch.snapshot_dict()


def top_k_on_skewed_stream(P):
    sketch = P.hk.HotKeySketch(capacity=64)
    feed(sketch, skewed_stream())
    top = [e["key"] for e in sketch.snapshot(limit=3)]
    assert sorted(top) == ["hot-a", "hot-b", "hot-c"]
    return sketch.snapshot_dict(), sketch.evictions


def error_bound_invariant(P):
    stream = skewed_stream(seed=3, n=5000)
    sketch = P.hk.HotKeySketch(capacity=32)
    feed(sketch, stream)
    true = {}
    for k in stream:
        true[k] = true.get(k, 0) + 1
    for e in sketch.snapshot():
        assert e["hits"] >= true[e["key"]] >= e["hits"] - e["error"]
    return sketch.snapshot(), sketch.min_count()


def eviction_inherits_min_and_kills_handle(P):
    sketch = P.hk.HotKeySketch(capacity=2)
    a = sketch.track("a")
    a.hits += 5
    b = sketch.track("b")
    b.hits += 1
    c = sketch.track("c")
    assert b.key is None and c.hits == 1 and c.error == 1
    return sketch.snapshot_dict(), b.key, (c.hits, c.error)


def track_is_idempotent(P):
    sketch = P.hk.HotKeySketch(capacity=4)
    first = sketch.track("x")
    return first is sketch.track("x"), len(sketch)


def capacity_must_be_positive(P):
    out = []
    for cap in (0, -1):
        try:
            P.hk.HotKeySketch(capacity=cap)
        except ValueError as e:
            out.append(str(e))
    return out


def register_stats_bounded_family(P):
    store = P.stats.StatsStore()
    sketch = P.hk.HotKeySketch(capacity=8)
    sketch.register_stats(store)
    feed(sketch, ["k1"] * 4 + ["k2"])
    snap = store.snapshot()
    assert not [n for n in snap if "k1" in n or "k2" in n]
    return snap


def seeded_weighted_stream(P):
    """Seeded hits_addend weights over a 24-slot sketch."""
    rng = np.random.default_rng(13)
    sketch = P.hk.HotKeySketch(capacity=24)
    keys = [f"k{int(i)}" for i in rng.zipf(1.3, 4000) % 300]
    for key, w in zip(keys, rng.integers(1, 9, len(keys))):
        e = sketch.track(key)
        e.hits += int(w)
        e.over_limit += int(w) if w > 6 else 0
        sketch.observed += int(w)
    return sketch.snapshot_dict(limit=10), sketch.evictions


SKETCH_SCENARIOS = [
    exact_counts_when_under_capacity,
    top_k_on_skewed_stream,
    error_bound_invariant,
    eviction_inherits_min_and_kills_handle,
    track_is_idempotent,
    capacity_must_be_positive,
    register_stats_bounded_family,
    seeded_weighted_stream,
]


@pytest.mark.parametrize("scenario", SKETCH_SCENARIOS, ids=lambda f: f.__name__)
def test_sketch_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_thread_safety_under_concurrent_feed_and_snapshot():
    """Concurrent feeders and a snapshotting reader: no exception, the
    capacity respected, keys unique, the heavy hitters tracked (lost
    lock-free bumps are the reference's accepted race)."""
    sketch = hotkeys.HotKeySketch(capacity=16)
    errors = []

    def feeder(seed):
        try:
            feed(sketch, skewed_stream(seed=seed, n=5000))
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    def reader():
        try:
            for _ in range(200):
                assert len(sketch.snapshot_dict()["keys"]) <= 16
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    threads = [threading.Thread(target=feeder, args=(s,)) for s in range(4)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    keys = [e["key"] for e in sketch.snapshot()]
    assert len(keys) <= 16 and len(keys) == len(set(keys))
    assert {"hot-a", "hot-b", "hot-c"} <= set(keys)


# ---------------------------------------------------------------------------
# the serving feed
# ---------------------------------------------------------------------------

YAML = """
domain: hk
descriptors:
  - key: user
    rate_limit:
      unit: hour
      requests_per_unit: 10
"""


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


def make_service(P, hotkeys_top_k, **kw):
    clock = P.time.PinnedTimeSource(1_700_000_000)
    cache = P.cache(clock, hotkeys_top_k, **kw)
    mgr = P.stats.Manager()
    svc = P.service.RateLimitService(_Runtime({"config.hk": YAML}), cache, mgr, clock=clock)
    return svc, cache, mgr


def _req(P, value, hits=0):
    return P.api.RateLimitRequest("hk", [P.api.Descriptor.of(("user", value))], hits)


def _decisions(responses):
    return [
        (r.overall_code.name, [(s.code.name, s.limit_remaining) for s in r.statuses])
        for r in responses
    ]


def serving_feed_counts_stems_and_outcome_shares(P):
    svc, cache, _ = make_service(P, 8)
    try:
        out = [svc.should_rate_limit(_req(P, "alice")) for _ in range(14)]
        out.append(svc.should_rate_limit(_req(P, "bob")))
        alice = cache.hotkeys.snapshot()[0]
        assert alice["key"] == "hk_user_alice_" and alice["over_limit"] == 4
        assert alice["near_limit"] == 2
        return _decisions(out), cache.hotkeys.snapshot_dict()
    finally:
        cache.close()


def serving_handle_revives_after_eviction(P):
    svc, cache, _ = make_service(P, 2)
    try:
        for v in ("a", "b", "c"):
            svc.should_rate_limit(_req(P, v))
        evicted = ({"hk_user_a_", "hk_user_b_"} - {e["key"] for e in cache.hotkeys.snapshot()}).pop()
        svc.should_rate_limit(_req(P, evicted.rsplit("_", 2)[1]))
        assert evicted in {e["key"] for e in cache.hotkeys.snapshot()}
        return evicted, cache.hotkeys.snapshot_dict()
    finally:
        cache.close()


def hits_addend_feeds_the_sketch(P):
    svc, cache, _ = make_service(P, 4)
    try:
        svc.should_rate_limit(_req(P, "a", hits=5))
        return cache.hotkeys.snapshot_dict()
    finally:
        cache.close()


def seeded_traffic_through_the_dispatcher(P):
    """Seeded users and hits through the batching dispatcher: the same
    decisions and the same sketch, over-limit and near-limit shares
    included."""
    svc, cache, mgr = make_service(P, 16, batch_window_us=100)
    rng = np.random.default_rng(21)
    try:
        out = [
            svc.should_rate_limit(_req(P, f"u{int(u)}", int(h)))
            for u, h in zip(rng.zipf(1.5, 300) % 40, rng.integers(0, 3, 300))
        ]
        counters = {k: v for k, v in mgr.store.counters().items() if "hotkeys" in k}
        gauges = {k: v for k, v in mgr.store.gauges().items() if "hotkeys" in k}
        return _decisions(out), cache.hotkeys.snapshot_dict(), counters, gauges
    finally:
        cache.close()


SERVING_SCENARIOS = [
    serving_feed_counts_stems_and_outcome_shares,
    serving_handle_revives_after_eviction,
    hits_addend_feeds_the_sketch,
    seeded_traffic_through_the_dispatcher,
]


@pytest.mark.parametrize("scenario", SERVING_SCENARIOS, ids=lambda f: f.__name__)
def test_serving_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_serving_decisions_identical_with_and_without_hotkeys():
    svc_on, cache_on, _ = make_service(PORT, 8)
    svc_off, cache_off, _ = make_service(PORT, 0)
    try:
        assert cache_off.hotkeys is None
        for i in range(25):
            a = svc_on.should_rate_limit(_req(PORT, f"u{i % 3}"))
            b = svc_off.should_rate_limit(_req(PORT, f"u{i % 3}"))
            assert _decisions([a]) == _decisions([b])
    finally:
        cache_on.close()
        cache_off.close()


def _hotkeys_view(P, k):
    svc, cache, mgr = make_service(P, k)
    if k:
        cache.register_stats(mgr.store)
    server = P.http.HttpServer("127.0.0.1", 0, name="debug-test")
    P.http.add_debug_routes(server, mgr.store, svc)
    server.start()
    try:
        for _ in range(3):
            svc.should_rate_limit(_req(P, "alice"))
        svc.should_rate_limit(_req(P, "bob"))
        url = f"http://127.0.0.1:{server.bound_port}/debug/hotkeys"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, None, e.read()
    finally:
        server.stop()
        cache.close()


@pytest.mark.parametrize("k", [8, 0], ids=["on", "off"])
def test_debug_hotkeys_view_equal(k):
    want = _hotkeys_view(JAX, k)
    got = _hotkeys_view(PORT, k)
    assert got == want
    if k:
        body = json.loads(got[2])
        assert got[1] == "application/json" and body["tracked"] == 2
        assert body["keys"][0]["key"] == "hk_user_alice_"
    else:
        assert got[0] == 404
