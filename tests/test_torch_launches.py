"""The launch flight recorder of the port
(ratelimit_tpu_torch/observability/launches.py) and its stamps in the
dispatcher, the cache and the fault domain, against the JAX package's.

Every scenario of the JAX package's tests/test_launch_recorder.py runs
through both packages: the recorder alone on a FakeMonotonicClock
(equal rings, ``snapshot_dicts()``, derived gauges and stats, exactly),
and the dispatcher and cache seams on real engines (JAX on its CPU
backend, the port's CounterEngine on the CPU).  On those seams the
phase durations are measured time and are masked by name
(``queue_wait_us``, ``launch_us``, ``complete_us``, ``ts_ns``); every
other field must be equal.  On the port alone: a launch is recorded
only after its completion, a recorder that raises never fails a launch,
and a bank restarted by the fault domain keeps stamping.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.api as jax_api
import ratelimit_tpu.backends.dispatcher as jax_dispatcher
import ratelimit_tpu.config.loader as jax_loader
import ratelimit_tpu.observability.launches as jax_launches
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.models.registry import get_algorithm as jax_get_algorithm
import ratelimit_tpu_torch.api as api
import ratelimit_tpu_torch.backends.dispatcher as dispatcher
import ratelimit_tpu_torch.config.loader as loader
import ratelimit_tpu_torch.observability.launches as launches
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.models.registry import get_algorithm

JAX = SimpleNamespace(
    launches=jax_launches,
    stats=jax_stats,
    time=jax_time,
    dispatcher=jax_dispatcher,
    api=jax_api,
    loader=jax_loader,
    engine=lambda n, **kw: JaxEngine(num_slots=n, **kw),
    algo_engine=lambda name, n: JaxEngine(
        model=jax_get_algorithm(name).make_model(n, 0.8), buckets=(8,)
    ),
    Cache=TpuRateLimitCache,
)
PORT = SimpleNamespace(
    launches=launches,
    stats=stats,
    time=port_time,
    dispatcher=dispatcher,
    api=api,
    loader=loader,
    engine=lambda n, **kw: CounterEngine(num_slots=n, device="cpu", **kw),
    algo_engine=lambda name, n: CounterEngine(
        model=get_algorithm(name).make_model(n, 0.8, device="cpu"), buckets=(8,), device="cpu"
    ),
    Cache=CudaRateLimitCache,
)

#: Measured phase durations and stamps: masked by name on real seams.
TIME_FIELDS = ("ts_ns", "queue_wait_us", "launch_us", "complete_us")


def _masked(records):
    return [{k: v for k, v in r.items() if k not in TIME_FIELDS} for r in records]


def _state(lr):
    return lr.snapshot().tolist(), lr.snapshot_dicts(), lr.stamped(), lr.items_by_algo()


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------


def disabled_mode_returns_none(P):
    return [P.launches.make_launch_recorder(n) is None for n in (0, -3, 4)]


def record_and_snapshot_fields(P):
    lr = P.launches.LaunchRecorder(16, clock=P.time.FakeMonotonicClock(10.0))
    lr.record(2, 0, 8, 3, 5, 1_500, 340_000, 90_000, P.launches.OUTCOME_OK, 0xBEEF)
    lr.record(4, 2, 1, 1, 0, 0, 0, 7_000, P.launches.OUTCOME_FALLBACK, 0)
    lr.record(5, 3, 2, 2, 2, 10, 20, 0, P.launches.OUTCOME_FAULT, 1)
    return _state(lr)


def wraparound_keeps_latest_records(P):
    lr = P.launches.LaunchRecorder(8, clock=P.time.FakeMonotonicClock(0.0))
    for i in range(20):
        lr.record(0, 0, 1, i + 1, 1, 0, 0, 0, P.launches.OUTCOME_OK)
    assert lr.snapshot()["seq"].tolist() == list(range(13, 21))
    return _state(lr)


def since_cursor_is_resumable(P):
    lr = P.launches.LaunchRecorder(16, clock=P.time.FakeMonotonicClock(0.0))
    for _ in range(5):
        lr.record(0, 0, 1, 1, 1, 0, 0, 0, P.launches.OUTCOME_OK)
    out = [lr.snapshot_dicts(), lr.snapshot_dicts(since=5)]
    lr.record(0, 0, 1, 1, 1, 0, 0, 0, P.launches.OUTCOME_OK)
    out += [lr.snapshot_dicts(since=5), lr.snapshot_dicts(limit=2)]
    return out


def p99_and_coalesce_exclude_non_ok(P):
    lr = P.launches.LaunchRecorder(32)
    for i in range(10):
        lr.record(0, 0, 4, 4, 2, 0, 1_000 * (i + 1), 0, P.launches.OUTCOME_OK)
    lr.record(0, 0, 1, 1, 1, 0, 10_000_000, 0, P.launches.OUTCOME_FAULT)
    return lr.p99_launch_ns(), lr.coalesce_ratio()


def register_stats_family_and_items_by_algo(P):
    lr = P.launches.LaunchRecorder(32)
    store = P.stats.StatsStore()
    lr.register_stats(store)
    lr.record(0, 0, 4, 3, 2, 0, 5_000, 0, P.launches.OUTCOME_OK)
    lr.record(0, 0, 4, 5, 2, 0, 7_000, 0, P.launches.OUTCOME_OK)
    lr.record(3, 2, 4, 6, 2, 0, 7_000, 0, P.launches.OUTCOME_OK)
    return store.gauges(), store.counters(), store.float_gauges(), lr.items_by_algo()


def seeded_launch_stream(P):
    lr = P.launches.LaunchRecorder(128, clock=P.time.FakeMonotonicClock(3.0))
    clock = lr._clock
    rng = np.random.default_rng(31)
    for _ in range(500):
        clock.advance(float(rng.exponential(0.001)))
        lanes = int(rng.integers(1, 4096))
        lr.record(
            int(rng.integers(0, 7)),
            int(rng.integers(0, 4)),
            lanes,
            int(rng.integers(1, 64)),
            int(rng.integers(1, lanes + 1)),
            int(rng.integers(0, 10**6)),
            int(rng.integers(1, 10**6)),
            int(rng.integers(1, 10**6)),
            int(rng.choice([0, 0, 0, 1, 2])),
            int(rng.integers(0, 2**62)) if rng.random() < 0.3 else 0,
        )
    return _state(lr), lr.p99_launch_ns(), lr.coalesce_ratio(), lr.snapshot_dicts(since=450, limit=7)


SCENARIOS = [
    disabled_mode_returns_none,
    record_and_snapshot_fields,
    wraparound_keeps_latest_records,
    since_cursor_is_resumable,
    p99_and_coalesce_exclude_non_ok,
    register_stats_family_and_items_by_algo,
    seeded_launch_stream,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_ring_layout_matches():
    assert launches.LAUNCH_DTYPE == jax_launches.LAUNCH_DTYPE
    assert (launches.OUTCOME_OK, launches.OUTCOME_FAULT, launches.OUTCOME_FALLBACK) == (
        jax_launches.OUTCOME_OK,
        jax_launches.OUTCOME_FAULT,
        jax_launches.OUTCOME_FALLBACK,
    )


def test_concurrent_stamping_from_many_threads():
    lr = launches.LaunchRecorder(256)
    n_threads, per_thread = 8, 2000
    start = threading.Barrier(n_threads)

    def stamp(tid):
        start.wait()
        for j in range(per_thread):
            x = tid * per_thread + j
            lr.record(0, 0, x * 7 + 1, x, 1, 0, 0, 0, launches.OUTCOME_OK)

    threads = [threading.Thread(target=stamp, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    live = lr.snapshot()
    assert len(live) == 256 and lr.stamped() == n_threads * per_thread
    seqs = live["seq"].tolist()
    assert len(set(seqs)) == len(seqs) and seqs == sorted(seqs)
    assert (live["lanes"] == live["items"] * 7 + 1).all()


# ---------------------------------------------------------------------------
# the dispatcher and cache seams
# ---------------------------------------------------------------------------


def dispatcher_stamps_real_launches(P):
    """A burst of items through a real dispatcher with a wide window
    lands as coalesced ok records with every phase populated."""
    d = P.dispatcher.BatchDispatcher(P.engine(64), batch_window_us=50_000, batch_limit=4096)
    lr = P.launches.make_launch_recorder(64)
    d.launches = lr
    d.launch_bank = 3
    try:
        items = []
        for i in range(8):
            it = P.dispatcher.WorkItem(
                now=0,
                lanes=[P.dispatcher.Lane(key=f"k{i}_0", expiry=60, limit=10, shadow=False, hits=1)],
                apply=lambda dec: None,
            )
            items.append(it)
            d.submit(it)
        d.flush()
        for it in items:
            it.wait(10.0)
    finally:
        d.stop()
    live = lr.snapshot()
    ok = live[live["outcome"] == P.launches.OUTCOME_OK]
    assert int(ok["items"].sum()) == 8 and (ok["bank"] == 3).all()
    assert (ok["launch_ns"] > 0).all() and (ok["complete_ns"] > 0).all()
    assert (ok["queue_wait_ns"] > 0).all() and (ok["dedup_groups"] > 0).all()
    return int(ok["items"].sum()), int(ok["lanes"].sum()), sorted(set(ok["bank"].tolist()))


YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 100
  - key: slide
    rate_limit:
      unit: minute
      requests_per_unit: 7
      algorithm: sliding_window
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 7
      algorithm: gcra
  - key: shadowed
    rate_limit:
      unit: minute
      requests_per_unit: 3
      algorithm: gcra
      shadow: true
"""


def _cache(P, recorder=True, **kw):
    cache = P.Cache(
        P.engine(256, buckets=(8,)),
        time_source=P.time.PinnedTimeSource(5000),
        batch_window_us=500,
        algorithm_banks={n: P.algo_engine(n, 256) for n in ("sliding_window", "gcra")},
        **kw,
    )
    lr = None
    if recorder:
        lr = P.launches.make_launch_recorder(256, clock=P.time.FakeMonotonicClock(1.0))
        cache.attach_launch_recorder(lr)
    return cache, lr


def cache_records_every_bank_and_decisions_unchanged(P):
    """attach_launch_recorder reaches every bank's dispatcher; each
    sequential request leaves one record per bank it touched, carrying
    the bank index and algorithm; decisions match a recorder-less
    twin."""
    plain, _ = _cache(P, recorder=False)
    recorded, lr = _cache(P)
    cfgs = [
        P.loader.load_config([P.loader.ConfigFile("config.c", YAML)], P.stats.Manager())
        for _ in range(2)
    ]
    codes = []
    try:
        for i in range(24):
            key = ("k", "slide", "tb", "shadowed")[i % 4]
            req = P.api.RateLimitRequest("d", [P.api.Descriptor.of((key, "x"))], 1)
            a = plain.do_limit_resolved(req, cfgs[0])[0][0]
            b = recorded.do_limit_resolved(req, cfgs[1])[0][0]
            assert (a.code, a.limit_remaining) == (b.code, b.limit_remaining)
            codes.append((b.code.name, b.limit_remaining))
        recorded.flush()
    finally:
        plain.close()
        recorded.close()
    # A shadowed request launches on two banks at once, so the order of
    # their records is a race: compare the records as a multiset.
    records = _masked(lr.snapshot_dicts())
    assert [r.pop("seq") for r in records] == list(range(1, len(records) + 1))
    return dict(
        codes=codes,
        records=sorted(records, key=lambda r: sorted(r.items())),
        items_by_algo=lr.items_by_algo(),
        stamped=lr.stamped(),
        coalesce=lr.coalesce_ratio(),
    )


@pytest.mark.parametrize(
    "scenario",
    [dispatcher_stamps_real_launches, cache_records_every_bank_and_decisions_unchanged],
    ids=lambda f: f.__name__,
)
def test_seam_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


class _HeldCompletion:
    """Engine proxy whose step_complete waits for `release`."""

    def __init__(self, engine):
        self._engine = engine
        self.entered = threading.Event()
        self.release = threading.Event()

    def step_complete(self, token):
        self.entered.set()
        self.release.wait(10)
        return self._engine.step_complete(token)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def test_launch_is_recorded_only_after_its_completion():
    """While the completer waits on a launch (the CUDA event wait on a
    card), the ring holds no record of it; the record lands once the
    decisions are scattered, with the completer leg in complete_ns."""
    engine = _HeldCompletion(CounterEngine(num_slots=64, device="cpu"))
    d = dispatcher.BatchDispatcher(engine, batch_window_us=100)
    lr = launches.make_launch_recorder(16)
    d.launches = lr
    try:
        it = dispatcher.WorkItem(
            now=0,
            lanes=[dispatcher.Lane(key="a_0", expiry=60, limit=10, shadow=False, hits=1)],
            apply=lambda dec: None,
        )
        d.submit(it)
        assert engine.entered.wait(10)
        assert lr.stamped() == 0
        threading.Timer(0.05, engine.release.set).start()
        it.wait(10.0)
        d.flush()
        (rec,) = lr.snapshot_dicts()
        assert rec["outcome"] == "ok" and rec["items"] == 1
        assert lr.snapshot()["complete_ns"][0] >= 40_000_000
    finally:
        engine.release.set()
        d.stop()


def test_a_raising_recorder_never_fails_a_launch():
    """A recorder that raises loses its records, never the launch: the
    dispatcher stays alive and no item is failed."""

    class Broken:
        def record(self, *args):
            raise RuntimeError("recorder broke")

    cache, _ = _cache(PORT, recorder=False, kernel_deadline_s=0.25, fault_interval_s=0)
    cache.attach_launch_recorder(Broken())
    cfg = loader.load_config([loader.ConfigFile("config.c", YAML)], stats.Manager())
    try:
        codes = [
            cache.do_limit_resolved(
                api.RateLimitRequest("d", [api.Descriptor.of(("k", "x"))], 1), cfg
            )[0][0].code.name
            for _ in range(5)
        ]
        assert codes == ["OK"] * 5
        assert cache.dispatcher.dead is None
        assert sum(cache.fault_domain.stat_faults.values()) == 0
        assert cache.fault_domain.stat_fallback_decisions == 0
    finally:
        cache.close()


def test_restarted_bank_keeps_stamping():
    """A bank quarantined and restarted by the fault domain stamps its
    fallback answers as OUTCOME_FALLBACK and, once swapped in, its new
    dispatcher's launches under the same bank index."""
    from test_torch_fault_domain import PORT as FD_PORT
    from test_torch_fault_domain import Injector, _code, _restart, _rule, make_cache

    inj, clock = Injector(), port_time.FakeMonotonicClock(100.0)
    cache = make_cache(FD_PORT, inj, deadline=0.2, clock=clock)
    lr = launches.make_launch_recorder(64)
    cache.attach_launch_recorder(lr)
    rule = _rule(FD_PORT, stats.Manager())
    fd = cache.fault_domain
    try:
        assert _code(FD_PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        assert _code(FD_PORT, cache, rule) == "OK"
        inj.heal()
        _restart(fd, clock)
        assert cache.dispatcher.launches is lr and cache.dispatcher.launch_bank == 0
        assert _code(FD_PORT, cache, rule) == "OK"
        cache.flush()
        outcomes = [r["outcome"] for r in lr.snapshot_dicts() if r["bank"] == 0]
        assert outcomes[0] == "ok" and outcomes[-1] == "ok"
        assert outcomes.count("fallback") == fd.stat_fallback_decisions == 1
    finally:
        inj.heal()
        cache.close()
