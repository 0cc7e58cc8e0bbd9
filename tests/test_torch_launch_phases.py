"""The launch recorder's phase records (observability/launches.py,
observability/phases.py's PHASE_DTYPE), stamped by the port's CounterEngine, joined to the
dispatcher's launch records, and put on a device trace's clock
(observability/phases.py).  CPU only: ``device_ns`` is 0 there."""

import threading

import numpy as np
import pytest

import ratelimit_tpu_torch.api as api
import ratelimit_tpu_torch.config.loader as loader
import ratelimit_tpu_torch.stats.manager as stats
from ratelimit_tpu_torch.backends import dispatcher
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.models.registry import get_algorithm
from ratelimit_tpu_torch.observability import launches, phases
from ratelimit_tpu_torch.utils.time import FakeMonotonicClock, PinnedTimeSource

#: PHASE_DTYPE's fields after seq, in record_phase's order.
FIELDS = phases.PHASE_DTYPE.names[1:]
CHILDREN = {"submit_ns": ("assign_ns", "stage_ns", "enqueue_ns"),
            "complete_ns": ("wait_ns", "decide_ns")}


def _fields(i, launch=0):
    """A phase record's fields, every one derived from i."""
    return (launch, i % 3, 0, 10 + i, 5 + i, i, 1000 * i, 900, 500, 100, 50,
            1000 * i + 2000, 300, 10, 280, 7 + i)


def _pack(keys, limit=3):
    lanes = [dispatcher.Lane(key=k, expiry=60, limit=limit, shadow=False, hits=1) for k in keys]
    return dispatcher.LanePack.from_lanes(lanes)


# ---------------------------------------------------------------------------
# the phase ring
# ---------------------------------------------------------------------------


def test_record_and_snapshot_fields():
    lr = launches.LaunchRecorder(16, clock=FakeMonotonicClock(1.0))
    seqs = [lr.record_phase(*_fields(i)) for i in range(3)]
    assert seqs == [1, 2, 3] and lr.phases_stamped() == 3
    live = lr.snapshot_phases()
    assert live["seq"].tolist() == [1, 2, 3]
    for i, rec in enumerate(live):
        assert tuple(int(rec[f]) for f in FIELDS) == _fields(i)
    view = lr.phase_dicts()[1]
    assert view["lanes"] == 11 and view["groups"] == 6 and view["fresh"] == 1
    assert view["submit_us"] == 0.9 and view["assign_us"] == 0.5 and view["device_us"] == 0.0
    assert view["complete_t0_ns"] == 3000 and view["algorithm"] == "fixed_window"
    # The launch ring is untouched by phase stamps.
    assert lr.stamped() == 0 and lr.snapshot_dicts() == []


def test_wraparound_keeps_the_latest_phase_records():
    lr = launches.LaunchRecorder(8)
    for i in range(20):
        lr.record_phase(*_fields(i))
    live = lr.snapshot_phases()
    assert live["seq"].tolist() == list(range(13, 21))
    assert live["lanes"].tolist() == [10 + i for i in range(12, 20)]


def test_since_cursor_resumes_and_limit_keeps_the_newest():
    lr = launches.LaunchRecorder(16)
    for i in range(5):
        lr.record_phase(*_fields(i))
    assert [r["seq"] for r in lr.phase_dicts(since=3)] == [4, 5]
    lr.record_phase(*_fields(5))
    assert [r["seq"] for r in lr.phase_dicts(since=5)] == [6]
    assert [r["seq"] for r in lr.phase_dicts(limit=2)] == [5, 6]
    assert lr.phase_dicts(since=6) == []


def test_concurrent_phase_stamping_from_many_threads():
    lr = launches.LaunchRecorder(256)
    n_threads, per_thread = 8, 2000
    start = threading.Barrier(n_threads)

    def stamp(tid):
        start.wait()
        for j in range(per_thread):
            x = tid * per_thread + j
            lr.record_phase(0, 0, 0, x * 7 + 1, x, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)

    threads = [threading.Thread(target=stamp, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    live = lr.snapshot_phases()
    assert len(live) == 256 and lr.phases_stamped() == n_threads * per_thread
    seqs = live["seq"].tolist()
    assert len(set(seqs)) == len(seqs) and seqs == sorted(seqs)
    assert (live["lanes"] == live["groups"] * 7 + 1).all()


def test_launch_views_add_phases_only_where_joined():
    lr = launches.LaunchRecorder(16, clock=FakeMonotonicClock(2.0))
    first = lr.record(0, 0, 8, 2, 5, 100, 200, 300, launches.OUTCOME_OK)
    second = lr.record(1, 2, 4, 1, 4, 100, 200, 300, launches.OUTCOME_OK)
    assert (first, second) == (1, 2)
    plain = lr.snapshot_dicts()
    lr.record_phase(*_fields(4, launch=second))
    lr.record_phase(*_fields(5, launch=0))
    joined = lr.snapshot_dicts(phases=True)
    assert "phases" not in joined[0] and joined[1]["phases"]["launch"] == second
    assert joined[1]["phases"]["lanes"] == 14
    assert [{k: v for k, v in r.items() if k != "phases"} for r in joined] == plain
    # The default view is the JAX package's.
    assert lr.snapshot_dicts() == plain


# ---------------------------------------------------------------------------
# the engine's stamps
# ---------------------------------------------------------------------------


def _check_record(rec):
    """Children inside their root, contiguous from its start, summing to
    at most it; device time 0 on the CPU."""
    for root, kids in CHILDREN.items():
        durations = [int(rec[k]) for k in kids]
        assert all(d >= 0 for d in durations)
        assert sum(durations) <= int(rec[root])
    assert int(rec["submit_t0_ns"]) + int(rec["submit_ns"]) <= int(rec["complete_t0_ns"])
    assert int(rec["device_ns"]) == 0
    spans = phases.phase_intervals([rec])
    assert [s[2] for s in spans] == list(phases.PHASES)
    assert spans[0][0] == int(rec["submit_t0_ns"])
    assert spans[0][1] == spans[1][0] and spans[1][1] == spans[2][0]
    assert spans[2][1] <= int(rec["submit_t0_ns"]) + int(rec["submit_ns"])
    assert spans[3][0] == int(rec["complete_t0_ns"]) and spans[3][1] == spans[4][0]
    assert spans[4][1] <= int(rec["complete_t0_ns"]) + int(rec["complete_ns"])


@pytest.mark.parametrize("native", [True, False], ids=["native_table", "python_table"])
def test_engine_stamps_one_record_a_chunk(native):
    engine = CounterEngine(num_slots=512, device="cpu", buckets=(8, 16, 32),
                           native_table=None if native else False)
    lr = launches.LaunchRecorder(64)
    engine.attach_launch_recorder(lr, bank=3)
    keys = [f"k{i % 7}_0" for i in range(30)]
    pack = _pack(keys)
    for n in range(4):
        d = engine.step_complete(engine.submit_packed(0, pack.key_blob, pack.meta))
        assert lr.phases_stamped() == n + 1
    assert d.codes.tolist() == [api.Code.OVER_LIMIT.value] * 30
    live = lr.snapshot_phases()
    assert live["bank"].tolist() == [3] * 4 and (live["launch"] == 0).all()
    assert live["lanes"].tolist() == [30] * 4 and live["groups"].tolist() == [7] * 4
    assert live["fresh"].tolist() == [7, 0, 0, 0]
    for rec in live:
        _check_record(rec)
    # Detached: nothing more.
    engine.attach_launch_recorder(None)
    engine.step_complete(engine.submit_packed(0, pack.key_blob, pack.meta))
    assert lr.phases_stamped() == 4


def test_algorithm_bank_stamps_its_registry_id():
    model = get_algorithm("gcra").make_model(256, 0.8, device="cpu")
    engine = CounterEngine(model=model, buckets=(8,), device="cpu")
    lr = launches.LaunchRecorder(8)
    engine.attach_launch_recorder(lr)
    pack = _pack(["tb_x"] * 3)
    pack.meta["divider"] = 60
    pack.meta["algo"] = get_algorithm("gcra").algo_id
    engine.step_complete(engine.submit_packed(100, pack.key_blob, pack.meta))
    (rec,) = lr.phase_dicts()
    assert rec["algorithm"] == "gcra" and rec["groups"] == 1 and rec["lanes"] == 3


def test_a_submission_of_several_chunks_is_one_record():
    engine = CounterEngine(num_slots=512, device="cpu", buckets=(8, 16))
    lr = launches.LaunchRecorder(8)
    engine.attach_launch_recorder(lr)
    pack = _pack([f"k{i}_0" for i in range(40)])  # three chunks of 16
    engine.step_complete(engine.submit_packed(0, pack.key_blob, pack.meta))
    (rec,) = lr.snapshot_phases()
    assert int(rec["lanes"]) == 40 and int(rec["groups"]) == 40 and int(rec["fresh"]) == 40
    _check_record(rec)


def test_step_submit_and_a_detached_engine_stamp_nothing():
    from ratelimit_tpu_torch.backends.engine import HostBatch

    engine = CounterEngine(num_slots=64, device="cpu", buckets=(8,))
    pack = _pack(["a_0"])
    token = engine.submit_packed(0, pack.key_blob, pack.meta)
    assert token[5] is None and engine.hold_phase(token) is None
    engine.step_complete(token)
    lr = launches.LaunchRecorder(8)
    engine.attach_launch_recorder(lr)
    one = np.ones(2, dtype=np.uint32)
    batch = HostBatch(slots=np.array([1, 2], dtype=np.int32), hits=one, limits=one * 5,
                      fresh=np.zeros(2, dtype=bool), shadow=np.zeros(2, dtype=bool))
    engine.step(batch)  # pre-assigned slots (warmup, probes): no phases
    assert lr.phases_stamped() == 0


class _Timer:
    """A device timer whose event pairs read the given ns (0: failed)."""

    works = True

    def __init__(self, ns):
        self.ns = ns

    def elapsed_ns(self, start, end):
        return self.ns[start]


@pytest.mark.parametrize("lanes,pairs,ns,want", [
    (2, [(0, 1)], [7_000], 7_000),
    (10, [(0, 1), (1, 2)], [7_000, 5_000], 12_000),
    (10, [(0, 1), (1, 2)], [7_000, 0], 0),
    (10, [(0, 1)], [7_000], 0),
    (2, [], [], 0),
], ids=["one_chunk", "two_chunks", "a_pair_failed", "a_chunk_untimed", "untimed"])
def test_device_time_is_unknown_unless_every_chunk_was_timed(lanes, pairs, ns, want):
    # A submission's device_ns sums its chunks' pairs; a pair that failed
    # to read, or a chunk without its pair, leaves 0 (unknown).
    engine = CounterEngine(num_slots=64, device="cpu", buckets=(8,))
    lr = launches.LaunchRecorder(8)
    engine.attach_launch_recorder(lr)
    pack = _pack([f"k{i}_0" for i in range(lanes)])
    token = engine.submit_packed(0, pack.key_blob, pack.meta)
    assert len(token[3]) == (lanes + 7) // 8
    engine._timer = _Timer(ns)
    token[5].events.extend(pairs)
    engine.step_complete(token)
    (rec,) = lr.snapshot_phases()
    assert int(rec["device_ns"]) == want
    # Every pair goes back to the engine's idle pairs.
    assert list(engine._timing) == pairs


class _Broken:
    """A recorder whose every stamp raises."""

    def record(self, *args):
        raise RuntimeError("recorder broke")

    def record_phase(self, *args):
        raise RuntimeError("recorder broke")


@pytest.mark.parametrize("recorder", [_Broken(), object()], ids=["raises", "no_phase_ring"])
def test_a_raising_recorder_never_fails_a_chunk(recorder):
    engine = CounterEngine(num_slots=64, device="cpu", buckets=(8,))
    twin = CounterEngine(num_slots=64, device="cpu", buckets=(8,))
    engine.attach_launch_recorder(recorder)
    pack = _pack(["a_0", "b_0", "a_0"], limit=1)
    for _ in range(3):
        got = engine.step_complete(engine.submit_packed(0, pack.key_blob, pack.meta))
        want = twin.step_complete(twin.submit_packed(0, pack.key_blob, pack.meta))
        assert got.codes.tolist() == want.codes.tolist()
        assert got.limit_remaining.tolist() == want.limit_remaining.tolist()


# ---------------------------------------------------------------------------
# joined to the dispatcher's launch records
# ---------------------------------------------------------------------------


def test_dispatcher_burst_joins_each_phase_to_its_launch():
    engine = CounterEngine(num_slots=256, device="cpu", buckets=(8, 16, 32, 64))
    lr = launches.LaunchRecorder(256)
    engine.attach_launch_recorder(lr, bank=1)
    d = dispatcher.BatchDispatcher(engine, batch_window_us=2_000, batch_limit=16)
    d.launches = lr
    d.launch_bank = 1
    try:
        items = []
        for i in range(40):
            it = dispatcher.WorkItem(
                now=0,
                lanes=[dispatcher.Lane(key=f"k{i % 9}_0", expiry=60, limit=10, shadow=False,
                                       hits=1)],
                apply=lambda dec: None,
            )
            items.append(it)
            d.submit(it)
        d.flush()
        for it in items:
            it.wait(10.0)
    finally:
        d.stop()
    launched = lr.snapshot()
    rides = lr.snapshot_phases()
    assert len(launched) == len(rides) > 0
    assert sorted(rides["launch"].tolist()) == launched["seq"].tolist()
    by_launch = {int(r["launch"]): r for r in rides}
    for rec in launched:
        ph = by_launch[int(rec["seq"])]
        assert int(ph["lanes"]) == int(rec["lanes"])
        assert int(ph["groups"]) == int(rec["dedup_groups"]) and int(ph["bank"]) == 1
        _check_record(ph)
    views = lr.snapshot_dicts(phases=True)
    assert all(v["phases"]["launch"] == v["seq"] for v in views)


YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 100
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 7
      algorithm: gcra
"""


def _cache(recorder=None, phases=True):
    cache = CudaRateLimitCache(
        CounterEngine(num_slots=256, buckets=(8,), device="cpu"),
        time_source=PinnedTimeSource(5000),
        batch_window_us=500,
        algorithm_banks={"gcra": CounterEngine(
            model=get_algorithm("gcra").make_model(256, 0.8, device="cpu"), buckets=(8,),
            device="cpu")},
    )
    lr = recorder if recorder is not None else launches.LaunchRecorder(256)
    cache.attach_launch_recorder(lr, phases=phases)
    return cache, lr


def _serve(cache, n=12):
    cfg = loader.load_config([loader.ConfigFile("config.c", YAML)], stats.Manager())
    codes = []
    for i in range(n):
        key = ("k", "tb")[i % 2]
        req = api.RateLimitRequest("d", [api.Descriptor.of((key, "x"))], 1)
        codes.append(cache.do_limit_resolved(req, cfg)[0][0].code.name)
    cache.flush()
    return codes


def test_cache_attaches_every_bank_engine_with_phases():
    cache, lr = _cache()
    try:
        codes = _serve(cache)
    finally:
        cache.close()
    assert codes == ["OK"] * 12
    views = lr.snapshot_dicts(phases=True)
    assert len(views) == 12 and all("phases" in v for v in views)
    assert {v["phases"]["algorithm"] for v in views} == {"fixed_window", "gcra"}
    assert all(v["phases"]["bank"] == v["bank"] for v in views)
    assert all("phases" not in v for v in lr.snapshot_dicts())


def test_cache_leaves_the_engines_detached_unless_asked():
    # The runner's recorder (attach_launch_recorder without phases): the
    # launch records only, and no engine stamps or times its chunks.
    cache, lr = _cache(phases=False)
    try:
        codes = _serve(cache)
        assert all(e._phases is None for e in cache.engines())
    finally:
        cache.close()
    assert codes == ["OK"] * 12
    assert lr.stamped() == 12 and lr.phases_stamped() == 0
    assert all("phases" not in v for v in lr.snapshot_dicts(phases=True))


def test_served_chunks_survive_a_raising_recorder():
    cache, _ = _cache(recorder=_Broken())
    try:
        assert _serve(cache, 6) == ["OK"] * 6
        assert cache.dispatcher.dead is None
    finally:
        cache.close()


# ---------------------------------------------------------------------------
# the shared clock and the named gaps
# ---------------------------------------------------------------------------


def test_offset_from_reads_keeps_the_tightest_pair():
    reads = [(100, 5_000_180, 300), (1_000, 5_001_010, 1_020), (2_000, 5_002_400, 2_500)]
    assert phases.offset_from_reads(reads) == (5_000_000, 20)
    offset, skew = phases.clock_offset(16)
    import time

    assert skew >= 0 and abs(time.time_ns() - (time.monotonic_ns() + offset)) < 50_000_000


def test_phase_intervals_convert_to_the_profiler_clock():
    rec = dict(zip(FIELDS, _fields(2)))
    # submit_t0 2000: assign 500, stage 100, enqueue 50; complete_t0 4000:
    # wait 10, decide 280; shifted by the offset.
    got = phases.phase_intervals([rec], offset_ns=1_000_000)
    assert got == [
        (1_002_000, 1_002_500, phases.ASSIGN),
        (1_002_500, 1_002_600, phases.STAGE),
        (1_002_600, 1_002_650, phases.ENQUEUE),
        (1_004_000, 1_004_010, phases.WAIT),
        (1_004_010, 1_004_290, phases.DECIDE),
    ]


def test_gaps_are_named_by_the_phase_that_covers_most():
    # Kernels at 0-10, 100-110, 300-310, 400-410 (ns); gaps 10-100,
    # 110-300, 310-400.
    acts = [(300, 10), (0, 10), (100, 10), (400, 10)]
    gaps = phases.idle_gaps(acts)
    assert gaps == [(10, 100), (110, 300), (310, 400)]
    intervals = sorted([
        (0, 80, phases.ASSIGN),  # covers 70 of the first gap
        (120, 150, phases.DECIDE),  # 30 of the second: the rest (160) is outside
        (305, 390, phases.WAIT),  # 80 of the third
    ])
    named = phases.name_gaps(gaps, intervals)
    assert named == [[phases.OUTSIDE, 190e-9], [phases.ASSIGN, 90e-9], [phases.WAIT, 90e-9]]
    split = phases.idle_by_phase(gaps, intervals)
    assert split == pytest.approx({phases.ASSIGN: 70e-9, phases.DECIDE: 30e-9,
                                   phases.WAIT: 80e-9, phases.OUTSIDE: 190e-9})
    assert sum(split.values()) == pytest.approx(sum(g[1] - g[0] for g in gaps) / 1e9)
    assert phases.name_gaps(gaps, intervals, top=1) == [[phases.OUTSIDE, 190e-9]]
    assert phases.idle_gaps([(0, 50), (10, 100)]) == []


def test_debug_launches_shows_phases_on_request():
    import json
    import urllib.error
    import urllib.request

    from ratelimit_tpu_torch.server.http_server import HttpServer, add_debug_routes
    from ratelimit_tpu_torch.stats.manager import StatsStore

    lr = launches.LaunchRecorder(16, clock=FakeMonotonicClock(1.0))
    seq = lr.record(0, 0, 8, 2, 5, 100, 200, 300, launches.OUTCOME_OK)
    lr.record_phase(*_fields(3, launch=seq))
    server = HttpServer("127.0.0.1", 0, name="phase-dbg")
    add_debug_routes(server, StatsStore(), launches=lr)
    server.start()

    def get(path):
        url = f"http://127.0.0.1:{server.bound_port}{path}"
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read())["launches"]

    try:
        assert "phases" not in get("/debug/launches")[0]
        (shown,) = get("/debug/launches?phases=1")
        assert shown["phases"]["launch"] == seq and shown["phases"]["assign_us"] == 0.5
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/debug/launches?phases=yes")
        assert e.value.code == 400
    finally:
        server.stop()
