"""The decision flight recorder of the port
(ratelimit_tpu_torch/observability/flight.py) against the JAX
package's.

Every scenario of the JAX package's tests/test_flight_recorder.py runs
through both packages on a FakeMonotonicClock: the same seeded records
(numpy) give the same ring, ``snapshot_dicts()`` and stats, exactly,
notes and their consumption included (decisive descriptor, shadow
candidate, fallback answer, sticky correlation id).  The concurrency
contracts (no torn row, no duplicate seq, no stale lap) hold on the
port's ring with real threads, and /debug/flight serves the same JSONL
and JSON as the JAX server, gated by DEBUG_PROFILING.
"""

import json
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.observability.flight as jax_flight
import ratelimit_tpu.server.http_server as jax_http
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
import ratelimit_tpu_torch.observability.flight as flight
import ratelimit_tpu_torch.server.http_server as http_server
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time

JAX = SimpleNamespace(flight=jax_flight, stats=jax_stats, time=jax_time, http=jax_http)
PORT = SimpleNamespace(flight=flight, stats=stats, time=port_time, http=http_server)


def _ring(P, size, t0=10.0):
    clock = P.time.FakeMonotonicClock(t0)
    return P.flight.FlightRecorder(size, clock=clock), clock


def _state(fr):
    live = fr.snapshot()
    return live.tolist(), fr.snapshot_dicts(), fr.stamped(), fr.domain_names()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def disabled_mode_returns_none(P):
    return [P.flight.make_flight_recorder(n) is None for n in (0, -5, 4)]


def record_and_snapshot_fields(P):
    fr, _ = _ring(P, 16)
    fr.note(0xDEAD, 2)
    fr.record("prod", 2, 5, 0.4)
    d = fr.snapshot_dicts()[0]
    assert d["latency_le_ms"] == 0.5 and d["stem_hash"] == f"{0xDEAD:08x}"
    return _state(fr)


def note_is_consumed_per_record(P):
    fr, _ = _ring(P, 8)
    fr.note(7, 1)
    fr.record("d", 1, 1, 0.1)
    fr.record("d", 1, 1, 0.1)
    return _state(fr)


def wraparound_keeps_latest_records(P):
    fr, clock = _ring(P, 8)
    for i in range(20):
        clock.advance(0.001)
        fr.record("d", 1, i + 1, 0.1)
    assert fr.snapshot()["seq"].tolist() == list(range(13, 21))
    return _state(fr)


def hits_addend_clamped_to_at_least_one(P):
    fr, _ = _ring(P, 4)
    fr.record("d", 1, 0, 0.1)
    fr.record("d", 1, -3, 0.1)
    return _state(fr)


def domain_interning_is_bounded(P):
    fr, _ = _ring(P, 4)
    for i in range(P.flight.MAX_DOMAINS + 50):
        fr.record(f"domain-{i}", 1, 1, 0.1)
    assert len(fr.domain_names()) == P.flight.MAX_DOMAINS
    return _state(fr)


def shadow_and_fallback_notes(P):
    """The shadow candidate's (code, algo) and a fallback answer land
    in the next record and are consumed; a shed keeps its own code."""
    fr, _ = _ring(P, 16)
    fr.note(11, 0)
    fr.note_shadow(2, 2)
    fr.record("d", 1, 1, 0.2)
    fr.record("d", 1, 1, 0.2)
    fr.note_fallback()
    fr.record("d", 2, 1, 0.2)
    fr.record("d", 1, 1, 0.2)
    fr.note_fallback()
    fr.record("d", P.flight.FLIGHT_CODE_SHED, 1, 0.2)
    fr.record("d", P.flight.FLIGHT_CODE_DEGRADED, 3, 0.2)
    fr.record("d", P.flight.FLIGHT_CODE_FORWARDED, 3, 0.2)
    return _state(fr)


def sticky_correlation_id(P):
    fr, _ = _ring(P, 16)
    fr.note_corr(0xABCDEF)
    fr.record("d", 1, 1, 0.1)
    fr.record("d", 1, 1, 0.1)
    current = fr.current_corr()
    fr.note_corr(0)
    fr.record("d", 1, 1, 0.1)
    return _state(fr), current


def correlation_ids_parse_and_format(P):
    rng = np.random.default_rng(5)
    values = [int(x) for x in rng.integers(0, 2**62, 20)] + [0, 1, 2**63 - 1]
    formatted = [P.flight.format_corr(v) for v in values]
    parsed = [P.flight.parse_corr(s) for s in formatted]
    bad = [P.flight.parse_corr(s) for s in ("", "zz", None, "-1", "ffffffffffffffffff")]
    minted = P.flight.mint_corr()
    assert 0 < minted <= 2**63 - 1
    return formatted, parsed, bad, P.flight.CORR_HEADER


def register_stats_family(P):
    fr, _ = _ring(P, 32)
    store = P.stats.StatsStore()
    fr.register_stats(store)
    fr.record("d", 1, 1, 0.1)
    fr.record("d", 1, 1, 0.1)
    return store.gauges(), store.counters()


def seeded_decision_stream(P):
    """3000 seeded decisions over a 256-row ring: domains, notes,
    codes, hits, latencies across the whole bucket ladder."""
    fr, clock = _ring(P, 256)
    rng = np.random.default_rng(2024)
    domains = [f"dom{i}" for i in range(12)]
    for _ in range(3000):
        clock.advance(float(rng.exponential(0.0005)))
        if rng.random() < 0.8:
            fr.note(int(rng.integers(0, 2**32)), int(rng.integers(0, 8)))
        if rng.random() < 0.1:
            fr.note_shadow(int(rng.integers(0, 3)), int(rng.integers(1, 3)))
        if rng.random() < 0.05:
            fr.note_fallback()
        if rng.random() < 0.2:
            fr.note_corr(int(rng.integers(0, 2**62)))
        fr.record(
            domains[int(rng.integers(0, 12))],
            int(rng.integers(0, 3)),
            int(rng.integers(0, 5)),
            float(rng.lognormal(0.0, 2.5)),
        )
    return _state(fr), fr.snapshot_dicts(limit=17)


SCENARIOS = [
    disabled_mode_returns_none,
    record_and_snapshot_fields,
    note_is_consumed_per_record,
    wraparound_keeps_latest_records,
    hits_addend_clamped_to_at_least_one,
    domain_interning_is_bounded,
    shadow_and_fallback_notes,
    sticky_correlation_id,
    correlation_ids_parse_and_format,
    register_stats_family,
    seeded_decision_stream,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_ring_layout_and_constants_match():
    assert flight.FLIGHT_DTYPE == jax_flight.FLIGHT_DTYPE
    assert flight.LATENCY_BOUNDS_MS == jax_flight.LATENCY_BOUNDS_MS
    for name in (
        "FLIGHT_CODE_SHED",
        "FLIGHT_CODE_DEGRADED",
        "FLIGHT_CODE_FORWARDED",
        "FLIGHT_CODE_FALLBACK",
        "MAX_DOMAINS",
        "CORR_HEADER",
    ):
        assert getattr(flight, name) == getattr(jax_flight, name), name


# ---------------------------------------------------------------------------
# concurrency, on the port's ring
# ---------------------------------------------------------------------------


def test_concurrent_stamping_from_many_threads():
    """Concurrent stampers never tear a record: every row satisfies a
    writer-enforced invariant (stem == hits * 7 + 1) and seqs are
    unique and ordered."""
    fr = flight.FlightRecorder(256)
    n_threads, per_thread = 8, 2000
    start = threading.Barrier(n_threads)

    def stamp(tid):
        start.wait()
        for j in range(per_thread):
            x = tid * per_thread + j
            fr.note(x * 7 + 1, tid)
            fr.record("d", 1, x, 0.1)

    threads = [threading.Thread(target=stamp, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    live = fr.snapshot()
    assert len(live) == 256 and fr.stamped() == n_threads * per_thread
    seqs = live["seq"].tolist()
    assert len(set(seqs)) == len(seqs) and seqs == sorted(seqs)
    assert (live["stem"] == live["hits"] * 7 + 1).all()


def test_snapshot_during_concurrent_writes_is_consistent():
    fr = flight.FlightRecorder(64)
    stop = threading.Event()
    errors = []

    def writer(tid):
        j = 0
        while not stop.is_set():
            fr.note(j * 7 + 1, tid)
            fr.record("d", 1, j, 0.05)
            j += 1

    def reader():
        while not stop.is_set():
            live = fr.snapshot()
            if len(live) == 0:
                continue
            seqs = live["seq"]
            if not (live["stem"] == live["hits"] * 7 + 1).all():
                errors.append("torn row")
            if len(np.unique(seqs)) != len(seqs):
                errors.append("duplicate seq")
            if int(seqs.min()) <= int(seqs.max()) - fr.size:
                errors.append("stale lap row")

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    timer = threading.Timer(0.5, stop.set)
    timer.start()
    for t in threads:
        t.join()
    timer.cancel()
    assert errors == []


def test_concurrent_domain_interning_keeps_ids_and_names_in_agreement():
    fr = flight.FlightRecorder(4096)
    start = threading.Barrier(8)

    def stamp(tid):
        start.wait()
        for j in range(200):
            fr.record(f"d{tid}-{j % 20}", 1, 1, 0.1)

    threads = [threading.Thread(target=stamp, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    names = fr.domain_names()
    assert len(names) == len(set(names)) == 161
    assert all(fr._domain_ids[n] == i for i, n in enumerate(names))


# ---------------------------------------------------------------------------
# /debug/flight
# ---------------------------------------------------------------------------


def _flight_views(P):
    fr, clock = _ring(P, 32)
    rng = np.random.default_rng(9)
    for i in range(50):  # wraps the ring
        clock.advance(0.01)
        fr.note(int(rng.integers(0, 2**32)), i % 3)
        fr.record("rl", i % 3, 1, float(rng.uniform(0.1, 9)))
    out = {}
    for profiling in (False, True):
        for ring in (fr, None):
            srv = P.http.HttpServer("127.0.0.1", 0, name="debug")
            P.http.add_debug_routes(
                srv, P.stats.StatsStore(), profiling_enabled=profiling, flight=ring
            )
            srv.start()
            try:
                for q in ("", "?format=json"):
                    url = f"http://127.0.0.1:{srv.bound_port}/debug/flight{q}"
                    try:
                        with urllib.request.urlopen(url, timeout=30) as r:
                            got = (r.status, r.headers["Content-Type"], r.read())
                    except urllib.error.HTTPError as e:
                        got = (e.code, None, e.read())
                    out[(profiling, ring is not None, q)] = got
            finally:
                srv.stop()
    return out


def test_debug_flight_view_equal():
    """Oldest first as JSONL (or JSON with ?format=json) under
    DEBUG_PROFILING, one record per line; 403 without it, 404 with no
    ring; the same bytes as the JAX server."""
    want = _flight_views(JAX)
    got = _flight_views(PORT)
    assert got == want
    status, ctype, body = got[(True, True, "")]
    assert status == 200 and ctype == "application/x-ndjson"
    seqs = [json.loads(line)["seq"] for line in body.decode().splitlines()]
    assert seqs == list(range(19, 51))
    assert got[(False, True, "")][0] == 403 and got[(True, False, "")][0] == 404
