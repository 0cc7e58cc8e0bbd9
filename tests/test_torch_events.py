"""The lifecycle event journal of the port
(ratelimit_tpu_torch/observability/events.py) against the JAX
package's: the journal parts of tests/test_events_fleet.py through both
packages on a FakeMonotonicClock and a fixed wall clock.

The same seeded emissions (numpy) give the same ``snapshot()`` rows,
cursors, tallies, stats and JSONL file, exactly; /debug/events answers
with the same bytes (cursor, bad cursor, journal off); and the service
emits ``config_reload`` on every adopted config generation, as the JAX
service does.
"""

import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.observability.events as jax_events
import ratelimit_tpu.server.http_server as jax_http
import ratelimit_tpu.service as jax_service
import ratelimit_tpu.stats.manager as jax_stats
import ratelimit_tpu.utils.time as jax_time
import ratelimit_tpu_torch.observability.events as events
import ratelimit_tpu_torch.server.http_server as http_server
import ratelimit_tpu_torch.service as service
import ratelimit_tpu_torch.stats.manager as stats
import ratelimit_tpu_torch.utils.time as port_time

JAX = SimpleNamespace(ev=jax_events, stats=jax_stats, time=jax_time, http=jax_http, service=jax_service)
PORT = SimpleNamespace(ev=events, stats=stats, time=port_time, http=http_server, service=service)


def _journal(P, size, **kw):
    clock = P.time.FakeMonotonicClock(10.0)
    wall = [1_700_000_000.0]
    j = P.ev.EventJournal(size=size, clock=clock, wall=lambda: wall[0], **kw)
    return j, clock, wall


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def emit_snapshot_ordering_and_fields(P):
    j, clock, wall = _journal(P, 16)
    seqs = [j.emit("bank_quarantine", bank=0, kind="hang")]
    clock.advance(0.5)
    wall[0] += 0.5
    seqs.append(j.emit("bank_fallback", bank=0, mode="host"))
    clock.advance(0.5)
    wall[0] += 0.5
    seqs.append(j.emit("bank_restart", bank=0, restarts=1))
    return seqs, j.snapshot()


def rejects_unknown_type(P):
    j, _, _ = _journal(P, 4)
    with pytest.raises(ValueError, match="unknown event type") as e:
        j.emit("bank_exploded")
    return str(e.value), j.emitted


def ring_wrap_keeps_newest_window(P):
    j, _, _ = _journal(P, 4)
    for i in range(10):
        j.emit("config_reload", generation=i)
    return j.snapshot(), j.emitted, j.counts()


def since_cursor_is_resumable(P):
    j, _, _ = _journal(P, 16)
    for i in range(5):
        j.emit("shed_floor", floor=i)
    out = [j.snapshot(), j.snapshot(since=5)]
    j.emit("shed_floor", floor=99)
    out += [j.snapshot(since=5), j.snapshot(limit=2)]
    return out


def register_stats_counters(P):
    store = P.stats.StatsStore()
    j, _, _ = _journal(P, 8)
    j.register_stats(store)
    j.emit("backpressure", action="engage")
    j.emit("backpressure", action="release")
    j.emit("incident", incident="inc-1")
    return store.counter_fn_values(), store.gauges()


def jsonl_export(P, tmp_path):
    path = tmp_path / "events.jsonl"
    j, _, _ = _journal(P, 8, jsonl_path=str(path))
    j.emit("handoff_begin", old=["a:1"], new=["a:1", "b:2"])
    j.emit("handoff_end", ok=True, moved_keys=3)
    j.close()
    j.close()  # idempotent
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def make_maps_zero_to_none(P):
    return [P.ev.make_event_journal(n) is None for n in (0, -5, 16)]


def seeded_emission_stream(P):
    """2000 seeded events of every type over a 64-row ring, polled with
    a cursor every 100 emissions: every poll, the tallies and the final
    window."""
    j, clock, wall = _journal(P, 64)
    rng = np.random.default_rng(17)
    types = list(P.ev.EVENT_TYPES)
    polls, cursor = [], 0
    for i in range(2000):
        clock.advance(float(rng.exponential(0.01)))
        wall[0] += 0.01
        etype = types[int(rng.integers(0, len(types)))]
        j.emit(etype, bank=int(rng.integers(0, 8)), value=float(rng.uniform()))
        if i % 100 == 99:
            got = j.snapshot(since=cursor)
            polls.append(got)
            cursor = got[-1]["seq"]
    return polls, j.counts(), j.snapshot(limit=9)


SCENARIOS = [
    emit_snapshot_ordering_and_fields,
    rejects_unknown_type,
    ring_wrap_keeps_newest_window,
    since_cursor_is_resumable,
    register_stats_counters,
    make_maps_zero_to_none,
    seeded_emission_stream,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_in_both_packages(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_jsonl_export_same_in_both_packages(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jsonl_export(JAX, tmp_path / "jax")
    got = jsonl_export(PORT, tmp_path / "port")
    assert got == want and [e["type"] for e in got] == ["handoff_begin", "handoff_end"]


def test_event_types_match():
    assert events.EVENT_TYPES == jax_events.EVENT_TYPES


# ---------------------------------------------------------------------------
# /debug/events
# ---------------------------------------------------------------------------


def _events_views(P):
    j, _, _ = _journal(P, 8)
    j.emit("replica_eject", replica="r1:2")
    j.emit("replica_readmit", replica="r1:2")
    out = {}
    for journal in (j, None):
        srv = P.http.HttpServer("127.0.0.1", 0, name="ev-dbg")
        P.http.add_debug_routes(srv, P.stats.StatsStore(), events=journal)
        srv.start()
        try:
            for q in ("", "?since=1", "?since=2", "?since=banana"):
                url = f"http://127.0.0.1:{srv.bound_port}/debug/events{q}"
                try:
                    with urllib.request.urlopen(url, timeout=10) as r:
                        got = (r.status, r.read())
                except urllib.error.HTTPError as e:
                    got = (e.code, e.read())
                out[(journal is not None, q)] = got
        finally:
            srv.stop()
    return out


def test_debug_events_view_equal():
    want = _events_views(JAX)
    got = _events_views(PORT)
    assert got == want
    assert json.loads(got[(True, "?since=1")][1])["events"][0]["type"] == "replica_readmit"
    assert got[(True, "?since=banana")][0] == 400 and got[(False, "")][0] == 404


# ---------------------------------------------------------------------------
# the service's config_reload
# ---------------------------------------------------------------------------

YAML = "domain: {d}\ndescriptors:\n  - key: k\n    rate_limit:\n      unit: minute\n      requests_per_unit: 3\n"


class _Runtime:
    def __init__(self):
        self.files = {"config.a": YAML.format(d="a")}

    def snapshot(self):
        files = dict(self.files)

        class Snap:
            def keys(self):
                return sorted(files)

            def get(self, key):
                return files[key]

        return Snap()

    def add_update_callback(self, fn):
        pass


def _reloads(P):
    runtime = _Runtime()
    mgr = P.stats.Manager()
    svc = P.service.RateLimitService(runtime, cache=None, stats_manager=mgr)
    j, _, _ = _journal(P, 16)
    svc.events = j
    runtime.files["config.b"] = YAML.format(d="b")
    svc.reload_config()
    runtime.files["config.c"] = "not: [valid"
    svc.reload_config()  # a bad config is not adopted, and not journaled
    del runtime.files["config.c"]
    svc.reload_config()
    rows = j.snapshot()
    # Config generations count process-wide in each package, so only
    # their steps can match: each row's generation is made relative.
    first = rows[0]["generation"]
    for row in rows:
        row["generation"] -= first
    return rows


def test_config_reload_events_same_in_both_packages():
    want = _reloads(JAX)
    got = _reloads(PORT)
    assert got == want
    assert [(e["type"], e["domains"]) for e in got] == [("config_reload", 2)] * 2
