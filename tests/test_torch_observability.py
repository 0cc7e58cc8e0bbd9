"""The tracer, tracez and Prometheus exposition of the port
(ratelimit_tpu_torch/observability/) against the JAX package's.

Every scenario of the JAX package's tracer, tracez, histogram,
exposition and timer tests runs once through each package: W3C
traceparent parse/inject, the sampling and commit policy, the trace
ring, the cross-thread stamp seam, the JSONL exporter, the tracez span
tree, histogram bucket and quantile math, the golden Prometheus text
(equal bytes in both packages), and timer sample-drop accounting.  The
twin of the JAX package's scripts/metrics_smoke.py passes against a
port runner on the CPU.
"""

import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("ratelimit_tpu", "ratelimit_tpu_torch")


def _load(name):
    mgr = importlib.import_module(name + ".stats.manager")
    return SimpleNamespace(
        name=name,
        obs=importlib.import_module(name + ".observability"),
        prometheus=importlib.import_module(name + ".observability.prometheus"),
        tracez=importlib.import_module(name + ".observability.tracez"),
        Histogram=mgr.Histogram,
        StatsStore=mgr.StatsStore,
        Timer=mgr.Timer,
    )


@pytest.fixture(params=PACKAGES)
def P(request):
    return _load(request.param)


# -- traceparent -------------------------------------------------------------


def test_traceparent_roundtrip(P):
    header = P.obs.format_traceparent("ab" * 16, "cd" * 8, True)
    assert header == f"00-{'ab' * 16}-{'cd' * 8}-01"
    ctx = P.obs.parse_traceparent(header)
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == ("ab" * 16, "cd" * 8, True)
    unsampled = P.obs.format_traceparent("ab" * 16, "cd" * 8, False)
    assert P.obs.parse_traceparent(unsampled).sampled is False


@pytest.mark.parametrize(
    "bad",
    [
        None,
        "",
        "garbage",
        "00-zz" + "a" * 30 + "-" + "b" * 16 + "-01",  # non-hex
        "00-" + "a" * 31 + "-" + "b" * 16 + "-01",  # short trace id
        "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",  # forbidden version
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",  # all-zero trace id
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01",  # all-zero span id
    ],
)
def test_traceparent_malformed_is_none(P, bad):
    assert P.obs.parse_traceparent(bad) is None


# -- tracer sampling + commit policy ----------------------------------------


def _one_trace(tracer, status="ok", traceparent=None):
    root = tracer.start_span("root", traceparent)
    with root:
        with tracer.span("child"):
            pass
        if status != "ok":
            root.set_status(status)
    return root


def test_head_sampled_trace_commits_with_span_tree(P):
    tracer = P.obs.Tracer(sample_rate=1.0)
    _one_trace(tracer)
    (t,) = tracer.recent()
    assert t.root_name == "root"
    assert [s["name"] for s in t.spans] == ["child", "root"]
    child, root = t.spans
    assert child["parent_id"] == root["span_id"]
    assert root["parent_id"] == ""


def test_unsampled_clean_trace_is_dropped_but_errors_commit(P):
    tracer = P.obs.Tracer(sample_rate=0.0, sample_errors=True)
    _one_trace(tracer)  # clean: recorded then dropped at commit
    assert tracer.recent() == []
    _one_trace(tracer, status="error")
    _one_trace(tracer, status="over_limit")
    assert [t.status for t in tracer.recent()] == ["error", "over_limit"]


def test_disabled_tracer_returns_noop_everywhere(P):
    tracer = P.obs.Tracer(enabled=False)
    root = tracer.start_span("root")
    assert root.recording is False
    with root:
        assert tracer.span("child").recording is False
        assert tracer.current() is None
    assert tracer.recent() == []


def test_inbound_sampled_flag_forces_commit(P):
    tracer = P.obs.Tracer(sample_rate=0.0, sample_errors=False)
    header = P.obs.format_traceparent("ab" * 16, "cd" * 8, True)
    _one_trace(tracer, traceparent=header)
    (t,) = tracer.recent()
    assert t.trace_id == "ab" * 16
    assert t.parent_id == "cd" * 8  # upstream span is our root's parent
    assert t.spans[-1]["parent_id"] == "cd" * 8


def test_inbound_unsampled_flag_does_not_force(P):
    tracer = P.obs.Tracer(sample_rate=0.0, sample_errors=False)
    header = P.obs.format_traceparent("ab" * 16, "cd" * 8, False)
    _one_trace(tracer, traceparent=header)
    assert tracer.recent() == []


def test_exception_marks_root_error_and_propagates(P):
    tracer = P.obs.Tracer(sample_rate=1.0)
    with pytest.raises(ValueError):
        with tracer.start_span("root"):
            raise ValueError("boom")
    (t,) = tracer.recent()
    assert t.status == "error"
    assert "boom" in t.detail


def test_ring_is_bounded_and_slowest_kept(P):
    tracer = P.obs.Tracer(sample_rate=1.0, ring_size=4, slow_size=2)
    for _ in range(10):
        _one_trace(tracer)
    assert len(tracer.recent()) == 4
    slow = tracer.slowest()
    assert len(slow) == 2
    assert slow[0].duration_ms >= slow[1].duration_ms


def test_record_span_from_stamps_cross_thread(P):
    """The dispatcher seam: stamps taken on another thread become
    spans on the handler thread after the join."""
    tracer = P.obs.Tracer(sample_rate=1.0)
    stamps = {}

    def dispatcher_side():
        stamps["launch"] = time.perf_counter()
        stamps["complete"] = stamps["launch"] + 0.002

    root = tracer.start_span("root")
    with root:
        t = threading.Thread(target=dispatcher_side)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        tracer.record_span(
            "kernel.step",
            stamps["launch"],
            stamps["complete"],
            attrs={"lanes": 8},
            parent=root,
        )
    (trace,) = tracer.recent()
    kernel = [s for s in trace.spans if s["name"] == "kernel.step"]
    assert len(kernel) == 1
    assert kernel[0]["duration_ms"] == pytest.approx(2.0, rel=0.01)
    assert kernel[0]["attrs"] == {"lanes": 8}


def test_traceparent_outbound_continues_trace(P):
    tracer = P.obs.Tracer(sample_rate=1.0)
    root = tracer.start_span("root")
    with root:
        out = root.traceparent()
    ctx = P.obs.parse_traceparent(out)
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == (root.trace_id, root.span_id, True)


def test_jsonl_exporter_writes_one_line_per_trace(P, tmp_path):
    path = tmp_path / "traces.jsonl"
    tracer = P.obs.Tracer(sample_rate=1.0)
    exporter = P.obs.JsonlExporter(str(path))
    tracer.add_exporter(exporter)
    _one_trace(tracer)
    _one_trace(tracer, status="over_limit")
    exporter.close()
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    first = json.loads(lines[0])
    assert first["root"] == "root"
    assert [s["name"] for s in first["spans"]] == ["child", "root"]
    assert json.loads(lines[1])["status"] == "over_limit"


def test_tracez_renders_span_tree_and_trace_id(P):
    tracer = P.obs.Tracer(sample_rate=1.0)
    header = P.obs.format_traceparent("ab" * 16, "cd" * 8, True)
    _one_trace(tracer, traceparent=header)
    text = P.tracez.render(tracer)
    assert "ab" * 16 in text
    assert "--- slowest" in text and "--- most recent" in text
    # Child is indented under root.
    root_line = [l for l in text.splitlines() if l.strip().startswith("root")][0]
    child_line = [l for l in text.splitlines() if l.strip().startswith("child")][0]
    assert len(child_line) - len(child_line.lstrip()) > len(root_line) - len(
        root_line.lstrip()
    )


def test_tracez_renders_the_same_trace_alike():
    """One committed trace, fed to both packages' tracez: equal text
    but for the span ids and timings each tracer draws."""
    import re

    texts = []
    for name in PACKAGES:
        P = _load(name)
        tracer = P.obs.Tracer(sample_rate=1.0)
        _one_trace(tracer, traceparent=P.obs.format_traceparent("ab" * 16, "cd" * 8, True))
        texts.append(
            re.sub(r"[0-9.]+ms|start=\S+", "", P.tracez.render(tracer))
        )
    assert texts[0] == texts[1]


# -- histogram ---------------------------------------------------------------


def test_histogram_buckets_and_counts(P):
    h = P.Histogram("h", bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    bounds, counts, total_sum, count = h.snapshot()
    assert bounds == (1.0, 2.0, 4.0)
    assert counts == [1, 1, 1, 1]  # last cell = overflow
    assert count == 4
    assert total_sum == pytest.approx(105.0)


def test_histogram_quantiles_interpolate(P):
    h = P.Histogram("h", bounds=(10.0, 20.0, 40.0))
    for _ in range(100):
        h.observe(15.0)  # all in (10, 20]
    s = h.summary()
    assert s["p50_ms"] == pytest.approx(15.0)
    assert s["p99_ms"] == pytest.approx(19.9)
    assert s["count"] == 100
    assert s["max_ms"] == 15.0


def test_histogram_empty_summary_is_zero(P):
    s = P.Histogram("h").summary()
    assert s["count"] == 0
    assert s["p99_ms"] == 0.0


def test_histogram_overflow_quantile_clamps_to_last_bound(P):
    h = P.Histogram("h", bounds=(1.0, 2.0))
    for _ in range(10):
        h.observe(50.0)
    assert h.summary()["p50_ms"] == 2.0


def test_store_histogram_is_idempotent_and_listed(P):
    store = P.StatsStore()
    a = store.histogram("x.latency_ms")
    assert store.histogram("x.latency_ms") is a
    assert store.histogram_names() == ["x.latency_ms"]
    a.observe(3.0)
    assert store.histograms()["x.latency_ms"]["count"] == 1


# -- prometheus exposition (golden) ------------------------------------------

GOLDEN = (
    "# TYPE ratelimit_service_config_load_success counter\n"
    "ratelimit_service_config_load_success 3\n"
    "# TYPE ratelimit_tpu_bank0_live_keys gauge\n"
    "ratelimit_tpu_bank0_live_keys 7\n"
    "# TYPE server_response_ms histogram\n"
    'server_response_ms_bucket{le="0.5"} 1\n'
    'server_response_ms_bucket{le="1"} 2\n'
    'server_response_ms_bucket{le="2"} 2\n'
    'server_response_ms_bucket{le="+Inf"} 3\n'
    "server_response_ms_sum 6\n"
    "server_response_ms_count 3\n"
)


def _golden_store(P):
    store = P.StatsStore()
    store.counter("ratelimit.service.config_load_success").add(3)
    store.gauge("ratelimit.tpu.bank0.live_keys").set(7)
    h = store.histogram("server.response_ms", bounds=(0.5, 1.0, 2.0))
    for v in (0.25, 0.75, 5.0):
        h.observe(v)
    return store


def test_prometheus_exposition_golden(P):
    assert P.prometheus.render(_golden_store(P)) == GOLDEN


def test_prometheus_exposition_equal_across_packages():
    """A store with every family kind -- counters, fn counters, gauges,
    fn gauges, float gauges, histograms -- renders to the same bytes."""
    texts = []
    for name in PACKAGES:
        P = _load(name)
        store = _golden_store(P)
        store.counter_fn("ratelimit.tpu.fault.hang", lambda: 2)
        store.gauge_fn("ratelimit.tpu.bank1.live_keys", lambda: 5)
        store.float_gauge_fn("ratelimit.slo.d.burn", lambda: 0.1234567)
        h = store.histogram("h_ms")
        for v in (0.1, 1.0, 10.0, 100.0, 100000.0):
            h.observe(v)
        texts.append(P.prometheus.render(store))
    assert texts[0] == texts[1]
    assert "ratelimit_slo_d_burn 0.123457" in texts[0]


def test_prometheus_bucket_cumulativity_and_count_consistency(P):
    store = P.StatsStore()
    h = store.histogram("h_ms")
    for v in (0.1, 1.0, 10.0, 100.0, 100000.0):
        h.observe(v)
    text = P.prometheus.render(store)
    bucket_counts = [
        int(line.rsplit(" ", 1)[1])
        for line in text.splitlines()
        if line.startswith("h_ms_bucket")
    ]
    assert bucket_counts == sorted(bucket_counts)  # cumulative
    assert bucket_counts[-1] == 5  # +Inf == _count
    assert "h_ms_count 5" in text


def test_prometheus_name_sanitization(P):
    assert P.prometheus.metric_name("a.b-c.d") == "a_b_c_d"
    assert P.prometheus.metric_name("9lives") == "_9lives"
    store = P.StatsStore()
    store.counter("ratelimit.__tag=value.total").inc()
    assert "ratelimit___tag_value_total 1" in P.prometheus.render(store)


# -- timer sample drops -------------------------------------------------------


def test_timer_counts_dropped_samples(P):
    t = P.Timer("t")
    for _ in range(P.Timer.MAX_SAMPLES + 7):
        t.add_duration_ms(1.0)
    s = t.summary()
    assert s["count"] == P.Timer.MAX_SAMPLES + 7
    assert s["samples_dropped"] == 7
    assert len(t.drain_samples()) == P.Timer.MAX_SAMPLES
    assert t.drain_dropped() == 7
    assert t.drain_dropped() == 0  # delta semantics
    assert t.summary()["samples_dropped"] == 7


def test_metrics_smoke_twin_passes_on_the_cpu(capsys):
    """scripts/torch_metrics_smoke.py, the twin of the JAX package's
    scripts/metrics_smoke.py, makes every one of its assertions against
    a port runner with its tables on the CPU."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "torch_metrics_smoke.py")
    spec = importlib.util.spec_from_file_location("torch_metrics_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metrics_smoke"] == "ok" and out["device"] == "cpu"
    assert set(out["incidents"]) >= {"latency_spike", "over_limit_surge"}
