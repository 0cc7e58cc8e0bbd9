"""The observability smoke of scripts/metrics_smoke.py against the
port's runner (ratelimit_tpu_torch), on the card or on the CPU.

    python3 scripts/torch_metrics_smoke.py [--device cuda|cpu]

Boots a port Runner in-process (``BACKEND_TYPE=cuda``, its tables on
``--device``, ephemeral ports), pushes one traced request plus a burst
of skewed traffic through the full gRPC stack, then makes the JAX
script's assertions:

- GET /metrics serves well-formed Prometheus text: TYPE lines, per-
  phase histograms with cumulative buckets, +Inf == _count;
- the device-path and traffic-shape families render: dispatcher queue
  gauges + high-water marks, slot-table capacity/fill/evictions/
  rollovers, batch-shape histograms, hotkeys family;
- GET /debug/hotkeys ranks the injected heavy hitter first;
- GET /debug/profile?seconds=1 (DEBUG_PROFILING on) round-trips and the
  server still serves afterwards;
- GET /debug/tracez shows the request's trace (the inbound traceparent
  id) with the kernel-phase span;
- the shadow-mode rollout: a rule running ``algorithm: sliding_window,
  shadow: true`` enforces fixed-window unchanged while the candidate
  kernel evaluates the same traffic, every decision lands in the
  ratelimit.tpu.shadow.* counters and the flight ring records carry
  both codes;
- the synthetic-anomaly scenario: injected latency and a forced
  OVER_LIMIT burst trip the detectors on a deterministic
  detectors.tick(), an incident JSON with a non-empty flight-ring
  snapshot lands in INCIDENT_DIR and round-trips through
  GET /debug/incidents, the per-domain ratelimit.tpu.slo.* family shows
  on /metrics, GET /debug/slo and the generated GET /debug/ index are
  well-formed;
- GET /debug/launches carries dispatcher-stamped launches with a
  resumable ?since= cursor, a driven time-series tick lands behind
  GET /debug/timeseries (rows + ?summary=1 digest), the
  ratelimit.tpu.launch.* and ratelimit.tsdb.* families render on
  /metrics, and both endpoints appear (blurbed) in the GET /debug/
  index.

Prints one JSON line and exits 0 on success; any assertion prints
context and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request

# `python scripts/torch_metrics_smoke.py` puts scripts/ (not the repo root)
# at sys.path[0]; make the package importable either way.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


BASIC_YAML = """
domain: smoke
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 100
  - key: burst
    rate_limit:
      unit: minute
      requests_per_unit: 2
  - key: shadowed
    rate_limit:
      unit: minute
      requests_per_unit: 3
      algorithm: sliding_window
      shadow: true
"""


def main(argv=None) -> int:
    import argparse
    import tempfile
    from pathlib import Path

    import grpc

    from ratelimit_tpu_torch.runner import Runner
    from ratelimit_tpu_torch.settings import Settings
    from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path setup)
    from envoy.service.ratelimit.v3 import rls_pb2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="where the counter tables live")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        config_dir = Path(tmp) / "ratelimit" / "config"
        config_dir.mkdir(parents=True)
        (config_dir / "smoke.yaml").write_text(BASIC_YAML)
        runner = Runner(
            Settings(
                host="127.0.0.1",
                port=0,
                grpc_host="127.0.0.1",
                grpc_port=0,
                debug_host="127.0.0.1",
                debug_port=0,
                use_statsd=False,
                backend_type="cuda",
                tpu_num_slots=1 << 10,
                tpu_batch_window_us=200,
                tpu_batch_buckets=[8],
                runtime_path=tmp,
                runtime_subdirectory="ratelimit",
                local_cache_size_in_bytes=0,
                expiration_jitter_max_seconds=0,
                hotkeys_top_k=8,
                debug_profiling=True,
                flight_recorder_size=256,
                incident_dir=str(Path(tmp) / "incidents"),
                incident_max=4,
                # Sampler thread on (liveness) but slow; the scenario
                # below drives deterministic ticks itself.
                anomaly_interval_s=60.0,
                anomaly_min_samples=5,
                anomaly_cooldown_s=0.0,
                slo_latency_ms=50.0,
            ),
            device=args.device,
        )
        runner.start()
        try:
            trace_id = "5a" * 16
            header = f"00-{trace_id}-{'6b' * 8}-01"
            def request_for(value: str) -> "rls_pb2.RateLimitRequest":
                req = rls_pb2.RateLimitRequest(domain="smoke")
                d = req.descriptors.add()
                e = d.entries.add()
                e.key, e.value = "k", value
                return req

            with grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            ) as channel:
                method = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit",
                    request_serializer=(
                        rls_pb2.RateLimitRequest.SerializeToString
                    ),
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )
                resp = method(
                    request_for("smoke"),
                    timeout=60,
                    metadata=[("traceparent", header)],
                )
                assert resp.overall_code == rls_pb2.RateLimitResponse.OK, resp
                # Skewed traffic: one heavy hitter, a cold tail — the
                # hot-key sketch must rank the injected hot key first.
                for _ in range(12):
                    method(request_for("hotkey"), timeout=60)
                for i in range(3):
                    method(request_for(f"cold{i}"), timeout=60)

            debug = runner.debug_server.bound_port

            def get(path: str, port: int = 0) -> str:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port or debug}{path}", timeout=30
                ) as r:
                    assert r.status == 200, (path, r.status)
                    return r.read().decode()

            metrics = get("/metrics")
            assert "# TYPE ratelimit_server_ShouldRateLimit_response_ms histogram" in metrics
            for phase in ("decode", "service", "serialize"):
                assert (
                    f"ratelimit_server_ShouldRateLimit_phase_{phase}_ms_bucket"
                    in metrics
                ), phase
            prefix = "ratelimit_server_ShouldRateLimit_response_ms"
            buckets = [
                int(line.rsplit(" ", 1)[1])
                for line in metrics.splitlines()
                if line.startswith(prefix + "_bucket")
            ]
            count = int(
                [
                    line
                    for line in metrics.splitlines()
                    if line.startswith(prefix + "_count")
                ][0].rsplit(" ", 1)[1]
            )
            assert buckets == sorted(buckets), "buckets not cumulative"
            assert buckets[-1] == count >= 1, (buckets, count)

            # Device-path + traffic-shape families (PR: hot-key sketch,
            # lane/queue/slot-table gauges).
            for family in (
                "ratelimit_tpu_bank0_dispatch_queue",
                "ratelimit_tpu_bank0_dispatch_queue_hwm",
                "ratelimit_tpu_bank0_inflight_launches",
                "ratelimit_tpu_bank0_num_slots",
                "ratelimit_tpu_bank0_slot_fill_pct",
                "ratelimit_tpu_bank0_evictions",
                "ratelimit_tpu_bank0_window_rollovers",
                "ratelimit_tpu_bank0_batch_lanes_bucket",
                "ratelimit_tpu_bank0_batch_items_bucket",
                "ratelimit_tpu_hotkeys_tracked",
                "ratelimit_tpu_hotkeys_observed",
            ):
                assert family in metrics, family

            hot = json.loads(get("/debug/hotkeys"))
            assert hot["capacity"] == 8 and hot["tracked"] >= 4, hot
            top = hot["keys"][0]
            assert top["key"] == "smoke_k_hotkey_", hot["keys"][:3]
            assert top["hits"] >= 12, top
            ranked = [k["hits"] for k in hot["keys"]]
            assert ranked == sorted(ranked, reverse=True), ranked

            # On-demand capture round-trip (DEBUG_PROFILING=1): a
            # 1-second statistical profile must come back well-formed
            # and leave the server serving (capture lock released).
            profile = get("/debug/profile?seconds=1")
            assert "statistical cpu profile" in profile, profile[:200]
            health = get("/healthcheck", port=runner.http_server.bound_port)
            assert health == "OK", health
            with grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            ) as channel:
                method = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit",
                    request_serializer=(
                        rls_pb2.RateLimitRequest.SerializeToString
                    ),
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )
                resp = method(request_for("after-profile"), timeout=60)
            assert resp.overall_code == rls_pb2.RateLimitResponse.OK, resp

            tracez = get("/debug/tracez")
            assert trace_id in tracez, tracez
            for span in ("decode", "service.should_rate_limit", "kernel.step"):
                assert span in tracez, (span, tracez)

            # --- shadow-mode algorithm rollout ------------------------
            # One rule runs `algorithm: sliding_window, shadow: true`:
            # fixed-window keeps enforcing while the candidate kernel
            # evaluates the same traffic on its own bank.  Drive it
            # past its tiny limit and assert (a) the per-algorithm
            # divergence counter family is on /metrics with every
            # decision tallied, and (b) the flight ring records carry
            # BOTH codes (enforced + candidate) end-to-end through the
            # real gRPC stamp path.
            def shadow_request(value: str) -> "rls_pb2.RateLimitRequest":
                req = rls_pb2.RateLimitRequest(domain="smoke")
                d = req.descriptors.add()
                e = d.entries.add()
                e.key, e.value = "shadowed", value
                return req

            with grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            ) as channel:
                method = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit",
                    request_serializer=(
                        rls_pb2.RateLimitRequest.SerializeToString
                    ),
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )
                shadow_codes = [
                    method(shadow_request("s"), timeout=60).overall_code
                    for _ in range(6)
                ]
            # Enforcement stays fixed-window: 3 admitted, 3 rejected.
            assert (
                shadow_codes.count(rls_pb2.RateLimitResponse.OVER_LIMIT) == 3
            ), shadow_codes
            metrics = get("/metrics")
            shadow_vals = {}
            for family in (
                "ratelimit_tpu_shadow_sliding_window_agree",
                "ratelimit_tpu_shadow_sliding_window_diverge",
                "ratelimit_tpu_shadow_gcra_agree",
                "ratelimit_tpu_shadow_gcra_diverge",
            ):
                lines = [
                    line
                    for line in metrics.splitlines()
                    if line.startswith(family + " ")
                ]
                assert lines, family
                shadow_vals[family] = int(lines[0].rsplit(" ", 1)[1])
            # Every shadowed decision was compared, exactly once.
            assert (
                shadow_vals["ratelimit_tpu_shadow_sliding_window_agree"]
                + shadow_vals["ratelimit_tpu_shadow_sliding_window_diverge"]
                == 6
            ), shadow_vals
            dual = [
                rec
                for rec in runner.flight.snapshot_dicts()
                if "shadow_code" in rec
            ]
            assert len(dual) == 6, len(dual)
            assert all(
                rec["shadow_algorithm"] == "sliding_window" for rec in dual
            ), dual[:2]
            # Both codes present and plausible (OK=1 / OVER_LIMIT=2).
            assert {rec["code"] for rec in dual} == {1, 2}, dual
            assert all(rec["shadow_code"] in (1, 2) for rec in dual), dual

            # --- synthetic-anomaly scenario ---------------------------
            # Deterministic detector ticks: tick 1 primes the delta
            # cursors, normal traffic then tick 2 seeds the EWMA
            # baselines, then injected latency (straight into the
            # response histogram the latency detector watches) plus a
            # forced OVER_LIMIT burst on the tiny `burst` limit make
            # tick 3 trip — no sleeps, no real anomaly needed.
            def burst_request(value: str) -> "rls_pb2.RateLimitRequest":
                req = rls_pb2.RateLimitRequest(domain="smoke")
                d = req.descriptors.add()
                e = d.entries.add()
                e.key, e.value = "burst", value
                return req

            runner.detectors.tick()  # prime
            with grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            ) as channel:
                method = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/"
                    "ShouldRateLimit",
                    request_serializer=(
                        rls_pb2.RateLimitRequest.SerializeToString
                    ),
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )
                for _ in range(8):  # calm baseline traffic
                    method(request_for("baseline"), timeout=60)
                assert runner.detectors.tick() == []  # seeds baselines
                over_limit_seen = 0
                for _ in range(20):  # the anomaly: a burst key storm
                    resp = method(burst_request("storm"), timeout=60)
                    if resp.overall_code == rls_pb2.RateLimitResponse.OVER_LIMIT:
                        over_limit_seen += 1
                assert over_limit_seen >= 10, over_limit_seen
            hist = runner.stats_manager.store.histogram(
                "ratelimit_server.ShouldRateLimit.response_ms"
            )
            for _ in range(50):  # the injected latency spike
                hist.observe(800.0)
            incidents = runner.detectors.tick()
            tripped = {i["detector"] for i in incidents}
            assert "latency_spike" in tripped, incidents
            assert "over_limit_surge" in tripped, incidents

            # Bounded incident JSON on disk, with a non-empty ring
            # snapshot of the decisions around the anomaly.
            incident_files = sorted(
                (Path(tmp) / "incidents").glob("incident_*.json")
            )
            assert incident_files, "no incident file written"
            on_disk = json.loads(incident_files[-1].read_text())
            assert on_disk["ring"], "incident ring snapshot is empty"
            assert any(
                rec["domain"] == "smoke" for rec in on_disk["ring"]
            ), on_disk["ring"][:3]

            # ...and the same incidents round-trip over the endpoint.
            served = json.loads(get("/debug/incidents"))
            assert served["captured_total"] == len(incidents), served
            assert {i["id"] for i in served["incidents"]} == {
                i["id"] for i in incidents
            }
            assert served["incidents"][0]["ring"], served["incidents"][0]

            # Per-domain SLO burn-rate family on /metrics (float
            # gauges) + the rollup counters, and the /debug/slo view.
            metrics = get("/metrics")
            for family in (
                "ratelimit_tpu_slo_smoke_burn_rate",
                "ratelimit_tpu_slo_smoke_latency_burn_rate",
                "ratelimit_tpu_slo_smoke_availability",
                "ratelimit_tpu_slo_smoke_requests",
                "ratelimit_tpu_slo_smoke_over_limit",
                "ratelimit_incidents_captured",
                "ratelimit_tpu_flight_stamped",
            ):
                assert family in metrics, family
            slo = json.loads(get("/debug/slo"))
            assert slo["domains"]["smoke"]["cumulative"]["over_limit"] >= 10
            assert slo["domains"]["smoke"]["window"]["requests"] > 0

            # --- performance observability plane ----------------------
            # Every gRPC request above crossed the dispatcher, so the
            # launch flight recorder has stamped real device batches.
            launches = json.loads(get("/debug/launches"))
            assert launches["stamped"] >= 1, launches
            assert launches["capacity"] == 1024, launches
            assert launches["coalesce_ratio"] >= 1.0, launches
            row = launches["launches"][-1]
            assert row["items"] >= 1 and row["launch_us"] >= 0, row
            # corr joins only render under FLIGHT_CORR_ENABLED (off
            # here) — rows must then omit the field, not carry zeros.
            assert "corr" not in row, row
            cursor = row["seq"]
            drained = json.loads(get(f"/debug/launches?since={cursor}"))
            assert drained["launches"] == [], drained

            # The tsdb sampler runs on its own 5s cadence; one driven
            # tick (same seam the anomaly scenario uses) lands a row
            # deterministically.
            runner.timeseries.tick()
            tsdb = json.loads(get("/debug/timeseries"))
            assert tsdb["seqs"], tsdb
            assert "rss_mb" in tsdb["series"], sorted(tsdb["series"])
            assert "launches_per_s" in tsdb["series"], sorted(tsdb["series"])
            assert tsdb["series"]["rss_mb"][-1] > 0, tsdb["series"]["rss_mb"]
            digest = json.loads(get("/debug/timeseries?summary=1"))
            assert digest["interval_s"] == 5.0, digest
            assert digest["summary"]["rss_mb"]["last"] > 0, digest

            # Both stores export their stats families.
            metrics = get("/metrics")
            for family in (
                "ratelimit_tpu_launch_capacity",
                "ratelimit_tpu_launch_rate",
                "ratelimit_tpu_launch_p99_launch_ns",
                "ratelimit_tpu_launch_coalesce_ratio",
                "ratelimit_tsdb_series",
                "ratelimit_tsdb_capacity",
                "ratelimit_tsdb_ticks",
            ):
                assert family in metrics, family

            # The generated /debug/ index lists every GET endpoint,
            # with a one-line blurb for the new surfaces.
            index = get("/debug/")
            for path in (
                "/debug/incidents",
                "/debug/slo",
                "/debug/tracez",
                "/debug/launches",
                "/debug/timeseries",
            ):
                assert path in index, (path, index)
            for blurb in (
                "per-launch device-batch timeline",
                "in-process capacity/latency history",
            ):
                assert blurb in index, (blurb, index)

            print(
                json.dumps(
                    {
                        "metrics_smoke": "ok",
                        "device": args.device,
                        "response_count": count,
                        "trace_id": trace_id,
                        "launches_stamped": launches["stamped"],
                        "incidents": sorted(tripped),
                    }
                )
            )
            return 0
        finally:
            runner.stop()


if __name__ == "__main__":
    sys.exit(main())
