"""HTTP transports: the port-8080 API server and the port-6070 debug
server (reference src/server/server_impl.go: 3 listeners — HTTP, gRPC,
debug — :119-153, :238-269).

Port of ratelimit_tpu/server/http_server.py.  API server routes
(server_impl.go:110-117, 227-233):
- POST /json        JSON <-> pb bridge into ShouldRateLimit;
                    OK->200, OVER_LIMIT->429, UNKNOWN->500 (:102-106),
                    unparseable body -> 400 (:76-82).
- GET  /healthcheck 200 "OK" / 500 per HealthChecker.

Debug server routes (server_impl.go:238-269, runner.go:117-124):
- GET /stats            flat counters/gauges/timers/histograms dump
- GET /stats.json       the same as JSON
- GET /metrics          Prometheus text exposition (scrape target)
- GET /rlconfig         current config dump
- GET /debug/tracez     slowest + most recent request traces
- GET /debug/faults     the device fault domain's summary (JSON)
- GET /debug/hotkeys    Space-Saving top-K of the hottest descriptor
                        stems (JSON)
- GET /debug/incidents  captured anomaly incident reports (JSON)
- GET /debug/slo        per-domain SLI / error-budget burn summary
- GET /debug/events     lifecycle event journal (?since= cursor)
- GET /debug/launches   per-launch dispatch timeline (?since= cursor)
- GET /debug/timeseries in-process capacity/latency history
- GET /debug/flight     flight-ring capture (gated by DEBUG_PROFILING)
- GET /debug/overload   the overload controller's shed floor, burns,
                        promotion set and backpressure gate (JSON)
- GET /debug/cluster    this replica's handoff summary
- POST /debug/cluster/export, /debug/cluster/import
                        counter handoff (gated by CLUSTER_HANDOFF_ENABLED)
- GET /debug/, /debug/pprof/, /debug/threadz, /debug/profile,
  /debug/xla_trace      server/debug_profiling.py

A view whose plane is off answers as the JAX server does: the same
status and body bytes.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from google.protobuf import json_format

from . import pb  # noqa: F401

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

from ..api import Code  # noqa: E402
from ..observability import FLIGHT_CODE_SHED, TRACEPARENT_HEADER, TRACER  # noqa: E402
from ..service import CacheError, ServiceError  # noqa: E402
from .codec import request_from_pb, response_to_pb  # noqa: E402
from .health import HealthChecker  # noqa: E402

logger = logging.getLogger("ratelimit.http")


class _Router:
    def __init__(self):
        self.routes: Dict[tuple, Callable] = {}

    def add(self, method: str, path: str, fn: Callable) -> None:
        self.routes[(method, path)] = fn  # tpu-lint: disable=shared-state -- routes are registered during startup wiring, before serve_forever

    def dispatch(self, method: str, path: str):
        return self.routes.get((method, path))


def _make_handler(router: _Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # A reply is two writes (headers, then body).  With Nagle's
        # algorithm on, a keep-alive client's delayed ACK holds the body
        # back ~40 ms per request; TCP_NODELAY sends it at once.
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(
            self,
            code: int,
            body: bytes,
            content_type: str = "text/plain",
            extra_headers=None,
        ):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if extra_headers:
                for k, v in extra_headers:
                    self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _run(self, method: str):
            fn = router.dispatch(method, self.path.split("?", 1)[0])
            if fn is None:
                self._reply(404, b"not found\n")
                return
            try:
                fn(self)
            except BrokenPipeError:
                pass
            except Exception as e:  # handler bug: 500, keep serving
                logger.exception("handler error on %s", self.path)
                try:
                    self._reply(500, f"{e}\n".encode())
                except Exception:
                    pass

        def do_GET(self):
            self._run("GET")

        def do_POST(self):
            self._run("POST")

    return Handler


class HttpServer:
    """ThreadingHTTPServer wrapper with route registration and
    start/stop lifecycle.  Port 0 binds a free port (``bound_port``)."""

    def __init__(self, host: str, port: int, name: str = "http"):
        self.router = _Router()
        self._server = ThreadingHTTPServer(
            (host, port), _make_handler(self.router)
        )
        self._server.daemon_threads = True
        self.bound_port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._name = name

    def add_route(self, method: str, path: str, fn) -> None:
        self.router.add(method, path, fn)  # tpu-lint: disable=shared-state -- startup wiring only, before serve_forever

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"{self._name}-listener",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()  # waits for serve_forever to return
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()


def add_json_handler(server: HttpServer, service, flight=None, slo=None) -> None:
    """POST /json bridge (reference NewJsonHandler,
    server_impl.go:71-109).  Participates in tracing like the gRPC
    handler: an inbound ``traceparent`` header adopts the caller's
    trace, and a recording request echoes its own traceparent back as
    a response header so the client can find it in /debug/tracez.
    Decisions served here stamp the flight recorder and the per-domain
    SLO rollups exactly like the gRPC handler: both transports are
    user-facing, so both count."""

    def handle(h) -> None:
        t_start = time.perf_counter()
        root = TRACER.start_span(
            "http.json", h.headers.get(TRACEPARENT_HEADER)
        )
        status, out, ctype = 500, b"", "text/plain"
        # The reply is sent AFTER the root span exits: the trace must
        # be committed (visible in the ring / exporters) before the
        # client can observe the response — a client that reads
        # /debug/tracez right after this reply must find its trace.
        with root:
            length = int(h.headers.get("Content-Length") or 0)
            body = h.rfile.read(length) if length else b""
            request_pb = rls_pb2.RateLimitRequest()
            try:
                with TRACER.span("decode"):
                    json_format.Parse(body.decode("utf-8"), request_pb)
                    request = request_from_pb(request_pb)
            except Exception as e:
                root.set_status("error", f"bad request body: {e}")
                status, out = 400, f"error parsing request body: {e}\n".encode()
                request = None
            if request is not None:
                try:
                    response = service.should_rate_limit(request)
                except (ServiceError, CacheError) as e:
                    if slo is not None:
                        slo.observe_error(request.domain)
                    root.set_status("error", str(e))
                    status, out = 500, f"{e}\n".encode()
                else:
                    with TRACER.span("serialize"):
                        response_pb = response_to_pb(response)
                        out = json_format.MessageToJson(response_pb).encode(
                            "utf-8"
                        )
                    ctype = "application/json"
                    code = rls_pb2.RateLimitResponse.Code.Name(
                        response_pb.overall_code
                    )
                    if code == "OK":
                        status = 200
                    elif code == "OVER_LIMIT":
                        status = 429
                        root.set_status("over_limit")
                    else:
                        status = 500
                    total_ms = (time.perf_counter() - t_start) * 1e3
                    if flight is not None:
                        # Sheds carry the distinguishable ring code
                        # (the gRPC handler's twin).
                        flight.record(
                            request.domain,
                            (
                                FLIGHT_CODE_SHED
                                if response.shed_reason is not None
                                else int(response.overall_code)
                            ),
                            request.hits_addend,
                            total_ms,
                        )
                    if slo is not None:
                        slo.observe(
                            request.domain,
                            response.overall_code == Code.OVER_LIMIT,
                            total_ms,
                        )
        headers = (
            [(TRACEPARENT_HEADER, root.traceparent())]
            if root.recording
            else None
        )
        h._reply(status, out, content_type=ctype, extra_headers=headers)

    server.add_route("POST", "/json", handle)


def add_healthcheck(server: HttpServer, health: HealthChecker) -> None:
    def handle(h) -> None:
        if not health.healthy:
            h._reply(500, b"NOT_HEALTHY")
        elif health.degraded:
            # Still 200 — load balancers must keep routing here (the
            # fault-domain fallback is answering) — but the body says
            # part of the device path is quarantined.
            h._reply(200, f"OK (degraded: {health.degraded_reason})".encode())
        else:
            h._reply(200, b"OK")

    server.add_route("GET", "/healthcheck", handle)


def _query(h) -> dict:
    from urllib.parse import parse_qs, urlsplit

    return parse_qs(urlsplit(h.path).query)


def add_debug_routes(
    server: HttpServer,
    store,
    service=None,
    profiling_enabled: bool = False,
    detectors=None,
    slo=None,
    overload=None,
    flight=None,
    cluster_handoff_enabled: bool = False,
    events=None,
    launches=None,
    timeseries=None,
) -> None:
    """/stats, /rlconfig, /metrics, /debug/* (server_impl.go:254-261,
    runner.go:117-124).  ``profiling_enabled`` (the DEBUG_PROFILING
    setting) opens the capture endpoints in debug_profiling.py AND the
    flight-ring capture at /debug/flight; ``detectors`` / ``slo``
    (observability/) open /debug/incidents and /debug/slo; ``overload``
    (overload/controller.py) opens /debug/overload;
    ``cluster_handoff_enabled`` (CLUSTER_HANDOFF_ENABLED) opens the
    counter-handoff admin POSTs under /debug/cluster (the GET summary
    is always on); ``events``
    (EVENT_JOURNAL_SIZE) opens /debug/events, the lifecycle timeline
    with a ``since=`` seq cursor; ``launches`` (LAUNCH_RECORDER_SIZE)
    opens /debug/launches, the per-launch dispatch timeline with the
    same cursor; ``timeseries`` (TSDB_INTERVAL_S) opens
    /debug/timeseries (``?since=&series=``, or ``?summary=1``).  The
    hot-key view reads the backend's sketch.  A view whose plane is off
    answers the JAX server's 404."""

    def stats(h) -> None:
        lines = []
        for name, value in sorted(store.snapshot().items()):
            lines.append(f"{name}: {value}")
        for name, value in sorted(store.float_gauges().items()):
            lines.append(f"{name}: {value:.6g}")
        for name, summary in sorted(store.timers().items()):
            lines.append(
                f"{name}: count={summary['count']} "
                f"mean_ms={summary['mean_ms']:.3f} max_ms={summary['max_ms']:.3f}"
                f" samples_dropped={int(summary['samples_dropped'])}"
            )
        for name, summary in sorted(store.histograms().items()):
            lines.append(
                f"{name}: count={summary['count']} "
                f"p50_ms={summary['p50_ms']:.3f} p90_ms={summary['p90_ms']:.3f} "
                f"p99_ms={summary['p99_ms']:.3f} max_ms={summary['max_ms']:.3f}"
            )
        h._reply(200, ("\n".join(lines) + "\n").encode())

    def stats_json(h) -> None:
        h._reply(
            200,
            json.dumps(
                {
                    "stats": store.snapshot(),
                    "timers": store.timers(),
                    "histograms": store.histograms(),
                }
            ).encode(),
            content_type="application/json",
        )

    from ..observability import prometheus as _prom
    from ..observability import tracez as _tracez

    def metrics(h) -> None:
        h._reply(
            200, _prom.render(store).encode(), content_type=_prom.CONTENT_TYPE
        )

    def tracez(h) -> None:
        h._reply(200, _tracez.render(TRACER).encode())

    def faults(h) -> None:
        # Device-path fault-domain zPage (backends/fault_domain.py):
        # per-bank quarantine state, fault taxonomy counters,
        # restart/probe history.
        fd = getattr(getattr(service, "cache", None), "fault_domain", None)
        if fd is None:
            h._reply(
                404,
                b"device fault domain disabled (KERNEL_DEADLINE_S=0 "
                b"or backend without one)\n",
            )
            return
        h._reply(
            200,
            json.dumps(fd.summary()).encode(),
            content_type="application/json",
        )

    def _handoff_cache(h):
        """The cache behind the handoff surface, or None (replied)."""
        cache = getattr(service, "cache", None)
        if cache is None or not hasattr(cache, "handoff_log"):
            # The JAX server's words, whose backends are named tpu.
            h._reply(
                404,
                b"no cluster-handoff-capable backend (tpu/tpu-sharded only)\n",
            )
            return None
        return cache

    def cluster_view(h) -> None:
        # THIS replica's handoff bookkeeping: what moved in and out, and
        # when.  The routing half lives on the proxy's own listener.
        log = getattr(getattr(service, "cache", None), "handoff_log", None)
        body = {
            "handoff_enabled": cluster_handoff_enabled,
            "handoff": None if log is None else log.snapshot(),
        }
        h._reply(
            200,
            json.dumps(body, default=str).encode(),
            content_type="application/json",
        )

    def _gate_handoff(h) -> bool:
        if not cluster_handoff_enabled:
            h._reply(
                403,
                b"cluster handoff is disabled; start the replica with "
                b"CLUSTER_HANDOFF_ENABLED=1 to open the export/import "
                b"admin endpoints\n",
            )
            return False
        return True

    def _read_body(h) -> bytes:
        return h.rfile.read(int(h.headers.get("Content-Length", "0") or 0))

    def cluster_export(h) -> None:
        # Counter-handoff export (cluster/handoff.py): the body names the
        # NEW membership and this replica's cluster identity; the reply
        # is the packed keys this replica no longer owns, which also
        # LEAVE it (the proxy's forwarding window covers the gap).
        if not _gate_handoff(h):
            return
        cache = _handoff_cache(h)
        if cache is None:
            return
        from ..cluster import handoff as _handoff

        try:
            req = json.loads(_read_body(h).decode("utf-8"))
            membership = list(req["membership"])
            self_id = req["self"]
            drop = bool(req.get("drop", True))
        except Exception as e:
            h._reply(400, f"bad export request: {e}\n".encode())
            return
        sections = _handoff.export_from_cache(cache, membership, self_id, drop=drop)
        h._reply(
            200,
            _handoff.pack_sections(sections),
            content_type="application/octet-stream",
        )

    def cluster_import(h) -> None:
        # Counter-handoff import: the packed sections land in this
        # replica's banks (lane re-routing, merge on collision).
        if not _gate_handoff(h):
            return
        cache = _handoff_cache(h)
        if cache is None:
            return
        from ..cluster import handoff as _handoff

        try:
            sections = _handoff.unpack_sections(_read_body(h))
        except Exception as e:
            h._reply(400, f"bad handoff blob: {e}\n".encode())
            return
        res = _handoff.import_into_cache(cache, sections)
        h._reply(200, json.dumps(res).encode(), content_type="application/json")

    def overload_view(h) -> None:
        # The live shed floor, per-domain burns, promotion set and
        # backpressure gate.
        if overload is None:
            h._reply(
                404,
                b"overload control disabled (no OVERLOAD_* setting enabled)\n",
            )
            return
        h._reply(
            200,
            json.dumps(overload.summary()).encode(),
            content_type="application/json",
        )

    def hotkeys(h) -> None:
        # The backend's Space-Saving sketch of the hottest descriptor
        # stems, resolved per request (404 when tracking is off).
        sketch = getattr(getattr(service, "cache", None), "hotkeys", None)
        if sketch is None:
            h._reply(
                404,
                b"hot-key tracking disabled (HOTKEYS_TOP_K=0 or "
                b"backend without a resolution fast path)\n",
            )
            return
        h._reply(
            200,
            json.dumps(sketch.snapshot_dict()).encode(),
            content_type="application/json",
        )

    def incidents(h) -> None:
        # The bounded ring of captured anomaly reports, newest first
        # (observability/detectors.py); INCIDENT_DIR holds the same JSON.
        if detectors is None:
            h._reply(
                404,
                b"anomaly detectors disabled (ANOMALY_INTERVAL_S=0 "
                b"and no detectors wired)\n",
            )
            return
        body = {
            "incident_dir": detectors.incident_dir,
            "captured_total": detectors.captured,
            "retained": len(detectors.incidents()),
            "incidents": detectors.incidents(),
        }
        h._reply(
            200,
            json.dumps(body, default=str).encode(),
            content_type="application/json",
        )

    def slo_summary(h) -> None:
        if slo is None:
            h._reply(404, b"slo engine disabled\n")
            return
        h._reply(
            200,
            json.dumps(slo.summary()).encode(),
            content_type="application/json",
        )

    def flight_dump(h) -> None:
        # The last FLIGHT_RECORDER_SIZE decisions as JSONL (or JSON),
        # oldest first.  Gated like /debug/profile: dumping per-request
        # decision evidence is an operator action.
        if not profiling_enabled:
            h._reply(
                403,
                b"flight-ring capture is disabled; start the server "
                b"with DEBUG_PROFILING=1 to enable /debug/flight\n",
            )
            return
        if flight is None:
            h._reply(404, b"flight recorder disabled (FLIGHT_RECORDER_SIZE=0)\n")
            return
        fmt = _query(h).get("format", ["jsonl"])[0]
        records = flight.snapshot_dicts()[::-1]
        if fmt == "json":
            h._reply(
                200,
                json.dumps({"capacity": flight.size, "records": records}).encode(),
                content_type="application/json",
            )
            return
        body = "".join(json.dumps(r) + "\n" for r in records)
        h._reply(200, body.encode(), content_type="application/x-ndjson")

    def events_view(h) -> None:
        # The ordered transition timeline; ?since=<seq> resumes a
        # poller at its last-seen cursor.
        if events is None:
            h._reply(404, b"event journal disabled (EVENT_JOURNAL_SIZE=0)\n")
            return
        try:
            since = int(_query(h).get("since", ["0"])[0])
        except ValueError:
            h._reply(400, b"bad since= cursor (want an integer)\n")
            return
        h._reply(
            200,
            json.dumps(
                {
                    "emitted": events.emitted,
                    "counts": events.counts(),
                    "events": events.snapshot(since=since),
                }
            ).encode(),
            content_type="application/json",
        )

    def launches_view(h) -> None:
        # One row per device batch with phase durations and coalescing
        # counts; ?since=<seq> is the /debug/events cursor contract.
        if launches is None:
            h._reply(404, b"launch recorder disabled (LAUNCH_RECORDER_SIZE=0)\n")
            return
        qs = _query(h)
        try:
            since = int(qs.get("since", ["0"])[0])
            limit = int(qs.get("limit", ["0"])[0]) or None
        except ValueError:
            h._reply(400, b"bad since=/limit= (want integers)\n")
            return
        h._reply(
            200,
            json.dumps(
                {
                    "stamped": launches.stamped(),
                    "capacity": launches.size,
                    "p99_launch_ns": launches.p99_launch_ns(),
                    "coalesce_ratio": launches.coalesce_ratio(),
                    "items_by_algo": launches.items_by_algo(),
                    "launches": launches.snapshot_dicts(since=since, limit=limit),
                }
            ).encode(),
            content_type="application/json",
        )

    def timeseries_view(h) -> None:
        # ?since=<seq> resumes a poller; ?series=a,b filters columns;
        # ?summary=1 returns the per-series {last,avg,max} digest.
        if timeseries is None:
            h._reply(404, b"time-series store disabled (TSDB_INTERVAL_S=0)\n")
            return
        qs = _query(h)
        if qs.get("summary", ["0"])[0] not in ("0", ""):
            h._reply(
                200,
                json.dumps(
                    {
                        "interval_s": timeseries.interval_s,
                        "summary": timeseries.summary(),
                    }
                ).encode(),
                content_type="application/json",
            )
            return
        try:
            since = int(qs.get("since", ["0"])[0])
        except ValueError:
            h._reply(400, b"bad since= cursor (want an integer)\n")
            return
        series = None
        if "series" in qs:
            series = [
                name for chunk in qs["series"] for name in chunk.split(",") if name
            ]
        h._reply(
            200,
            json.dumps(timeseries.snapshot(since=since, series=series)).encode(),
            content_type="application/json",
        )

    server.add_route("GET", "/stats", stats)
    server.add_route("GET", "/stats.json", stats_json)
    server.add_route("GET", "/metrics", metrics)
    server.add_route("GET", "/debug/tracez", tracez)
    server.add_route("GET", "/debug/hotkeys", hotkeys)
    server.add_route("GET", "/debug/events", events_view)
    server.add_route("GET", "/debug/launches", launches_view)
    server.add_route("GET", "/debug/timeseries", timeseries_view)
    server.add_route("GET", "/debug/faults", faults)
    server.add_route("GET", "/debug/incidents", incidents)
    server.add_route("GET", "/debug/slo", slo_summary)
    server.add_route("GET", "/debug/overload", overload_view)
    server.add_route("GET", "/debug/flight", flight_dump)
    server.add_route("GET", "/debug/cluster", cluster_view)
    server.add_route("POST", "/debug/cluster/export", cluster_export)
    server.add_route("POST", "/debug/cluster/import", cluster_import)

    if service is not None:

        def rlconfig(h) -> None:
            config = service.get_current_config()
            dump = config.dump() if config is not None else ""
            h._reply(200, dump.encode())

        server.add_route("GET", "/rlconfig", rlconfig)

    # Live introspection: threadz / sampling CPU profile / torch.profiler
    # trace (the net-http-pprof analog, reference server_impl.go:238-269).
    from .debug_profiling import add_profiling_routes

    add_profiling_routes(server, profiling_enabled=profiling_enabled)
