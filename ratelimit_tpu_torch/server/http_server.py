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
- GET /debug/cluster    this replica's handoff summary (no handoff
                        here: the cluster tier is not ported)
- GET /debug/, /debug/pprof/, /debug/threadz, /debug/profile,
  /debug/xla_trace      server/debug_profiling.py

The views of observability planes not ported yet (hot keys, incidents,
SLO, overload, events, launches, time series, the flight ring) answer
as the JAX server does when the plane is off: the same status and
body bytes.  So do the cluster-handoff admin POSTs, whose setting the
runner refuses.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from google.protobuf import json_format

from . import pb  # noqa: F401

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

from ..observability import TRACEPARENT_HEADER, TRACER  # noqa: E402
from ..service import CacheError, ServiceError  # noqa: E402
from .codec import request_from_pb, response_to_pb  # noqa: E402
from .health import HealthChecker  # noqa: E402

logger = logging.getLogger("ratelimit.http")


class _Router:
    def __init__(self):
        self.routes: Dict[tuple, Callable] = {}

    def add(self, method: str, path: str, fn: Callable) -> None:
        self.routes[(method, path)] = fn

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
        self.router.add(method, path, fn)

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


def add_json_handler(server: HttpServer, service) -> None:
    """POST /json bridge (reference NewJsonHandler,
    server_impl.go:71-109).  Participates in tracing like the gRPC
    handler: an inbound ``traceparent`` header adopts the caller's
    trace, and a recording request echoes its own traceparent back as
    a response header so the client can find it in /debug/tracez."""

    def handle(h) -> None:
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


#: (path, status, body) of each debug view whose plane is not ported:
#: the JAX server's answer with that plane off.
_PLANES_OFF = (
    (
        "/debug/hotkeys",
        404,
        b"hot-key tracking disabled (HOTKEYS_TOP_K=0 or "
        b"backend without a resolution fast path)\n",
    ),
    (
        "/debug/incidents",
        404,
        b"anomaly detectors disabled (ANOMALY_INTERVAL_S=0 "
        b"and no detectors wired)\n",
    ),
    ("/debug/slo", 404, b"slo engine disabled\n"),
    (
        "/debug/overload",
        404,
        b"overload control disabled (no OVERLOAD_* setting enabled)\n",
    ),
    ("/debug/events", 404, b"event journal disabled (EVENT_JOURNAL_SIZE=0)\n"),
    (
        "/debug/launches",
        404,
        b"launch recorder disabled (LAUNCH_RECORDER_SIZE=0)\n",
    ),
    (
        "/debug/timeseries",
        404,
        b"time-series store disabled (TSDB_INTERVAL_S=0)\n",
    ),
)


def _fixed(status: int, body: bytes):
    def handle(h) -> None:
        h._reply(status, body)

    return handle


def add_debug_routes(
    server: HttpServer,
    store,
    service=None,
    profiling_enabled: bool = False,
) -> None:
    """/stats, /rlconfig, /metrics, /debug/* (server_impl.go:254-261,
    runner.go:117-124).  ``profiling_enabled`` (the DEBUG_PROFILING
    setting) opens the capture endpoints in debug_profiling.py; the
    flight-ring capture at /debug/flight then answers 404 (no ring)
    instead of 403."""

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

    def cluster_view(h) -> None:
        # The JAX server's cluster zPage with CLUSTER_HANDOFF_ENABLED
        # off and no handoff log: the cluster tier is not ported.
        h._reply(
            200,
            json.dumps({"handoff_enabled": False, "handoff": None}).encode(),
            content_type="application/json",
        )

    def flight_dump(h) -> None:
        if not profiling_enabled:
            h._reply(
                403,
                b"flight-ring capture is disabled; start the server "
                b"with DEBUG_PROFILING=1 to enable /debug/flight\n",
            )
            return
        h._reply(404, b"flight recorder disabled (FLIGHT_RECORDER_SIZE=0)\n")

    server.add_route("GET", "/stats", stats)
    server.add_route("GET", "/stats.json", stats_json)
    server.add_route("GET", "/metrics", metrics)
    server.add_route("GET", "/debug/tracez", tracez)
    server.add_route("GET", "/debug/faults", faults)
    server.add_route("GET", "/debug/cluster", cluster_view)
    server.add_route("GET", "/debug/flight", flight_dump)
    for path, status, body in _PLANES_OFF:
        server.add_route("GET", path, _fixed(status, body))
    handoff_off = _fixed(
        403,
        b"cluster handoff is disabled; start the replica with "
        b"CLUSTER_HANDOFF_ENABLED=1 to open the export/import "
        b"admin endpoints\n",
    )
    server.add_route("POST", "/debug/cluster/export", handoff_off)
    server.add_route("POST", "/debug/cluster/import", handoff_off)

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
