"""gRPC transport: RateLimitService + grpc.health.v1 on one server.

Port of ratelimit_tpu/server/grpc_server.py with its trace intake (an
inbound W3C ``traceparent`` adopts the caller's trace; the root span
``grpc.should_rate_limit`` has ``decode`` and ``serialize`` children),
the flight-recorder stamp and SLO rollups of every decision, and the
correlation-id intake (``x-ratelimit-corr`` metadata, FLIGHT_CORR_ENABLED).

The reference registers the generated pb service on grpc-go with a
metrics interceptor and keepalive MaxConnectionAge options
(reference src/service_cmd/runner/runner.go:100-131,
src/server/server_impl.go:183-188).  grpcio has no protoc-plugin stubs
here, so the services are registered via generic method handlers with
the generated messages' serializers — wire-identical to stub-generated
registration (method path
``/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit``).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Optional

import grpc

from . import pb  # noqa: F401  (sys.path setup)

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402
from grpchealth.v1 import health_pb2  # noqa: E402

from ..api import Code  # noqa: E402
from ..observability import (  # noqa: E402
    CORR_HEADER,
    FLIGHT_CODE_SHED,
    TRACEPARENT_HEADER,
    TRACER,
    format_corr,
    parse_corr,
)
from ..service import CacheError, ServiceError  # noqa: E402
from ..stats.manager import StatsStore  # noqa: E402
from .codec import request_from_pb, response_to_pb  # noqa: E402
from .health import HealthChecker  # noqa: E402

logger = logging.getLogger("ratelimit.grpc")

RATELIMIT_SERVICE = "envoy.service.ratelimit.v3.RateLimitService"
HEALTH_SERVICE = "grpc.health.v1.Health"


class ServerReporter:
    """Per-method total_requests counter + response_time ms timer
    (reference src/metrics/metrics.go:30-46), plus per-phase latency
    HISTOGRAMS fed straight from the handler's perf_counter stamps —
    unlike the Timer sample path (which drops past MAX_SAMPLES per
    flush), every request lands in a bucket, so /metrics p99s are
    exact bucket math, not a sampled subset."""

    def __init__(self, store: StatsStore, scope: str = "ratelimit_server"):
        self.store = store
        self.scope = scope
        base = f"{scope}.ShouldRateLimit"
        self._phase_decode = store.histogram(base + ".phase.decode_ms")
        self._phase_service = store.histogram(base + ".phase.service_ms")
        self._phase_serialize = store.histogram(base + ".phase.serialize_ms")
        self._response = store.histogram(base + ".response_ms")

    def observe(self, method: str, elapsed_s: float) -> None:
        base = f"{self.scope}.{method}"
        self.store.counter(base + ".total_requests").inc()
        self.store.timer(base + ".response_time").add_duration_ms(elapsed_s * 1e3)

    def observe_phases(
        self, recv: float, decoded: float, serviced: float, serialized: float
    ) -> None:
        """The four handler stamps -> three phase histograms + total
        (stamps are perf_counter seconds; buckets are ms)."""
        self._phase_decode.observe((decoded - recv) * 1e3)
        self._phase_service.observe((serviced - decoded) * 1e3)
        self._phase_serialize.observe((serialized - serviced) * 1e3)
        self._response.observe((serialized - recv) * 1e3)


def _ratelimit_handler(
    service,
    reporter: Optional[ServerReporter],
    flight=None,
    slo=None,
    corr_enabled: bool = False,
):
    serialize = rls_pb2.RateLimitResponse.SerializeToString
    # Correlation intake only pays when BOTH the knob is on and a ring
    # exists to stamp (FLIGHT_CORR_ENABLED, off by default).
    corr_on = bool(corr_enabled) and flight is not None

    def should_rate_limit(request_pb, context):
        start = time.perf_counter()
        # Trace intake: an inbound W3C traceparent (Envoy and any OTel
        # client send one as plain metadata) adopts the caller's trace
        # id and sampling decision; otherwise head-sampling applies.
        # The metadata scan is gated so a disabled tracer (and a
        # disabled correlation knob) costs one attribute load; one pass
        # serves both keys.
        traceparent = None
        corr = 0
        if TRACER.enabled or corr_on:
            for k, v in context.invocation_metadata():
                if k == TRACEPARENT_HEADER:
                    traceparent = v
                elif k == CORR_HEADER:
                    corr = parse_corr(v)
        if corr_on:
            # Sticky intake stamp: EVERY request (re)writes the
            # thread-local, including corr=0, so a handler thread never
            # bleeds a previous request's id into this one's records.
            flight.note_corr(corr)
        root = TRACER.start_span("grpc.should_rate_limit", traceparent)
        try:
            with root:
                with TRACER.span("decode"):
                    request = request_from_pb(request_pb)
                # Propagate the caller's gRPC deadline into the backend
                # dispatch wait (cuda_cache._execute answers per
                # DEVICE_FAILURE_MODE instead of blocking past it).
                remaining = context.time_remaining()
                if remaining is not None:
                    request.deadline = time.monotonic() + remaining
                t_decoded = time.perf_counter()
                try:
                    response = service.should_rate_limit(request)
                except (ServiceError, CacheError) as e:
                    # grpc-go turns a plain returned error into UNKNOWN;
                    # mirror that mapping (service/ratelimit.go:239-265).
                    if slo is not None:
                        # Availability SLI: a failed decision is a bad
                        # event for its domain (observability/slo.py).
                        slo.observe_error(request.domain)
                    root.set_status("error", str(e))
                    context.abort(grpc.StatusCode.UNKNOWN, str(e))
                t_serviced = time.perf_counter()
                # Serialize HERE on the handler thread (the method is
                # registered with an identity response_serializer).
                with TRACER.span("serialize"):
                    payload = serialize(response_to_pb(response))
                t_serialized = time.perf_counter()
                root.set_attr("domain", request.domain)
                root.set_attr("descriptors", len(request.descriptors))
                if corr:
                    # The span-tree side of the cross-hop join: the same
                    # hex16 id the flight ring renders.
                    root.set_attr("corr", format_corr(corr))
                if response.overall_code == Code.OVER_LIMIT:
                    # Tail-sampling override: over-limit decisions are
                    # always worth keeping (observability/trace.py).
                    root.set_status("over_limit")
                if reporter is not None:
                    reporter.observe_phases(
                        start, t_decoded, t_serviced, t_serialized
                    )
                # Decision flight recorder + per-domain SLO rollups,
                # stamped next to the per-phase histogram sink with
                # everything on hand (the backend noted stem and bank
                # thread-locally).
                total_ms = (t_serialized - start) * 1e3
                if flight is not None:
                    # Overload sheds carry their own ring code: the
                    # wire says OVER_LIMIT, the black box says why.
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
                return payload
        finally:
            if reporter is not None:
                reporter.observe("ShouldRateLimit", time.perf_counter() - start)

    return grpc.method_handlers_generic_handler(
        RATELIMIT_SERVICE,
        {
            "ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                should_rate_limit,
                request_deserializer=rls_pb2.RateLimitRequest.FromString,
                # Identity: the handler returns serialized bytes.
                response_serializer=None,
            )
        },
    )


MAX_WATCH_STREAMS = 4


def _health_handler(health: HealthChecker):
    def status():
        return (
            health_pb2.HealthCheckResponse.SERVING
            if health.healthy
            else health_pb2.HealthCheckResponse.NOT_SERVING
        )

    def check(request, context):
        return health_pb2.HealthCheckResponse(status=status())

    # Each Watch stream occupies a worker thread for its lifetime
    # (grpcio sync-server model), so the count is capped to keep the
    # pool available for ShouldRateLimit; waiting is event-driven via
    # the HealthChecker condition, not sleep-polling.
    watch_slots = threading.BoundedSemaphore(MAX_WATCH_STREAMS)

    def watch(request, context):
        if not watch_slots.acquire(blocking=False):
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"too many health watch streams (max {MAX_WATCH_STREAMS})",
            )
        try:
            version = health.version()
            yield health_pb2.HealthCheckResponse(status=status())
            while context.is_active():
                new_version = health.wait_for_change(version, timeout=30.0)
                if new_version != version:
                    version = new_version
                    yield health_pb2.HealthCheckResponse(status=status())
        finally:
            watch_slots.release()

    return grpc.method_handlers_generic_handler(
        HEALTH_SERVICE,
        {
            "Check": grpc.unary_unary_rpc_method_handler(
                check,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                watch,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
        },
    )


class _AuthInterceptor(grpc.ServerInterceptor):
    """Shared-secret auth on the RateLimitService (the Redis AUTH
    analog, reference settings.go:75-77 + dial opts
    driver_impl.go:70-88): every ShouldRateLimit must carry
    `authorization: Bearer <token>` metadata.  grpc.health.v1 stays
    open — load balancers probe without credentials, like the
    reference keeps its healthcheck outside Redis auth."""

    def __init__(self, token: str):
        import hmac as _hmac

        self._expect = f"Bearer {token}"
        self._compare = _hmac.compare_digest

        def deny(request, context):
            context.abort(
                grpc.StatusCode.UNAUTHENTICATED,
                "missing or invalid authorization token",
            )

        self._deny = grpc.unary_unary_rpc_method_handler(deny)

    def intercept_service(self, continuation, handler_call_details):
        if handler_call_details.method.startswith(
            f"/{HEALTH_SERVICE}/"
        ):
            return continuation(handler_call_details)
        for k, v in handler_call_details.invocation_metadata:
            if k == "authorization" and self._compare(v, self._expect):
                return continuation(handler_call_details)
        return self._deny


def server_credentials(
    tls_cert: str, tls_key: str, tls_ca: str = ""
) -> grpc.ServerCredentials:
    """TLS (and with `tls_ca`, mutual-TLS) server credentials from PEM
    file paths — the REDIS_TLS / client-cert analog
    (settings.go:62-74)."""
    with open(tls_key, "rb") as f:
        key = f.read()
    with open(tls_cert, "rb") as f:
        cert = f.read()
    ca = None
    if tls_ca:
        with open(tls_ca, "rb") as f:
            ca = f.read()
    return grpc.ssl_server_credentials(
        [(key, cert)],
        root_certificates=ca,
        require_client_auth=ca is not None,
    )


def create_grpc_server(
    service,
    health: HealthChecker,
    store: Optional[StatsStore] = None,
    host: str = "0.0.0.0",
    port: int = 8081,
    max_connection_age_s: float = 24 * 3600.0,
    max_connection_age_grace_s: float = 3600.0,
    max_workers: int = 32,
    credentials: Optional[grpc.ServerCredentials] = None,
    auth_token: str = "",
    flight=None,
    slo=None,
    corr_enabled: bool = False,
) -> grpc.Server:
    """Build (not start) the server; port 0 picks a free port.  The
    bound port is stored on the returned server as ``bound_port``.
    `credentials` switches the listener to TLS/mTLS (see
    server_credentials); `auth_token` requires bearer-token metadata
    on RateLimitService RPCs.  Both default off: plaintext, like the
    reference's REDIS_TLS/REDIS_AUTH defaults.  `flight` and `slo`
    (observability/) stamp every decision; `corr_enabled`
    (FLIGHT_CORR_ENABLED) adopts the caller's correlation id."""
    options = [
        # Forces client re-resolution for elastic scaling
        # (settings.go:23-27, README "GRPC Keepalive").
        ("grpc.max_connection_age_ms", int(max_connection_age_s * 1000)),
        ("grpc.max_connection_age_grace_ms", int(max_connection_age_grace_s * 1000)),
        ("grpc.so_reuseport", 1),
    ]
    reporter = ServerReporter(store) if store is not None else None
    server = grpc.server(
        futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="grpc-rpc"
        ),
        options=options,
        interceptors=(
            (_AuthInterceptor(auth_token),) if auth_token else ()
        ),
    )
    server.add_generic_rpc_handlers(
        (
            _ratelimit_handler(
                service, reporter, flight=flight, slo=slo, corr_enabled=corr_enabled
            ),
            _health_handler(health),
        )
    )
    addr = f"{host}:{port}"
    if credentials is not None:
        server.bound_port = server.add_secure_port(addr, credentials)
    else:
        server.bound_port = server.add_insecure_port(addr)
    if server.bound_port == 0:
        # grpcio reports bind failure as port 0 instead of raising;
        # fail startup like the reference's net.Listen would
        # (server_impl.go:155-162) rather than serving nothing.
        raise OSError(f"failed to bind gRPC listener on {addr}")
    return server
