"""Process bootstrap: Settings -> backend -> service -> listeners.

Port of ratelimit_tpu/runner.py: a logging hook for crashed background
threads, stats, the local over-limit cache, the backend -- the CUDA
counter backend (``BACKEND_TYPE=cuda``, or ``cuda-sharded`` for
bank-sharded fixed-window tables), the write-behind backend
(``cuda-write-behind`` / ``cuda-sharded-write-behind``: decide on a host
view, commit to either table behind the RPC) or the host-only
``memory`` backend -- for ``cuda``: TPU_NUM_LANES fixed-window lanes
sharing TPU_NUM_SLOTS, the per-second bank (TPU_PERSECOND) and one
engine per algorithm named in ``TPU_ALGORITHM_BANKS``, checkpoint files
of every bank (TPU_CHECKPOINT_DIR: restored at boot, written every
TPU_CHECKPOINT_INTERVAL_S and at the end of the drain), the service with
its runtime config loader, the request tracer (TRACE_*), the three
listeners -- HTTP on HOST:PORT (/json, /healthcheck), gRPC on
GRPC_HOST:GRPC_PORT, debug on DEBUG_HOST:DEBUG_PORT (/stats, /metrics,
/rlconfig, /debug/*) -- and the statsd exporter (STATSD_SRV discovery
included), with the device fault domain of ``cuda`` and ``cuda-sharded``
armed by KERNEL_DEADLINE_S (0.25 s by default; the write-behind and
memory backends have none, as in the JAX package), and the observability
planes the JAX runner wires at its defaults: the decision flight
recorder (FLIGHT_RECORDER_SIZE), the launch recorder on every bank
dispatcher (LAUNCH_RECORDER_SIZE), the event journal
(EVENT_JOURNAL_SIZE), the per-domain SLO engine, the hot-key sketch
(HOTKEYS_TOP_K), the time-series store (TSDB_INTERVAL_S) and the anomaly
detectors with incident capture (ANOMALY_INTERVAL_S, INCIDENT_DIR); the
overload controller when an OVERLOAD_* setting asks for it (shedding in
the service, hot-key promotion in the CUDA cache, backpressure from the
detectors), and the replica's counter-handoff admin POSTs under
/debug/cluster with CLUSTER_HANDOFF_ENABLED.  Only a BACKEND_TYPE the
port does not serve is refused at boot (settings.unported_settings).

Run directly:  python -m ratelimit_tpu_torch.runner
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

from .config.runtime import RuntimeLoader
from .observability import (
    TRACER,
    AnomalyDetectors,
    ErrorRateDetector,
    JsonlExporter,
    LatencySpikeDetector,
    OverLimitSurgeDetector,
    QueueSaturationDetector,
    SloEngine,
    log_exporter,
    make_event_journal,
    make_flight_recorder,
    make_launch_recorder,
    make_timeseries,
    register_default_series,
)
from .service import RateLimitService
from .settings import Settings, SettingsError, new_settings, unported_settings
from .stats.manager import Manager
from .stats.statsd import StatsdExporter
from .utils.time import RealTimeSource

logger = logging.getLogger("ratelimit")

_LOG_LEVELS = {
    "TRACE": logging.DEBUG,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}


def lane_slot_split(total_slots: int, n_lanes: int) -> list:
    """Per-lane slot counts summing to `total_slots`: base = floor
    division, with the remainder distributed one slot each to the first
    lanes.  Every lane gets at least 1 slot (an empty engine table cannot
    serve), so for the degenerate total < n_lanes the sum exceeds the
    total rather than wedging a lane."""
    base, rem = divmod(max(0, int(total_slots)), n_lanes)
    return [max(1, base + (1 if i < rem else 0)) for i in range(n_lanes)]


def _make_engine(s: Settings, device="cuda", mesh=None, num_slots=None):
    """One construction site for a fixed-window engine of `num_slots`
    slots (TPU_NUM_SLOTS by default): one table on `device`, or, under
    ``BACKEND_TYPE=cuda-sharded`` and ``cuda-sharded-write-behind``, the
    bank-sharded table over `mesh`, whose home device (its first group's)
    must be `device`.  The default mesh is parallel.make_mesh(device=
    `device`): for plain "cuda" one bank per visible card, one group on
    each, as the JAX runner's mesh takes every local device; for a named
    card or the CPU one bank there."""
    if num_slots is None:
        num_slots = s.tpu_num_slots
    if s.backend_type.lower() in ("cuda-sharded", "cuda-sharded-write-behind"):
        from .models.fixed_window import resolve_device
        from .parallel import ShardedCounterEngine, make_mesh

        if mesh is None:
            mesh = make_mesh(device=device)
        elif mesh.device != resolve_device(device):
            raise ValueError(f"mesh is on {mesh.device} (its home device), runner on {device}")
        return ShardedCounterEngine(
            mesh,
            num_slots=num_slots,
            near_ratio=s.near_limit_ratio,
            buckets=tuple(s.tpu_batch_buckets),
        )
    from .backends.engine import CounterEngine

    return CounterEngine(
        num_slots=num_slots,
        near_ratio=s.near_limit_ratio,
        buckets=tuple(s.tpu_batch_buckets),
        device=device,
    )


def make_algorithm_banks(s: Settings, device="cuda"):
    """One generic engine per non-default algorithm named in
    TPU_ALGORITHM_BANKS (models/registry.py), each with a
    TPU_ALGORITHM_NUM_SLOTS table on `device`, or None when the list is
    empty.  An unknown name fails startup: a mistyped bank list must
    never serve without the kernel it asked for."""
    names = [p.strip() for p in s.tpu_algorithm_banks.split(",") if p.strip()]
    if not names:
        return None
    from .backends.engine import CounterEngine
    from .models.registry import DEFAULT_ALGORITHM, get_algorithm

    banks = {}
    for name in names:
        spec = get_algorithm(name)  # raises KeyError on typos
        if spec.name == DEFAULT_ALGORITHM:
            continue  # the lane IS the fixed-window bank
        banks[spec.name] = CounterEngine(
            near_ratio=s.near_limit_ratio,
            buckets=tuple(s.tpu_batch_buckets),
            device=device,
            model=spec.make_model(
                s.tpu_algorithm_num_slots, s.near_limit_ratio, device=device
            ),
        )
    return banks or None


def create_limiter(s: Settings, local_cache, time_source, device="cuda", mesh=None):
    """BackendType switch (reference runner.go:50-74).  `device` is
    where the counter tables live: the GPU unless the caller asks for
    the CPU (the tests do).  TPU_NUM_SLOTS is the total budget of the
    TPU_NUM_LANES lanes (lane_slot_split); the per-second bank has
    TPU_PERSECOND_NUM_SLOTS of its own.  `mesh` places the banks of
    ``BACKEND_TYPE=cuda-sharded``, where every lane and the per-second
    bank are bank-sharded tables over it; the algorithm banks stay
    single-table engines on `device`, as under the JAX package's
    ``tpu-sharded``.  ``memory`` needs no device, and the write-behind
    backends take one bank of TPU_NUM_SLOTS."""
    refused = unported_settings(s)
    if refused:
        raise SettingsError(
            "settings select a backend ratelimit_tpu_torch does not serve: "
            + "; ".join(refused)
        )
    backend = s.backend_type.lower()
    if backend == "memory":
        from .backends.memory_cache import MemoryRateLimitCache

        return MemoryRateLimitCache(
            time_source=time_source,
            local_cache=local_cache,
            near_ratio=s.near_limit_ratio,
            cache_key_prefix=s.cache_key_prefix,
            expiration_jitter_max_seconds=s.expiration_jitter_max_seconds,
        )
    write_behind = backend in ("cuda-write-behind", "cuda-sharded-write-behind")
    if write_behind and int(s.tpu_num_lanes) > 1:
        # Lanes exist only for the sync backends (the write-behind path
        # decides on the host view; its dispatcher never gates request
        # latency).  A silently ignored knob reads as "on".
        logger.warning(
            "TPU_NUM_LANES=%s is ignored by backend %r (lanes apply to "
            "cuda / cuda-sharded)",
            s.tpu_num_lanes,
            s.backend_type,
        )
    if write_behind:
        # The memcached-mode analog (backends/write_behind.py for the
        # envelope): one bank on either table, no fault domain, no
        # per-second or algorithm banks, as in the JAX package.
        from .backends.write_behind import WriteBehindRateLimitCache

        return WriteBehindRateLimitCache(
            _make_engine(s, device, mesh, s.tpu_num_slots),
            time_source=time_source,
            local_cache=local_cache,
            expiration_jitter_max_seconds=s.expiration_jitter_max_seconds,
            cache_key_prefix=s.cache_key_prefix,
            batch_window_us=s.tpu_batch_window_us,
            batch_limit=s.tpu_batch_limit,
            unhealthy_after=s.tpu_unhealthy_after,
            pipeline_depth=s.tpu_pipeline_depth,
        )
    from .backends.cuda_cache import CudaRateLimitCache

    n_lanes = max(1, int(s.tpu_num_lanes))
    lanes = [
        _make_engine(s, device, mesh, per_lane)
        for per_lane in lane_slot_split(s.tpu_num_slots, n_lanes)
    ]
    return CudaRateLimitCache(
        lanes if n_lanes > 1 else lanes[0],
        time_source=time_source,
        per_second_engine=(
            _make_engine(s, device, mesh, s.tpu_per_second_num_slots)
            if s.tpu_per_second
            else None
        ),
        local_cache=local_cache,
        expiration_jitter_max_seconds=s.expiration_jitter_max_seconds,
        cache_key_prefix=s.cache_key_prefix,
        batch_window_us=s.tpu_batch_window_us,
        batch_limit=s.tpu_batch_limit,
        dispatch_timeout_s=s.tpu_dispatch_timeout_s,
        pipeline_depth=s.tpu_pipeline_depth,
        unhealthy_after=s.tpu_unhealthy_after,
        resolution_cache_entries=s.resolution_cache_entries,
        algorithm_banks=make_algorithm_banks(s, device),
        # The device fault domain (backends/fault_domain.py), on by
        # default: a kernel stalled on the card quarantines its bank
        # within KERNEL_DEADLINE_S instead of stalling RPCs for the
        # dispatch timeout.
        kernel_deadline_s=s.kernel_deadline_s,
        device_failure_mode=s.device_failure_mode,
        fault_restart_backoff_s=s.device_restart_backoff_s,
        fault_snapshot_interval_s=s.tpu_checkpoint_interval_s,
        fault_interval_s=(
            s.device_watchdog_interval_s if s.device_watchdog_interval_s > 0 else None
        ),
        hotkeys_top_k=s.hotkeys_top_k,
    )


class Runner:
    def __init__(
        self,
        settings: Optional[Settings] = None,
        time_source=None,
        device="cuda",
        mesh=None,
    ):
        """`time_source` is the clock seam (tests pin it); `device`
        places the counter tables (default the GPU); `mesh`
        (parallel.make_mesh) places the banks of BACKEND_TYPE=cuda-sharded
        in groups, its first group on `device` (default: one bank per
        visible card for plain "cuda")."""
        self.settings = settings or new_settings()
        self.time_source = time_source or RealTimeSource()
        self.device = device
        self.mesh = mesh
        self.stats_manager = Manager(extra_tags=self.settings.extra_tags)
        self._stopped = threading.Event()
        self.cache = None
        self.service = None
        self.runtime = None
        self.grpc_server = None
        self.http_server = None
        self.debug_server = None
        self.statsd = None
        self.health = None
        self.checkpointer = None
        self._trace_jsonl = None
        self.flight = None
        self.launches = None
        self.events = None
        self.slo = None
        self.timeseries = None
        self.detectors = None
        self.overload = None

    def start(self) -> None:
        """Wire everything and start the listeners (non-blocking)."""
        s = self.settings
        logging.basicConfig(
            level=_LOG_LEVELS.get(s.log_level.upper(), logging.WARNING),
            format=(
                '{"@timestamp":"%(asctime)s","level":"%(levelname)s",'
                '"@message":"%(message)s"}'
                if s.log_format == "json"
                else "%(asctime)s %(levelname)s %(name)s %(message)s"
            ),
        )
        # A dispatcher or write-behind completer thread dying from an
        # uncaught exception must be logged, not vanish into stderr
        # (utils/threads.py).
        from .utils.threads import install_thread_excepthook

        install_thread_excepthook()

        from .server.grpc_server import create_grpc_server, server_credentials
        from .server.health import HealthChecker
        from .server.http_server import (
            HttpServer,
            add_debug_routes,
            add_healthcheck,
            add_json_handler,
        )

        # The process-wide tracer is configured here, once, from
        # Settings; the serving layers reference it like logging.
        TRACER.configure(
            sample_rate=s.trace_sample_rate,
            sample_errors=s.trace_sample_errors,
            enabled=s.trace_sample_rate > 0 or s.trace_sample_errors,
            ring_size=s.trace_ring_size,
            slow_size=s.trace_slow_size,
        )
        TRACER.clear_exporters()
        if s.trace_export_jsonl:
            self._trace_jsonl = JsonlExporter(s.trace_export_jsonl)
            TRACER.add_exporter(self._trace_jsonl)
        if s.trace_log:
            TRACER.add_exporter(log_exporter)

        local_cache = None
        if s.local_cache_size_in_bytes > 0:
            from .limiter.local_cache import LocalCache

            local_cache = LocalCache(s.local_cache_size_in_bytes)
            local_cache.register_stats(self.stats_manager.store)

        self.cache = create_limiter(
            s, local_cache, self.time_source, self.device, self.mesh
        )
        # Only the counter backends have stats, kernels to warm up,
        # banks to checkpoint and a dispatcher's health; memory has none.
        if hasattr(self.cache, "register_stats"):
            self.cache.register_stats(self.stats_manager.store)
        self._wire_planes(s, local_cache)
        if s.tpu_warmup and hasattr(self.cache, "warmup"):
            logger.warning("warming up kernel shapes (TPU_WARMUP=true)...")
            self.cache.warmup()

        if s.tpu_checkpoint_dir and hasattr(self.cache, "engines"):
            from .backends.checkpoint import CheckpointManager

            self.checkpointer = CheckpointManager(
                self.cache, s.tpu_checkpoint_dir, s.tpu_checkpoint_interval_s
            )
            self.checkpointer.restore()
            self.checkpointer.start()

        self.runtime = RuntimeLoader(
            s.runtime_path,
            s.runtime_subdirectory,
            ignore_dot_files=s.runtime_ignore_dot_files,
        )
        self.service = RateLimitService(
            self.runtime,
            self.cache,
            self.stats_manager,
            runtime_watch_root=s.runtime_watch_root,
            clock=self.time_source,
            global_shadow_mode=s.global_shadow_mode,
            headers_enabled=s.rate_limit_response_headers_enabled,
            header_limit=s.header_ratelimit_limit,
            header_remaining=s.header_ratelimit_remaining,
            header_reset=s.header_ratelimit_reset,
            # Re-read env-derived settings on every config reload, like
            # the reference's settings.NewSettings() in its reload path.
            settings_reloader=new_settings,
        )
        # SLO domains follow the config: attach the engine, then adopt
        # the already-loaded snapshot (construction above reloaded
        # before the attribute existed).
        self.service.slo = self.slo
        self.service.overload = self.overload
        self.service.events = self.events
        config = self.service.get_current_config()
        if config is not None:
            self.slo.set_domains(config.domains.keys())
            if self.overload is not None:
                self.overload.set_priorities(config.priorities)
        self.runtime.start()
        self._start_detectors(s)

        self.health = HealthChecker()
        if hasattr(self.cache, "bind_health"):
            self.cache.bind_health(self.health)

        credentials = None
        if bool(s.grpc_server_tls_cert) != bool(s.grpc_server_tls_key):
            # A half-configured pair must fail startup, never silently
            # serve rate-limit traffic in cleartext.
            raise ValueError(
                "GRPC_SERVER_TLS_CERT and GRPC_SERVER_TLS_KEY must be "
                "set together (got cert="
                f"{s.grpc_server_tls_cert!r}, key={s.grpc_server_tls_key!r})"
            )
        if s.grpc_server_tls_cert:
            credentials = server_credentials(
                s.grpc_server_tls_cert,
                s.grpc_server_tls_key,
                s.grpc_server_tls_ca,
            )
        self.grpc_server = create_grpc_server(
            self.service,
            self.health,
            store=self.stats_manager.store,
            host=s.grpc_host,
            port=s.grpc_port,
            max_connection_age_s=s.grpc_max_connection_age,
            max_connection_age_grace_s=s.grpc_max_connection_age_grace,
            max_workers=s.grpc_max_workers,
            credentials=credentials,
            auth_token=s.grpc_auth_token,
            flight=self.flight,
            slo=self.slo,
            corr_enabled=s.flight_corr_enabled,
        )
        self.grpc_server.start()

        self.http_server = HttpServer(s.host, s.port, name="api")
        add_json_handler(self.http_server, self.service, flight=self.flight, slo=self.slo)
        add_healthcheck(self.http_server, self.health)
        self.http_server.start()

        self.debug_server = HttpServer(s.debug_host, s.debug_port, name="debug")
        add_debug_routes(
            self.debug_server,
            self.stats_manager.store,
            self.service,
            profiling_enabled=s.debug_profiling,
            detectors=self.detectors,
            slo=self.slo,
            overload=self.overload,
            flight=self.flight,
            cluster_handoff_enabled=s.cluster_handoff_enabled,
            events=self.events,
            launches=self.launches,
            timeseries=self.timeseries,
        )
        add_healthcheck(self.debug_server, self.health)
        self.debug_server.start()

        if s.use_statsd:
            self.statsd = StatsdExporter(
                self.stats_manager.store,
                s.statsd_host,
                s.statsd_port,
                srv_record=s.statsd_srv,
                srv_refresh_s=s.statsd_srv_refresh_s,
            )
            self.statsd.start()

        if s.gc_tuning:
            # Move all startup allocation out of the gc's scan set so
            # serving-path collections stay small.
            import gc

            gc.collect()
            gc.freeze()

        engine = getattr(self.cache, "engine", None)
        logger.warning(
            "ratelimit serving: http=%s grpc=%s debug=%s backend=%s%s",
            self.http_server.bound_port,
            self.grpc_server.bound_port,
            self.debug_server.bound_port,
            s.backend_type,
            "" if engine is None else f" device={engine.device}",
        )

    def _wire_planes(self, s: Settings, local_cache) -> None:
        """The observability planes, wired as the JAX runner wires them
        (ratelimit_tpu/runner.py): the flight recorder on the backend's
        note seam, the launch recorder on every bank dispatcher and the
        fault domain's fallback (backends without dispatchers keep no
        route rather than an empty ring), the event journal on the
        backend and its fault domain, the SLO engine, the overload
        controller (only when an OVERLOAD_* setting asks for it: with
        every one off the serving path carries no controller at all),
        and the time-series store, whose series are registered here
        before its sampler starts."""
        store = self.stats_manager.store
        self.flight = make_flight_recorder(s.flight_recorder_size)
        if self.flight is not None:
            self.flight.register_stats(store)
            if hasattr(self.cache, "flight"):
                self.cache.flight = self.flight
        self.launches = make_launch_recorder(s.launch_recorder_size)
        if self.launches is not None:
            if hasattr(self.cache, "attach_launch_recorder"):
                self.cache.attach_launch_recorder(self.launches)
                self.launches.register_stats(store)
            else:
                self.launches = None
        self.events = make_event_journal(
            s.event_journal_size, jsonl_path=s.event_journal_jsonl
        )
        if self.events is not None:
            self.events.register_stats(store)
            if hasattr(self.cache, "events"):
                self.cache.events = self.events
            fd = getattr(self.cache, "fault_domain", None)
            if fd is not None:
                fd.events = self.events
        self.slo = SloEngine(
            self.stats_manager,
            target=s.slo_target,
            window_s=s.slo_window_s,
            latency_threshold_ms=s.slo_latency_ms,
        )
        if (
            s.overload_shed_enabled
            or s.overload_promote_enabled
            or s.overload_backpressure_enabled
        ):
            from .overload import OverloadController

            self.overload = OverloadController(
                slo=self.slo,
                hotkeys=getattr(self.cache, "hotkeys", None),
                shed_enabled=s.overload_shed_enabled,
                shed_burn_threshold=s.shed_burn_threshold,
                shed_clear_ratio=s.shed_clear_ratio,
                shed_min_requests=s.shed_min_requests,
                promote_enabled=s.overload_promote_enabled,
                promote_ttl_s=s.promote_ttl_s,
                promote_over_share=s.promote_over_share,
                promote_min_hits=s.promote_min_hits,
                promote_capacity=s.promote_capacity,
                backpressure_enabled=s.overload_backpressure_enabled,
                backpressure_tokens=s.backpressure_tokens,
                backpressure_max_wait_s=s.backpressure_max_wait_s,
                backpressure_hold_s=s.backpressure_hold_s,
            )
            self.overload.events = self.events
            self.overload.register_stats(store)
            if self.overload.promotion is not None and hasattr(self.cache, "promotion"):
                self.cache.promotion = self.overload.promotion
        self.timeseries = make_timeseries(s.tsdb_interval_s, s.tsdb_retention_s)
        if self.timeseries is not None:
            register_default_series(
                self.timeseries,
                store,
                cache=self.cache,
                launches=self.launches,
                overload=self.overload,
                local_cache=local_cache,
            )
            self.timeseries.register_stats(store)
            self.timeseries.start()

    def _start_detectors(self, s: Settings) -> None:
        """The anomaly detectors and incident capture: always built
        (/debug/incidents and the deterministic tick() work with the
        sampler off), the sampler thread only with ANOMALY_INTERVAL_S >
        0."""
        store = self.stats_manager.store
        self.detectors = AnomalyDetectors(
            store,
            [
                LatencySpikeDetector(
                    store.histogram("ratelimit_server.ShouldRateLimit.response_ms"),
                    factor=s.anomaly_spike_factor,
                    min_samples=s.anomaly_min_samples,
                ),
                OverLimitSurgeDetector(
                    self.slo,
                    factor=s.anomaly_spike_factor,
                    min_requests=s.anomaly_min_samples,
                ),
                QueueSaturationDetector(
                    getattr(self.cache, "queue_hwm_drain", lambda: 0),
                    threshold=s.anomaly_queue_depth,
                ),
                ErrorRateDetector(store),
            ],
            flight=self.flight,
            tracer=TRACER,
            slo=self.slo,
            incident_dir=s.incident_dir,
            incident_max=s.incident_max,
            interval_s=s.anomaly_interval_s,
            cooldown_s=s.anomaly_cooldown_s,
            overload=self.overload,
            events=self.events,
            timeseries=self.timeseries,
        )
        self.detectors.register_stats(store)
        self.detectors.start()

    def run(self) -> None:
        """start() + install signal handlers + block until stopped."""
        self.start()

        def handle(signum, frame):
            logger.warning("received signal %s, shutting down", signum)
            if self.health is not None:
                self.health.fail()
            self.stop()

        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
            signal.signal(sig, handle)
        self._stopped.wait()

    def stop(self) -> None:
        """Graceful drain + stop, in the reference's order: health
        NOT_SERVING, gRPC grace for in-flight RPCs, dispatcher drain,
        the final checkpoint of the drained counters (a restart then
        forgives no window), then the HTTP and debug listeners, the
        runtime loader, the anomaly and time-series samplers, statsd, the
        backend, the trace exporter and the event journal's file."""
        if self.health is not None:
            self.health.fail()
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=5).wait(timeout=10)
        if self.cache is not None:
            try:
                self.cache.flush()
            except Exception:
                logger.exception("dispatcher drain failed during shutdown")
        if self.checkpointer is not None:
            self.checkpointer.stop(final_checkpoint=True)
            self.checkpointer = None
        for srv in (self.http_server, self.debug_server):
            if srv is not None:
                srv.stop()
        if self.runtime is not None:
            self.runtime.stop()
        if self.detectors is not None:
            self.detectors.stop()
        if self.timeseries is not None:
            self.timeseries.stop()
        if self.statsd is not None:
            self.statsd.stop()
        if self.cache is not None and hasattr(self.cache, "close"):
            self.cache.close()
        if self._trace_jsonl is not None:
            TRACER.clear_exporters()
            self._trace_jsonl.close()
            self._trace_jsonl = None
        if self.events is not None:
            self.events.close()
        self._stopped.set()


def main() -> None:
    Runner().run()


if __name__ == "__main__":
    main()
