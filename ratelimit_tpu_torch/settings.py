"""Process configuration from environment variables.

Port of ratelimit_tpu/settings.py: the same env var names and
defaults, except BACKEND_TYPE, whose default here is ``cuda`` (the
counter engine on the GPU; the reference's ``tpu``) and the jax
compilation cache (TPU_COMPILE_CACHE_DIR), which has no counterpart.
Every observability plane's setting takes effect as in the reference
(FLIGHT_*, EVENT_JOURNAL_*, LAUNCH_RECORDER_SIZE, TSDB_*, ANOMALY_*,
INCIDENT_*, SLO_*, HOTKEYS_TOP_K), and so do overload control
(OVERLOAD_*, SHED_*, PROMOTE_*, BACKPRESSURE_*) and the replica's
counter handoff (CLUSTER_HANDOFF_ENABLED).  Only a BACKEND_TYPE the
port does not serve is refused at boot (:func:`unported_settings`).

Mirrors the reference's envconfig-driven Settings struct
(reference src/settings/settings.go:11-119): same env var names and
defaults for everything that carries over, plus the TPU-engine knobs
that replace the Redis/Memcache connection settings (the reference's
Redis knobs configure a TCP client; ours configure the on-chip counter
engine and its micro-batching dispatcher).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise SettingsError(f"{name}: invalid integer {raw!r}") from e


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise SettingsError(f"{name}: invalid float {raw!r}") from e


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    low = raw.strip().lower()
    if low in ("1", "true", "t", "yes", "y", "on"):
        return True
    if low in ("0", "false", "f", "no", "n", "off"):
        return False
    raise SettingsError(f"{name}: invalid boolean {raw!r}")


def _env_tags(name: str) -> Dict[str, str]:
    """EXTRA_TAGS-style map: "k1:v1,k2:v2" (envconfig map syntax)."""
    raw = os.environ.get(name, "")
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise SettingsError(f"{name}: invalid map entry {part!r}")
        k, v = part.split(":", 1)
        out[k.strip()] = v.strip()
    return out


def _env_int_list(name: str, default: List[int]) -> List[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return list(default)
    try:
        return [int(p) for p in raw.split(",") if p.strip()]
    except ValueError as e:
        raise SettingsError(f"{name}: invalid int list {raw!r}") from e


class SettingsError(Exception):
    """Invalid environment configuration (envconfig.Process panics in
    the reference, settings.go:110-119)."""


@dataclass
class Settings:
    # Server listen addresses (settings.go:15-20).
    host: str = "0.0.0.0"
    port: int = 8080
    grpc_host: str = "0.0.0.0"
    grpc_port: int = 8081
    debug_host: str = "0.0.0.0"
    debug_port: int = 6070

    # gRPC keepalive (settings.go:25-27); seconds.
    grpc_max_connection_age: float = 24 * 3600.0
    grpc_max_connection_age_grace: float = 3600.0
    # RPC handler thread pool size (the goroutine-per-RPC analog is a
    # bounded pool here).  Size it ~2x concurrent in-flight RPCs; each
    # waiting handler parks on an event, so threads are cheap but not
    # free (GIL wakeups).
    grpc_max_workers: int = 32

    # Transport security + auth for the serving surface — the analog
    # of the reference's Redis TLS + AUTH knobs (settings.go:62-92,
    # dial opts driver_impl.go:70-88): here the trust boundary is the
    # gRPC listener itself (clients/proxy -> replica).  Empty = plain
    # TCP (the default, like the reference's REDIS_TLS=false).
    # GRPC_SERVER_TLS_CERT/KEY enable TLS; GRPC_SERVER_TLS_CA
    # additionally REQUIRES verified client certificates (mTLS).
    # GRPC_AUTH_TOKEN requires `authorization: Bearer <token>`
    # metadata on every RateLimitService RPC (grpc.health.v1 stays
    # open so load balancers can probe).
    grpc_server_tls_cert: str = ""
    grpc_server_tls_key: str = ""
    grpc_server_tls_ca: str = ""
    grpc_auth_token: str = ""

    # CPython gc tuning for the serving process: after startup, freeze
    # every live object out of the collector's scan set, so the
    # stop-the-world collections that DO run (straight into
    # ShouldRateLimit p99 on a small box) scan only recent
    # allocations, not the engines/kernels/config graph.  Thresholds
    # are left at interpreter defaults — raising them was measured to
    # WORSEN p99 (rarer but longer pauses).  The reference never faces
    # this: Go's GC is concurrent.  GC_TUNING=false disables.
    gc_tuning: bool = True

    # Logging (settings.go:30-31).
    log_level: str = "WARN"
    log_format: str = "text"

    # Stats sink (settings.go:34-37).
    use_statsd: bool = True
    statsd_host: str = "localhost"
    statsd_port: int = 8125
    # SRV-based statsd discovery (the reference's MEMCACHE_SRV pattern,
    # src/memcached/cache_impl.go:180-228, applied to the stats sink):
    # "_statsd._udp.name" overrides host/port; refresh 0 = resolve once.
    statsd_srv: str = ""
    statsd_srv_refresh_s: float = 0.0
    extra_tags: Dict[str, str] = field(default_factory=dict)

    # Rate limit config runtime (settings.go:40-43).
    runtime_path: str = "/srv/runtime_data/current"
    runtime_subdirectory: str = ""
    runtime_ignore_dot_files: bool = False
    runtime_watch_root: bool = True

    # Cache-wide knobs (settings.go:46-50).
    expiration_jitter_max_seconds: int = 300
    local_cache_size_in_bytes: int = 0
    near_limit_ratio: float = 0.8
    cache_key_prefix: str = ""
    # reference default "redis"; the JAX package's "tpu"; here "cuda"
    # (one counter table), "cuda-sharded" (the bank-sharded table, the
    # counterpart of "tpu-sharded"), "cuda-write-behind" and
    # "cuda-sharded-write-behind" (decide on the host, commit to either
    # table behind the RPC: the memcached analog) or "memory" (the
    # exact host-only backend).
    backend_type: str = "cuda"

    # Custom response headers (settings.go:53-59).
    rate_limit_response_headers_enabled: bool = False
    header_ratelimit_limit: str = "RateLimit-Limit"
    header_ratelimit_remaining: str = "RateLimit-Remaining"
    header_ratelimit_reset: str = "RateLimit-Reset"

    # TPU counter-engine knobs (replace the Redis connection settings,
    # settings.go:62-92; the dual per-second engine mirrors
    # REDIS_PERSECOND's second instance).
    tpu_num_slots: int = 1 << 20
    # Independent host serving lanes: the keyspace hash-splits across
    # N (slot table + dispatcher + device stream) triples so the
    # serial collector/completer legs run on N cores (the in-process
    # mirror of the cluster tier's rendezvous split; the concurrency
    # the reference gets from goroutine-per-RPC + Redis pipelining,
    # driver_impl.go:94-99).  TPU_NUM_SLOTS is the TOTAL across lanes.
    # See docs/HOST_LANES.md.
    tpu_num_lanes: int = 1
    tpu_per_second: bool = False
    tpu_per_second_num_slots: int = 1 << 20
    tpu_batch_buckets: List[int] = field(
        default_factory=lambda: [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
    )
    # Descriptor-resolution cache capacity (limiter/resolution.py):
    # interned (domain, entries) -> rule + key stem + lane route +
    # packed-lane template, invalidated by config generation.  Clear-
    # on-full past this bound; 0 disables the fast path entirely.
    resolution_cache_entries: int = 1 << 16
    # Micro-batch dispatcher (the implicit-pipelining analog,
    # settings.go:71-77; radix defaults to a 150us window).
    tpu_batch_window_us: int = 200
    tpu_batch_limit: int = 4096
    # Liveness backstop for RPCs waiting on the dispatcher; generous
    # default because first-batch XLA compilation can take tens of
    # seconds on large meshes (see CudaRateLimitCache.warmup).
    tpu_dispatch_timeout_s: float = 120.0
    # Device launches in flight ahead of the completer (readback of
    # batch N overlaps collection+launch of batch N+1).
    tpu_pipeline_depth: int = 2
    # Flip /healthcheck + grpc.health.v1 to NOT_SERVING after this many
    # CONSECUTIVE device-step failures (0 disables; dispatcher-thread
    # death always flips).  The REDIS_HEALTH_CHECK_ACTIVE_CONNECTION
    # analog (reference settings.go:91-92).
    tpu_unhealthy_after: int = 3
    # Pre-compile every (bucket, dtype) kernel shape at startup.
    tpu_warmup: bool = False
    # Device-path fault domain (backends/fault_domain.py).
    # KERNEL_DEADLINE_S bounds every device wait once a bank has
    # completed its first launch (a first launch may build the kernels
    # with nvcc and keeps the dispatch timeout): a call stuck past it
    # trips the watchdog, quarantines the bank, and re-routes its lanes
    # per DEVICE_FAILURE_MODE -- `host` (default) serves them from a
    # numpy mirror that keeps counting, `allow`/`deny` answer
    # statically.  0 disables the fault domain (a stalled kernel then
    # holds its RPCs for the dispatch timeout).  The supervisor retries
    # a quarantined bank's warm restart every DEVICE_RESTART_BACKOFF_S
    # (doubling, capped 60 s); in-memory snapshots every
    # TPU_CHECKPOINT_INTERVAL_S seed the mirror and bound restart loss
    # to one interval.
    kernel_deadline_s: float = 0.25
    device_failure_mode: str = "host"
    device_restart_backoff_s: float = 2.0
    # Watchdog cadence; 0 = auto (half the kernel deadline, capped 1s).
    device_watchdog_interval_s: float = 0.0
    # Counter-state checkpoint files (empty = disabled): restored at
    # boot, written every TPU_CHECKPOINT_INTERVAL_S and at the end of the
    # drain.  TPU_CHECKPOINT_INTERVAL_S is also the fault domain's
    # snapshot cadence.
    tpu_checkpoint_dir: str = ""
    tpu_checkpoint_interval_s: float = 30.0

    # Pluggable limiter-algorithm banks (models/registry.py;
    # docs/ALGORITHMS.md): comma list of non-default algorithms to
    # build dedicated engine banks for.  Rules carrying `algorithm:
    # <name>` route here (as candidate under `shadow: true`, as the
    # enforcing bank otherwise); rules naming an algorithm with no
    # bank fall back to fixed-window enforcement with a logged
    # warning.  "" disables all algorithm banks.  Banks are
    # single-chip engines even under tpu-sharded (per-slot state is
    # small: 12 B/slot sliding-window, 8 B/slot GCRA).
    tpu_algorithm_banks: str = "sliding_window,gcra"
    tpu_algorithm_num_slots: int = 1 << 18

    # Hot-key tracking (observability/hotkeys.py): capacity of the
    # Space-Saving top-K sketch over descriptor stems, exposed as
    # GET /debug/hotkeys + the bounded ratelimit.tpu.hotkeys.* metric
    # family.  0 disables (and the hot path pays nothing).  Only the
    # tpu / tpu-sharded backends (the resolution fast path) feed it.
    hotkeys_top_k: int = 128
    # On-demand capture endpoints (/debug/profile statistical CPU
    # profile, /debug/xla_trace torch.profiler capture) are disabled
    # unless this is set: both sample/trace the LIVE serving process,
    # which is an operator action, not a default-open surface.
    debug_profiling: bool = False

    # Decision flight recorder (observability/flight.py): slots in the
    # lock-free per-request decision ring the anomaly detectors
    # snapshot into incident reports.  0 disables recording entirely
    # (the serving path pays one attribute load + branch).
    flight_recorder_size: int = 4096
    # Cross-hop correlation intake (observability/flight.py): adopt
    # the x-ratelimit-corr metadata the cluster proxy mints and stamp
    # it into this replica's flight records + trace spans, so one id
    # joins the proxy ring, this ring and the span tree.  Off by
    # default — the intake adds a metadata-scan branch per request.
    flight_corr_enabled: bool = False
    # Lifecycle event journal (observability/events.py): ring slots
    # for the typed transition timeline (bank quarantine/restart,
    # handoff export/import, shed floor, backpressure, config reload,
    # incident captures) served at /debug/events and folded into
    # incident JSON.  Emission is transition-only (zero per-request
    # cost); 0 disables the journal entirely.
    event_journal_size: int = 1024
    # Optional JSONL mirror of every journal event (append-only; the
    # incident-dir analog for the timeline).  Empty disables.
    event_journal_jsonl: str = ""
    # Launch flight recorder (observability/launches.py): slots in the
    # per-LAUNCH device-batch ring served at /debug/launches.  0
    # disables recording entirely (the dispatch path pays one
    # attribute load + branch per launch).
    launch_recorder_size: int = 1024
    # In-process time-series store (observability/timeseries.py):
    # sampler cadence and history depth behind /debug/timeseries and
    # the /fleet.json sparkline summaries.  TSDB_INTERVAL_S=0 disables
    # the store entirely (no sampler thread, no history).
    tsdb_interval_s: float = 5.0
    tsdb_retention_s: float = 3600.0
    # Anomaly detectors (observability/detectors.py): sampler cadence;
    # 0 disables the sampler thread (and incident capture).  The
    # shared knobs below tune the EWMA-baselined triggers — see
    # docs/INCIDENT_RUNBOOK.md for what to turn when a detector is too
    # chatty or too quiet.
    anomaly_interval_s: float = 5.0
    # Spike multiplier over the EWMA baseline (latency p99 and
    # per-domain OVER_LIMIT-rate triggers).
    anomaly_spike_factor: float = 4.0
    # Minimum events per tick before a rate/quantile trigger may trip
    # (starves one-request noise).
    anomaly_min_samples: int = 20
    # Absolute dispatcher intake depth (per tick high-water) that
    # counts as saturation.
    anomaly_queue_depth: int = 512
    # Seconds between captures of the SAME detector (one incident per
    # episode, not per tick).
    anomaly_cooldown_s: float = 60.0
    # Incident reports: on-disk mirror directory ("" keeps them
    # in-memory only, served at /debug/incidents) and the retention
    # cap applied to both the memory ring and the directory.
    incident_dir: str = ""
    incident_max: int = 16
    # Per-domain SLO engine (observability/slo.py): availability /
    # latency SLI target, rolling window, and the latency threshold a
    # request must beat to count as "fast".
    slo_target: float = 0.999
    slo_window_s: float = 3600.0
    slo_latency_ms: float = 50.0

    # Overload control (overload/controller.py; docs/OBSERVABILITY.md
    # "Overload control").  ALL THREE controllers are off by default:
    # with every OVERLOAD_* knob at its default the runner builds no
    # controller and decisions are byte-identical to a build without
    # the layer.  Ticks ride the anomaly sampler, so acting (not just
    # sensing) needs ANOMALY_INTERVAL_S > 0.
    #
    # SLO-burn load shedding: when the EWMA-smoothed per-tick error-
    # budget burn of the still-admitted traffic exceeds
    # SHED_BURN_THRESHOLD, the shed floor rises one configured
    # priority level per tick (domains below the floor answer
    # OVER_LIMIT with no backend work; `priority:` in the limit YAML,
    # unconfigured domains shed first); it steps back down once burn
    # falls below threshold * SHED_CLEAR_RATIO (hysteresis).
    overload_shed_enabled: bool = False
    shed_burn_threshold: float = 14.4
    shed_clear_ratio: float = 0.5
    shed_min_requests: int = 20
    # Hot-key promotion: stems whose per-tick over-limit share (from
    # the hot-key sketch; needs HOTKEYS_TOP_K > 0) reaches
    # PROMOTE_OVER_SHARE across at least PROMOTE_MIN_HITS hits get a
    # PROMOTE_TTL_S host-side OVER_LIMIT decision and skip the device.
    overload_promote_enabled: bool = False
    promote_ttl_s: float = 2.0
    promote_over_share: float = 0.5
    promote_min_hits: int = 64
    promote_capacity: int = 1024
    # Detector-triggered backpressure: queue-saturation/latency-spike
    # trips gate admission behind BACKPRESSURE_TOKENS concurrent
    # permits; a request waits up to BACKPRESSURE_MAX_WAIT_S for one,
    # then sheds.  Repeat trips halve the tokens (ratchet); the gate
    # releases BACKPRESSURE_HOLD_S after the last trip.
    overload_backpressure_enabled: bool = False
    backpressure_tokens: int = 64
    backpressure_max_wait_s: float = 0.05
    backpressure_hold_s: float = 30.0

    # Request tracing (observability/trace.py; docs/OBSERVABILITY.md).
    # Head-sampling probability for traces with no inbound traceparent
    # (an inbound sampled flag always wins); 0.0 = only errors and
    # over-limit decisions are kept (when trace_sample_errors).
    trace_sample_rate: float = 0.0
    # Always commit traces that end in an error or OVER_LIMIT, even
    # when the head decision said no.  False + rate 0.0 disables
    # recording entirely (the NOOP_SPAN fast path).
    trace_sample_errors: bool = True
    # Bounded in-memory rings backing GET /debug/tracez.
    trace_ring_size: int = 256
    trace_slow_size: int = 32
    # Exporters: append committed traces as JSON lines to this path
    # (empty = off); log one INFO line per committed trace.
    trace_export_jsonl: str = ""
    trace_log: bool = False

    # Cluster tier (cluster/; docs/MULTI_REPLICA.md).
    # CLUSTER_HANDOFF_ENABLED opens the replica's counter-handoff
    # admin surface on the DEBUG listener (POST /debug/cluster/export
    # + /debug/cluster/import): the proxy's membership-change
    # coordinator exports the key ranges a replica no longer owns and
    # imports them into the new owner, so moved counters never reset.
    # Off by default — the import endpoint WRITES counter state, so
    # like /debug/profile it is an operator opt-in, and the debug
    # listener must stay on a management interface.
    cluster_handoff_enabled: bool = False
    # CLUSTER_FAILURE_MODE is consumed by the PROXY process
    # (cluster/proxy.py --failure-mode default): what descriptors get
    # when no live replica can serve them — allow | deny |
    # local-cache (deny only keys recently over limit, the
    # reference's FAILURE_MODE_DENY + freecache over-limit cache
    # semantics).  Declared here so the cluster env surface is
    # documented in one place.
    cluster_failure_mode: str = "allow"

    # Global shadow mode (settings.go:105).
    global_shadow_mode: bool = False


def new_settings() -> Settings:
    """Read Settings from the environment (settings.go:110-119)."""
    s = Settings(
        host=_env_str("HOST", "0.0.0.0"),
        port=_env_int("PORT", 8080),
        grpc_host=_env_str("GRPC_HOST", "0.0.0.0"),
        grpc_port=_env_int("GRPC_PORT", 8081),
        debug_host=_env_str("DEBUG_HOST", "0.0.0.0"),
        debug_port=_env_int("DEBUG_PORT", 6070),
        grpc_max_connection_age=_env_float("GRPC_MAX_CONNECTION_AGE", 24 * 3600.0),
        grpc_max_connection_age_grace=_env_float(
            "GRPC_MAX_CONNECTION_AGE_GRACE", 3600.0
        ),
        log_level=_env_str("LOG_LEVEL", "WARN"),
        log_format=_env_str("LOG_FORMAT", "text"),
        use_statsd=_env_bool("USE_STATSD", True),
        statsd_host=_env_str("STATSD_HOST", "localhost"),
        statsd_port=_env_int("STATSD_PORT", 8125),
        statsd_srv=_env_str("STATSD_SRV", ""),
        statsd_srv_refresh_s=_env_float("STATSD_SRV_REFRESH_S", 0.0),
        extra_tags=_env_tags("EXTRA_TAGS"),
        runtime_path=_env_str("RUNTIME_ROOT", "/srv/runtime_data/current"),
        runtime_subdirectory=_env_str("RUNTIME_SUBDIRECTORY", ""),
        runtime_ignore_dot_files=_env_bool("RUNTIME_IGNOREDOTFILES", False),
        runtime_watch_root=_env_bool("RUNTIME_WATCH_ROOT", True),
        expiration_jitter_max_seconds=_env_int("EXPIRATION_JITTER_MAX_SECONDS", 300),
        local_cache_size_in_bytes=_env_int("LOCAL_CACHE_SIZE_IN_BYTES", 0),
        near_limit_ratio=_env_float("NEAR_LIMIT_RATIO", 0.8),
        cache_key_prefix=_env_str("CACHE_KEY_PREFIX", ""),
        backend_type=_env_str("BACKEND_TYPE", "cuda"),
        rate_limit_response_headers_enabled=_env_bool(
            "LIMIT_RESPONSE_HEADERS_ENABLED", False
        ),
        header_ratelimit_limit=_env_str("LIMIT_LIMIT_HEADER", "RateLimit-Limit"),
        header_ratelimit_remaining=_env_str(
            "LIMIT_REMAINING_HEADER", "RateLimit-Remaining"
        ),
        header_ratelimit_reset=_env_str("LIMIT_RESET_HEADER", "RateLimit-Reset"),
        grpc_max_workers=_env_int("GRPC_MAX_WORKERS", 32),
        grpc_server_tls_cert=_env_str("GRPC_SERVER_TLS_CERT", ""),
        grpc_server_tls_key=_env_str("GRPC_SERVER_TLS_KEY", ""),
        grpc_server_tls_ca=_env_str("GRPC_SERVER_TLS_CA", ""),
        grpc_auth_token=_env_str("GRPC_AUTH_TOKEN", ""),
        gc_tuning=_env_bool("GC_TUNING", True),
        tpu_num_slots=_env_int("TPU_NUM_SLOTS", 1 << 20),
        tpu_num_lanes=_env_int("TPU_NUM_LANES", 1),
        tpu_per_second=_env_bool("TPU_PERSECOND", False),
        tpu_per_second_num_slots=_env_int("TPU_PERSECOND_NUM_SLOTS", 1 << 20),
        tpu_batch_buckets=_env_int_list(
            "TPU_BATCH_BUCKETS", [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
        ),
        resolution_cache_entries=_env_int("RESOLUTION_CACHE_ENTRIES", 1 << 16),
        tpu_batch_window_us=_env_int("TPU_BATCH_WINDOW_US", 200),
        tpu_batch_limit=_env_int("TPU_BATCH_LIMIT", 4096),
        tpu_dispatch_timeout_s=_env_float("TPU_DISPATCH_TIMEOUT_S", 120.0),
        tpu_pipeline_depth=_env_int("TPU_PIPELINE_DEPTH", 2),
        tpu_unhealthy_after=_env_int("TPU_UNHEALTHY_AFTER", 3),
        tpu_warmup=_env_bool("TPU_WARMUP", False),
        kernel_deadline_s=_env_float("KERNEL_DEADLINE_S", 0.25),
        device_failure_mode=_env_str("DEVICE_FAILURE_MODE", "host"),
        device_restart_backoff_s=_env_float("DEVICE_RESTART_BACKOFF_S", 2.0),
        device_watchdog_interval_s=_env_float(
            "DEVICE_WATCHDOG_INTERVAL_S", 0.0
        ),
        tpu_checkpoint_dir=_env_str("TPU_CHECKPOINT_DIR", ""),
        tpu_checkpoint_interval_s=_env_float("TPU_CHECKPOINT_INTERVAL_S", 30.0),
        tpu_algorithm_banks=_env_str(
            "TPU_ALGORITHM_BANKS", "sliding_window,gcra"
        ),
        tpu_algorithm_num_slots=_env_int("TPU_ALGORITHM_NUM_SLOTS", 1 << 18),
        hotkeys_top_k=_env_int("HOTKEYS_TOP_K", 128),
        debug_profiling=_env_bool("DEBUG_PROFILING", False),
        flight_recorder_size=_env_int("FLIGHT_RECORDER_SIZE", 4096),
        flight_corr_enabled=_env_bool("FLIGHT_CORR_ENABLED", False),
        event_journal_size=_env_int("EVENT_JOURNAL_SIZE", 1024),
        event_journal_jsonl=_env_str("EVENT_JOURNAL_JSONL", ""),
        launch_recorder_size=_env_int("LAUNCH_RECORDER_SIZE", 1024),
        tsdb_interval_s=_env_float("TSDB_INTERVAL_S", 5.0),
        tsdb_retention_s=_env_float("TSDB_RETENTION_S", 3600.0),
        anomaly_interval_s=_env_float("ANOMALY_INTERVAL_S", 5.0),
        anomaly_spike_factor=_env_float("ANOMALY_SPIKE_FACTOR", 4.0),
        anomaly_min_samples=_env_int("ANOMALY_MIN_SAMPLES", 20),
        anomaly_queue_depth=_env_int("ANOMALY_QUEUE_DEPTH", 512),
        anomaly_cooldown_s=_env_float("ANOMALY_COOLDOWN_S", 60.0),
        incident_dir=_env_str("INCIDENT_DIR", ""),
        incident_max=_env_int("INCIDENT_MAX", 16),
        slo_target=_env_float("SLO_TARGET", 0.999),
        slo_window_s=_env_float("SLO_WINDOW_S", 3600.0),
        slo_latency_ms=_env_float("SLO_LATENCY_MS", 50.0),
        overload_shed_enabled=_env_bool("OVERLOAD_SHED_ENABLED", False),
        shed_burn_threshold=_env_float("SHED_BURN_THRESHOLD", 14.4),
        shed_clear_ratio=_env_float("SHED_CLEAR_RATIO", 0.5),
        shed_min_requests=_env_int("SHED_MIN_REQUESTS", 20),
        overload_promote_enabled=_env_bool("OVERLOAD_PROMOTE_ENABLED", False),
        promote_ttl_s=_env_float("PROMOTE_TTL_S", 2.0),
        promote_over_share=_env_float("PROMOTE_OVER_SHARE", 0.5),
        promote_min_hits=_env_int("PROMOTE_MIN_HITS", 64),
        promote_capacity=_env_int("PROMOTE_CAPACITY", 1024),
        overload_backpressure_enabled=_env_bool(
            "OVERLOAD_BACKPRESSURE_ENABLED", False
        ),
        backpressure_tokens=_env_int("BACKPRESSURE_TOKENS", 64),
        backpressure_max_wait_s=_env_float("BACKPRESSURE_MAX_WAIT_S", 0.05),
        backpressure_hold_s=_env_float("BACKPRESSURE_HOLD_S", 30.0),
        trace_sample_rate=_env_float("TRACE_SAMPLE_RATE", 0.0),
        trace_sample_errors=_env_bool("TRACE_SAMPLE_ERRORS", True),
        trace_ring_size=_env_int("TRACE_RING_SIZE", 256),
        trace_slow_size=_env_int("TRACE_SLOW_SIZE", 32),
        trace_export_jsonl=_env_str("TRACE_EXPORT_JSONL", ""),
        trace_log=_env_bool("TRACE_LOG", False),
        cluster_handoff_enabled=_env_bool("CLUSTER_HANDOFF_ENABLED", False),
        cluster_failure_mode=_env_str("CLUSTER_FAILURE_MODE", "allow"),
        global_shadow_mode=_env_bool("SHADOW_MODE", False),
    )
    return s


#: Every BACKEND_TYPE the port serves: the JAX package's five under the
#: port's names ("tpu" -> "cuda").
BACKEND_TYPES = (
    "cuda",
    "cuda-sharded",
    "cuda-write-behind",
    "cuda-sharded-write-behind",
    "memory",
)


def unported_settings(s: Settings) -> List[str]:
    """One message per setting the port cannot serve: a BACKEND_TYPE it
    does not know (the JAX package's names among them).  The runner
    refuses to boot when there is any."""
    out = []
    if s.backend_type.lower() not in BACKEND_TYPES:
        out.append(
            f"BACKEND_TYPE={s.backend_type!r}: not a backend of this package "
            f"(one of {', '.join(BACKEND_TYPES)})"
        )
    return out
