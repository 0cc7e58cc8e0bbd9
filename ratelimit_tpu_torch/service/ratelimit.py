"""The RPC brain: ShouldRateLimit request handling.

Port of ratelimit_tpu/service/ratelimit.py with its tracing spans
(``service.should_rate_limit`` around the request, ``backend.do_limit``
around the backend leg), the SLO engine's domain set, the event
journal's ``config_reload`` and the overload controller's admission
hook (overload/controller.py): a shed request is answered before any
backend work, and a request admitted through the backpressure gate
gives its permit back when the backend leg ends.

Python restatement of reference src/service/ratelimit.go: config
snapshot + per-descriptor lookup (:104-146), unlimited short-circuit
(:140-144, :178-182), aggregate OverallCode = logical OR (:185-190),
custom RateLimit-* headers tracking the min-remaining descriptor
(:165-201, :213-237), global shadow mode (:204-207), hot reload with
keep-old-config-on-error (:49-90), and typed error handling at the
boundary (:239-265 — the reference uses panic/recover; here exceptions
carry the same routing: CacheError -> redis_error stat, ServiceError ->
service_error stat, anything else propagates).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

from ..api import (
    MAX_UINT32,
    Code,
    DescriptorStatus,
    HeaderValue,
    RateLimitRequest,
    RateLimitResponse,
)
from ..config.loader import ConfigError, ConfigFile, RateLimitConfig, load_config
from ..observability import TRACER
from ..stats.manager import Manager
from ..utils.time import RealTimeSource, TimeSource, calculate_reset

logger = logging.getLogger("ratelimit")


class ServiceError(Exception):
    """Invalid request or unloaded config (serviceError,
    ratelimit.go:92-101)."""


class CacheError(Exception):
    """Counter backend failure (RedisError analog,
    reference src/redis/driver_impl.go:54-64)."""


class RateLimitService:
    # Per-domain SLO engine (observability/slo.py), attached by the
    # runner after construction; reload_config feeds it the configured
    # domain set so per-domain metric families stay bounded by config.
    slo = None
    # Lifecycle event journal (observability/events.py), attached by the
    # runner: every adopted config generation lands on the timeline.
    events = None
    # Overload controller (overload/controller.py), attached by the
    # runner when an OVERLOAD_* setting is on; reload_config feeds it
    # the configured priorities.
    overload = None

    def __init__(
        self,
        runtime,
        cache,
        stats_manager: Manager,
        runtime_watch_root: bool = True,
        clock: Optional[TimeSource] = None,
        global_shadow_mode: bool = False,
        headers_enabled: bool = False,
        header_limit: str = "RateLimit-Limit",
        header_remaining: str = "RateLimit-Remaining",
        header_reset: str = "RateLimit-Reset",
        settings_reloader: Optional[Callable[[], object]] = None,
    ):
        """`runtime` provides snapshot()/add_update_callback(fn)
        (config.runtime.RuntimeLoader); `cache` is the RateLimitCache
        seam.  `settings_reloader`, when given, is called on every
        config reload to re-read shadow/header settings (the reference
        re-runs settings.NewSettings() inside reloadConfig,
        ratelimit.go:77-89)."""
        self.runtime = runtime
        self.cache = cache
        self.stats_manager = stats_manager
        self.stats = stats_manager.service_stats()
        self.runtime_watch_root = runtime_watch_root
        self.clock = clock or RealTimeSource()
        self.global_shadow_mode = global_shadow_mode
        self.headers_enabled = headers_enabled
        self.header_limit = header_limit
        self.header_remaining = header_remaining
        self.header_reset = header_reset
        self._settings_reloader = settings_reloader

        self._config: Optional[RateLimitConfig] = None
        # Writers only: the hot path reads `self._config` as a plain
        # attribute load (atomic under CPython; the whole config is one
        # immutable object swapped at reload), so no per-RPC lock tax.
        self._config_lock = threading.RLock()
        # Descriptor-resolution fast path (limiter/resolution.py): the
        # backend owns the cache when it supports it (cuda_cache builds
        # one); other backends fall back to the uncached get_limit +
        # key-generator path.
        self._resolver = getattr(cache, "resolver", None)

        runtime.add_update_callback(self._on_runtime_update)
        self.reload_config()

    # -- config lifecycle (ratelimit.go:49-90, 295-306) -----------------

    def _on_runtime_update(self) -> None:
        logger.debug("got runtime update and reloading config")
        self.reload_config()

    def reload_config(self) -> None:
        try:
            files: List[ConfigFile] = []
            snapshot = self.runtime.snapshot()
            for key in snapshot.keys():
                if self.runtime_watch_root and not key.startswith("config."):
                    continue
                files.append(ConfigFile(key, snapshot.get(key)))
            new_config = load_config(files, self.stats_manager)
        except ConfigError as e:
            # Bad config NEVER evicts the old one (ratelimit.go:50-60).
            self.stats.config_load_error.inc()
            logger.error("error loading new configuration from runtime: %s", e)
            return
        self.stats.config_load_success.inc()
        if self.slo is not None:
            # Adopt the new configured domain set BEFORE the swap so a
            # request racing the reload finds its domain interned.
            self.slo.set_domains(new_config.domains.keys())
        if self.overload is not None:
            # Same ordering contract for the shed-priority ladder.
            self.overload.set_priorities(new_config.priorities)
        if self.events is not None:
            self.events.emit(
                "config_reload",
                generation=new_config.generation,
                domains=len(new_config.domains),
            )
        with self._config_lock:
            self._config = new_config
            if self._settings_reloader is not None:
                s = self._settings_reloader()
                self.global_shadow_mode = s.global_shadow_mode
                if s.rate_limit_response_headers_enabled:
                    self.headers_enabled = True
                    self.header_limit = s.header_ratelimit_limit
                    self.header_remaining = s.header_ratelimit_remaining
                    self.header_reset = s.header_ratelimit_reset

    def get_current_config(self) -> Optional[RateLimitConfig]:
        with self._config_lock:
            return self._config

    # -- request path ----------------------------------------------------

    def _construct_limits_to_check(self, request: RateLimitRequest):
        """Per-descriptor rule lookup + unlimited extraction
        (ratelimit.go:104-146).  The legacy path; with a resolution
        cache attached the whole leg fuses into the backend's
        do_limit_resolved instead (one dict hit per descriptor)."""
        # Plain attribute read — no lock (see __init__).
        config = self._config
        if config is None:
            raise ServiceError("no rate limit configuration loaded")

        limits = []
        is_unlimited = []
        for descriptor in request.descriptors:
            rule = config.get_limit(request.domain, descriptor)
            if rule is not None and rule.unlimited:
                is_unlimited.append(True)
                limits.append(None)
            else:
                is_unlimited.append(False)
                limits.append(rule)
        return limits, is_unlimited

    def _should_rate_limit_worker(
        self, request: RateLimitRequest
    ) -> RateLimitResponse:
        if request.domain == "":
            raise ServiceError("rate limit domain must not be empty")
        if len(request.descriptors) == 0:
            raise ServiceError("rate limit descriptor list must not be empty")

        # Overload admission control (overload/controller.py): shed
        # BEFORE any backend work -- the whole point is not doing it --
        # and release the backpressure gate (when one admitted us) after
        # the backend leg.  A shed answer is OVER_LIMIT on every
        # descriptor with no headers, and global shadow mode does NOT
        # soften it: shadow mode is about not enforcing limits, shedding
        # is the service protecting itself.
        ov = self.overload
        if ov is None:
            return self._decide(request)
        shed_reason, gate = ov.admit(request.domain)
        if shed_reason is not None:
            response = RateLimitResponse()
            response.overall_code = Code.OVER_LIMIT
            response.shed_reason = shed_reason
            response.statuses = [
                DescriptorStatus(code=Code.OVER_LIMIT) for _ in request.descriptors
            ]
            return response
        if gate is None:
            return self._decide(request)
        try:
            return self._decide(request)
        finally:
            gate.release()

    def _decide(self, request: RateLimitRequest) -> RateLimitResponse:
        if self._resolver is not None:
            # Descriptor-resolution fast path: rule lookup, key
            # generation and lane packing fuse into ONE pass inside
            # the backend (cuda_cache.do_limit_resolved), one dict hit
            # per descriptor.  The do_limit span therefore contains
            # rule lookup here (it is part of the fused leg).
            config = self._config  # plain attribute read — no lock
            if config is None:
                raise ServiceError("no rate limit configuration loaded")
            with TRACER.span("backend.do_limit") as span:
                span.set_attr("backend", type(self.cache).__name__)
                statuses, limits, is_unlimited = (
                    self.cache.do_limit_resolved(request, config)
                )
        else:
            limits, is_unlimited = self._construct_limits_to_check(request)
            # The backend leg as its own span; the CUDA cache nests
            # dispatch/kernel spans inside (backends/cuda_cache.py).
            with TRACER.span("backend.do_limit") as span:
                span.set_attr("backend", type(self.cache).__name__)
                statuses = self.cache.do_limit(request, limits)
        assert len(limits) == len(statuses)

        response = RateLimitResponse()
        final_code = Code.OK

        # Track the descriptor closest to its limit for the custom
        # headers (ratelimit.go:165-191).
        min_remaining = MAX_UINT32
        minimum: Optional[DescriptorStatus] = None

        out: List[DescriptorStatus] = []
        for i, status in enumerate(statuses):
            if (
                self.headers_enabled
                and status.current_limit is not None
                and status.limit_remaining < min_remaining
            ):
                minimum = status
                min_remaining = status.limit_remaining

            if is_unlimited[i]:
                out.append(
                    DescriptorStatus(code=Code.OK, limit_remaining=MAX_UINT32)
                )
            else:
                out.append(status)
                if status.code == Code.OVER_LIMIT:
                    final_code = status.code
                    minimum = status
                    min_remaining = 0

        response.statuses = out

        if self.headers_enabled and minimum is not None:
            response.response_headers_to_add = [
                HeaderValue(
                    self.header_limit,
                    str(minimum.current_limit.requests_per_unit),
                ),
                HeaderValue(self.header_remaining, str(minimum.limit_remaining)),
                HeaderValue(
                    self.header_reset,
                    str(calculate_reset(minimum.current_limit.unit, self.clock)),
                ),
            ]

        # Global shadow mode: never report OVER_LIMIT (ratelimit.go:204-207).
        if final_code == Code.OVER_LIMIT and self.global_shadow_mode:
            final_code = Code.OK
            self.stats.global_shadow_mode.inc()

        response.overall_code = final_code
        return response

    def should_rate_limit(self, request: RateLimitRequest) -> RateLimitResponse:
        """Entry point; raises ServiceError/CacheError after counting
        them (the recover() block, ratelimit.go:243-265)."""
        with TRACER.span("service.should_rate_limit"):
            try:
                return self._should_rate_limit_worker(request)
            except CacheError:
                self.stats.should_rate_limit.redis_error.inc()
                raise
            except ServiceError:
                self.stats.should_rate_limit.service_error.inc()
                raise
