"""Health state shared by the HTTP /healthcheck endpoint and the gRPC
grpc.health.v1 service (reference src/server/health.go: atomic ok flag,
SIGTERM flips to NOT_SERVING before shutdown, Fail/Ok used by backend
connection health)."""

from __future__ import annotations

import threading


class HealthChecker:
    def __init__(self, name: str = "ratelimit"):
        self.name = name
        self._cond = threading.Condition()
        self._healthy = True
        self._version = 0  # bumps on every state change (Watch wakeups)
        # DEGRADED is orthogonal to healthy: the replica is still
        # SERVING (load balancers keep routing to it) but part of its
        # device path is quarantined and answering from the failure-
        # mode fallback (backends/fault_domain.py).  Surfaces on
        # /healthcheck ("OK (degraded: ...)") and /debug/faults; the
        # grpc.health.v1 status stays SERVING.
        self._degraded = False
        self._degraded_reason = ""

    @property
    def healthy(self) -> bool:
        with self._cond:
            return self._healthy

    @property
    def degraded(self) -> bool:
        with self._cond:
            return self._degraded

    @property
    def degraded_reason(self) -> str:
        with self._cond:
            return self._degraded_reason

    def set_degraded(self, degraded: bool, reason: str = "") -> None:
        """Flip the degraded flag (fault-domain quarantine state)."""
        with self._cond:
            self._degraded = bool(degraded)
            self._degraded_reason = reason if degraded else ""

    def fail(self) -> None:
        """Mark unhealthy (health.go:49-52)."""
        self._set(False)

    def ok(self) -> None:
        """Mark healthy (health.go:54-57)."""
        self._set(True)

    def _set(self, healthy: bool) -> None:
        with self._cond:
            if self._healthy != healthy:
                self._healthy = healthy
                self._version += 1
                self._cond.notify_all()

    def version(self) -> int:
        with self._cond:
            return self._version

    def wait_for_change(self, last_version: int, timeout: float) -> int:
        """Block until the state version moves past `last_version` or
        the timeout lapses; returns the current version.  Event-driven
        replacement for sleep-polling in health Watch streams."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._version != last_version, timeout=timeout
            )
            return self._version
