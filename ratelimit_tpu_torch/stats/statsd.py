"""Statsd export: periodic UDP flush of the stat store.

The reference emits gostats to statsd (USE_STATSD/STATSD_HOST/PORT,
reference src/settings/settings.go:34-37) and ships a statsd-exporter
mapping for Prometheus (examples/prom-statsd-exporter/conf.yaml).
Counters flush as deltas (statsd ``|c``), gauges as absolute values
(``|g``), matching gostats' sink behavior.

The target can also be discovered via a DNS SRV record
(STATSD_SRV, e.g. ``_statsd._udp.metrics.local``) with periodic
re-resolution (utils/srv.py) -- the same discovery pattern the
reference applies to its memcached servers (MEMCACHE_SRV +
MEMCACHE_SRV_REFRESH, src/memcached/cache_impl.go:180-228,
src/srv/srv.go).  Port of ratelimit_tpu/stats/statsd.py.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Optional, Tuple

from .manager import StatsStore

logger = logging.getLogger("ratelimit.statsd")


class StatsdExporter:
    def __init__(
        self,
        store: StatsStore,
        host: str = "localhost",
        port: int = 8125,
        interval_s: float = 5.0,
        srv_record: str = "",
        srv_refresh_s: float = 0.0,
        srv_resolver: Optional[Tuple[str, int]] = None,
    ):
        """`srv_record`, when set, overrides host/port: the first
        (priority, weight)-ordered SRV answer becomes the target, and
        `srv_refresh_s` > 0 re-resolves on that cadence (keeping the
        last good target when a refresh fails).  Startup resolution
        failures raise -- a misconfigured record should fail fast, like
        the reference's memcached SRV startup path.  `srv_resolver` is
        the DNS server's (host, port); None reads the system's."""
        self.store = store
        self.addr = (host, port)
        self.interval_s = interval_s
        self.srv_record = srv_record
        self.srv_refresh_s = float(srv_refresh_s)
        self._srv_resolver = srv_resolver
        self._next_refresh = 0.0
        if srv_record:
            self.addr = self._resolve_srv()  # raises SrvError on bad
            self._next_refresh = time.monotonic() + self.srv_refresh_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Delta cursors for fn-backed counters (gauge_fn-style live
        # counters: resolution cache hits, slot-table evictions, the
        # hot-key sketch tallies).  Live Counter objects drain their
        # own deltas; these are plain ints read at flush time, so the
        # exporter keeps the last-flushed value per name.
        self._fn_last: dict = {}

    def _resolve_srv(self) -> Tuple[str, int]:
        from ..utils.srv import server_strings_from_srv

        target = server_strings_from_srv(
            self.srv_record, resolver=self._srv_resolver
        )[0]
        host, _, port = target.rpartition(":")
        return host.rstrip("."), int(port)

    def _maybe_refresh_srv(self) -> None:
        if not self.srv_record or self.srv_refresh_s <= 0:
            return
        now = time.monotonic()
        if now < self._next_refresh:
            return
        self._next_refresh = now + self.srv_refresh_s
        try:
            addr = self._resolve_srv()
        except Exception as e:
            logger.warning(
                "statsd srv refresh failed (%s); keeping %s", e, self.addr
            )
            return
        if addr != self.addr:
            logger.info("statsd target moved: %s -> %s", self.addr, addr)
            self.addr = addr

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="statsd-exporter", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush()  # final drain
        # Release the UDP socket: tests and restart loops construct
        # many exporters, and an unclosed fd per exporter leaks until
        # gc finalization.  flush() after this point is a no-op.
        self._closed = True
        self._sock.close()

    def flush(self) -> None:
        """One export cycle (also the deterministic test hook); no-op
        once stop() has closed the socket."""
        if self._closed:
            return
        lines = []
        counters = self.store.live_counters()
        timers = self.store.live_timers()
        for c in counters:
            delta = c.drain_delta()
            if delta:
                lines.append(f"{c.name}:{delta}|c")
        for name, value in self.store.counter_fn_values().items():
            delta = value - self._fn_last.get(name, 0)
            self._fn_last[name] = value  # tpu-lint: disable=shared-state -- one writer at a time: stop() joins the loop thread BEFORE its final flush
            if delta > 0:  # benign races can read a tally mid-step
                lines.append(f"{name}:{delta}|c")
        for name, value in self.store.gauges().items():
            lines.append(f"{name}:{value}|g")
        for name, value in self.store.float_gauges().items():
            lines.append(f"{name}:{value:.6g}|g")
        for t in timers:
            for ms in t.drain_samples():
                lines.append(f"{t.name}:{ms:.3f}|ms")
            dropped = t.drain_dropped()
            if dropped:
                # Saturated flush interval: the |ms lines above are a
                # truncated sample — say so, countably.
                lines.append(f"{t.name}.timer_samples_dropped:{dropped}|c")
        # Chunk into ~1400-byte datagrams (standard statsd MTU safety).
        buf: list = []
        size = 0
        for line in lines:
            if size + len(line) + 1 > 1400 and buf:
                self._send("\n".join(buf))
                buf, size = [], 0
            buf.append(line)
            size += len(line) + 1
        if buf:
            self._send("\n".join(buf))

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode("utf-8"), self.addr)
        except OSError as e:
            logger.debug("statsd send failed: %s", e)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._maybe_refresh_srv()
                self.flush()
            except Exception:
                logger.exception("statsd flush failed")
