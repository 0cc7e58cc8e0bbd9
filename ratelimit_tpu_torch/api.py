"""Data model for the Envoy RateLimitService protocol.

Python equivalents of the protobuf messages in
``envoy/service/ratelimit/v3/rls.proto`` and
``envoy/extensions/common/ratelimit/v3/ratelimit.proto`` (the reference
consumes these via go-control-plane; see reference go.mod:10 and usage in
src/service/ratelimit.go).  The wire codec for real protobuf clients lives
in ``ratelimit_tpu.server.codec``; these dataclasses are the in-process
representation used by every layer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

MAX_UINT32 = 0xFFFFFFFF


class Unit(enum.IntEnum):
    """RateLimitResponse.RateLimit.Unit (rls.proto)."""

    UNKNOWN = 0
    SECOND = 1
    MINUTE = 2
    HOUR = 3
    DAY = 4


# Name lookup used by the config loader (mirrors the generated
# pb.RateLimitResponse_RateLimit_Unit_value map used at
# reference src/config/config_impl.go:123).
UNIT_VALUES = {u.name: int(u) for u in Unit}


class Code(enum.IntEnum):
    """RateLimitResponse.Code (rls.proto)."""

    UNKNOWN = 0
    OK = 1
    OVER_LIMIT = 2


@dataclass(frozen=True, slots=True)
class Entry:
    """RateLimitDescriptor.Entry: one key[/value] pair."""

    key: str
    value: str = ""


@dataclass(frozen=True, slots=True)
class LimitOverride:
    """RateLimitDescriptor.RateLimitOverride: a request-supplied limit.

    When present, it bypasses the configured trie entirely
    (reference src/config/config_impl.go:254-265).
    """

    requests_per_unit: int
    unit: Unit


@dataclass(frozen=True, slots=True)
class Descriptor:
    """RateLimitDescriptor: an ordered tuple of entries plus an
    optional request-supplied limit override."""

    entries: Tuple[Entry, ...]
    limit: Optional[LimitOverride] = None

    @staticmethod
    def of(*pairs: Tuple[str, str], limit: Optional[LimitOverride] = None) -> "Descriptor":
        return Descriptor(tuple(Entry(k, v) for k, v in pairs), limit)


@dataclass(slots=True)
class RateLimitRequest:
    """RateLimitRequest: (domain, descriptors, hits_addend).

    ``deadline`` is process-internal (never serialized): the caller's
    remaining RPC deadline as an ABSOLUTE ``time.monotonic()`` instant,
    stamped by the transport (server/grpc_server.py from
    ``context.time_remaining()``).  The backend's dispatch wait is
    bounded by it — ``min(KERNEL_DEADLINE_S, remaining)`` — and a wait
    cut short answers per DEVICE_FAILURE_MODE instead of blocking past
    the caller's deadline (backends/cuda_cache.py ``_execute``).  None
    means the caller set no deadline."""

    domain: str
    descriptors: Sequence[Descriptor]
    hits_addend: int = 0
    deadline: Optional[float] = None


@dataclass(frozen=True, slots=True)
class RateLimit:
    """RateLimitResponse.RateLimit: the limit actually applied."""

    requests_per_unit: int
    unit: Unit


@dataclass(slots=True)
class DescriptorStatus:
    """RateLimitResponse.DescriptorStatus for one descriptor."""

    code: Code = Code.UNKNOWN
    current_limit: Optional[RateLimit] = None
    limit_remaining: int = 0
    # Seconds until the current fixed window rolls over; None when the
    # descriptor matched no limit (reference base_limiter.go:190-196
    # omits the duration when limit is nil).
    duration_until_reset: Optional[int] = None


@dataclass(slots=True)
class HeaderValue:
    """config.core.v3.HeaderValue."""

    key: str
    value: str


@dataclass
class RateLimitResponse:
    """RateLimitResponse: aggregate code + per-descriptor statuses.

    ``shed_reason`` is process-internal (never serialized): non-None
    when the overload controller refused the request before any
    backend work (overload/controller.py).  The wire code is a plain
    OVER_LIMIT — the Envoy protocol has no richer vocabulary — but the
    transports stamp flight records with the distinguishable
    FLIGHT_CODE_SHED so the ring separates "counted out" from "load
    shed"."""

    overall_code: Code = Code.UNKNOWN
    statuses: list = field(default_factory=list)
    response_headers_to_add: list = field(default_factory=list)
    shed_reason: Optional[str] = None
