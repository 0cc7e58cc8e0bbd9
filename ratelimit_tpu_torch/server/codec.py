"""Wire codec: generated protobuf messages <-> api dataclasses.

The reference passes go-control-plane pb structs straight through its
layers; here the in-process representation is ``ratelimit_tpu.api`` and
the pb types only exist at the transport boundary (gRPC handler and the
HTTP /json bridge, reference src/server/server_impl.go:71-109).
"""

from __future__ import annotations

from . import pb  # noqa: F401  (sys.path setup for generated imports)

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

from .. import api  # noqa: E402


def request_from_pb(msg: "rls_pb2.RateLimitRequest") -> api.RateLimitRequest:
    descriptors = []
    for d in msg.descriptors:
        limit = None
        if d.HasField("limit"):
            limit = api.LimitOverride(
                requests_per_unit=d.limit.requests_per_unit,
                unit=api.Unit(d.limit.unit),
            )
        descriptors.append(
            api.Descriptor(
                entries=tuple(api.Entry(e.key, e.value) for e in d.entries),
                limit=limit,
            )
        )
    return api.RateLimitRequest(
        domain=msg.domain,
        descriptors=descriptors,
        hits_addend=msg.hits_addend,
    )


def response_to_pb(resp: api.RateLimitResponse) -> "rls_pb2.RateLimitResponse":
    out = rls_pb2.RateLimitResponse()
    out.overall_code = int(resp.overall_code)
    for status in resp.statuses:
        s = out.statuses.add()
        s.code = int(status.code)
        s.limit_remaining = status.limit_remaining
        if status.current_limit is not None:
            s.current_limit.requests_per_unit = (
                status.current_limit.requests_per_unit
            )
            s.current_limit.unit = int(status.current_limit.unit)
        if status.duration_until_reset is not None:
            s.duration_until_reset.seconds = status.duration_until_reset
    for h in resp.response_headers_to_add:
        hv = out.response_headers_to_add.add()
        hv.key = h.key
        hv.value = h.value
    return out
