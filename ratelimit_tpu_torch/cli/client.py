"""gRPC smoke client (reference src/client_cmd/main.go:47-86).

Port of ratelimit_tpu/cli/client.py, unchanged: it dials a runner or a
cluster proxy of either package, with TLS (``--tls-ca``, and a client
certificate for mTLS) and a bearer token (``--auth-token``).  It imports
grpc and the wire protos, never torch.

    python -m ratelimit_tpu_torch.cli.client \
        --dial_string localhost:8081 --domain mongo_cps \
        --descriptors database=users,database=default --hits-addend 1
"""

from __future__ import annotations

import argparse
import os
import sys

import grpc

from ..server import pb  # noqa: F401

from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402


def parse_descriptors(spec: str) -> "rls_pb2.RateLimitRequest":
    """`k=v,k2=v2` -> one descriptor with those entries (client_cmd's
    -descriptors flag format)."""
    request = rls_pb2.RateLimitRequest()
    descriptor = request.descriptors.add()
    for pair in spec.split(","):
        if not pair:
            continue
        key, _, value = pair.partition("=")
        entry = descriptor.entries.add()
        entry.key, entry.value = key, value
    return request


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ratelimit gRPC client")
    p.add_argument("--dial_string", default="localhost:8081")
    p.add_argument("--domain", required=True)
    p.add_argument(
        "--descriptors",
        required=True,
        help="descriptor list: k=v,k2=v2 (one descriptor)",
    )
    p.add_argument("--hits-addend", type=int, default=0)
    p.add_argument(
        "--tls-ca", default="",
        help="PEM CA verifying the server cert; enables TLS "
        "(servers with GRPC_SERVER_TLS_CERT set)",
    )
    p.add_argument(
        "--tls-cert", default="",
        help="PEM client certificate for mTLS servers",
    )
    p.add_argument("--tls-key", default="", help="key for --tls-cert")
    p.add_argument(
        "--auth-token", default="",
        help="bearer token for servers with GRPC_AUTH_TOKEN set",
    )
    args = p.parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        p.error("--tls-cert and --tls-key must be given together")

    request = parse_descriptors(args.descriptors)
    request.domain = args.domain
    request.hits_addend = args.hits_addend

    if args.tls_ca:
        from ..cluster.proxy import replica_channel_credentials

        channel = grpc.secure_channel(
            args.dial_string,
            replica_channel_credentials(
                args.tls_ca, args.tls_cert, args.tls_key
            ),
        )
    else:
        channel = grpc.insecure_channel(args.dial_string)
    metadata = (
        (("authorization", f"Bearer {args.auth_token}"),)
        if args.auth_token
        else None
    )
    with channel:
        method = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        try:
            response = method(request, timeout=10, metadata=metadata)
        except grpc.RpcError as e:
            print(f"error: {e.code().name}: {e.details()}", file=sys.stderr)
            return 1
    try:
        print(response)
        sys.stdout.flush()
    except BrokenPipeError:
        # Downstream (head/grep -q) closed the pipe after reading what
        # it needed — that is success, not a crash.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
