"""TLS, mTLS and the bearer token on the port's gRPC listener, its
cluster proxy's replica channels and its CLI client, against the JAX
package's, on the CPU.

The five cases of the JAX package's tests/test_tls_auth.py run through a
port runner (device="cpu") and a JAX runner booted on the same settings
and the same test PKI (tests/tls_helpers.make_test_pki): a TLS listener
serves and refuses plaintext; mTLS requires a client certificate; the
token gates ShouldRateLimit but not health; the port's proxy transport
speaks TLS and the token to port replicas, and a missing token
propagates UNAUTHENTICATED without ejecting the replica; the port's CLI
client speaks TLS and the token.  Beyond them, health Watch stays open
under the token, and the proxy's transport presents a client
certificate to an mTLS replica (without one the handshake fails and the
replica is ejected, in both packages alike).  Every reply is byte-equal
to the JAX runner's, and every refusal has the same status code and
details.
"""

import grpc
import pytest

from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402
from grpchealth.v1 import health_pb2  # noqa: E402

from tls_helpers import make_test_pki

YAML = """
domain: sec
descriptors:
  - key: key1
    rate_limit:
      unit: minute
      requests_per_unit: 5
"""

OK = rls_pb2.RateLimitResponse.OK


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    return make_test_pki(str(tmp_path_factory.mktemp("pki")))


@pytest.fixture
def pair(tmp_path_factory):
    """pair(name, **settings): a JAX runner and a port runner, started
    on the same settings; both stopped after the test."""
    made = []

    def boot(name, **settings_kw):
        out = []
        for pkg, (Rn, St, backend, extra) in {
            "jax": (JaxRunner, JaxSettings, "tpu", dict(time_source=JaxPinned(1_000_000))),
            "port": (Runner, Settings, "cuda", dict(time_source=PinnedTimeSource(1_000_000), device="cpu")),
        }.items():
            root = tmp_path_factory.mktemp(f"{name}-{pkg}")
            (root / "ratelimit" / "config").mkdir(parents=True)
            (root / "ratelimit" / "config" / "sec.yaml").write_text(YAML)
            s = St(
                host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
                debug_host="127.0.0.1", debug_port=0, use_statsd=False,
                backend_type=backend, tpu_num_slots=1 << 10,
                tpu_batch_window_us=0, tpu_batch_buckets=[8],
                runtime_path=str(root), runtime_subdirectory="ratelimit",
                local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
                **settings_kw,
            )
            r = Rn(s, **extra)
            r.start()
            made.append(r)
            out.append(r)
        return out

    yield boot
    for r in made:
        r.stop()


def _request(value="v"):
    req = rls_pb2.RateLimitRequest(domain="sec")
    e = req.descriptors.add().entries.add()
    e.key, e.value = "key1", value
    return req


def _method(channel):
    return channel.unary_unary(
        "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
        request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
        response_deserializer=rls_pb2.RateLimitResponse.FromString,
    )


def _outcome(fn):
    """A reply as wire bytes, or a refusal as its status code and details."""
    try:
        return fn().SerializeToString()
    except grpc.RpcError as e:
        return e.code(), e.details()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _addr(r, host="127.0.0.1"):
    return f"{host}:{r.grpc_server.bound_port}"


def test_tls_listener_serves_and_rejects_plaintext(pair, pki):
    def observe(r):
        addr = _addr(r)
        with grpc.secure_channel(addr, grpc.ssl_channel_credentials(_read(pki["ca"]))) as ch:
            served = _outcome(lambda: _method(ch)(_request(), timeout=30))
        with grpc.insecure_channel(addr) as ch:
            with pytest.raises(grpc.RpcError) as err:
                _method(ch)(_request(), timeout=5)
        return served, err.value.code()

    jax_r, port_r = pair("tls", grpc_server_tls_cert=pki["server_cert"], grpc_server_tls_key=pki["server_key"])
    got = observe(port_r)
    assert rls_pb2.RateLimitResponse.FromString(got[0]).overall_code == OK
    assert got == observe(jax_r)


def test_mtls_requires_client_certificate(pair, pki):
    def observe(r):
        addr = _addr(r)
        ca = _read(pki["ca"])
        good = grpc.ssl_channel_credentials(
            root_certificates=ca, private_key=_read(pki["client_key"]),
            certificate_chain=_read(pki["client_cert"]),
        )
        with grpc.secure_channel(addr, good) as ch:
            served = _outcome(lambda: _method(ch)(_request(), timeout=30))
        with grpc.secure_channel(addr, grpc.ssl_channel_credentials(root_certificates=ca)) as ch:
            with pytest.raises(grpc.RpcError) as err:
                _method(ch)(_request(), timeout=5)
        return served, err.value.code()

    jax_r, port_r = pair(
        "mtls", grpc_server_tls_cert=pki["server_cert"], grpc_server_tls_key=pki["server_key"],
        grpc_server_tls_ca=pki["ca"],
    )
    got = observe(port_r)
    assert rls_pb2.RateLimitResponse.FromString(got[0]).overall_code == OK
    assert got == observe(jax_r)


def test_auth_token_gates_ratelimit_but_not_health(pair):
    def observe(r):
        with grpc.insecure_channel(_addr(r)) as ch:
            m = _method(ch)
            out = [
                _outcome(lambda: m(_request(), timeout=10)),
                _outcome(lambda: m(_request(), timeout=10, metadata=(("authorization", "Bearer wrong"),))),
                _outcome(lambda: m(_request(), timeout=10, metadata=(("authorization", "s3cret"),))),
                _outcome(lambda: m(_request(), timeout=30, metadata=(("authorization", "Bearer s3cret"),))),
            ]
            check = ch.unary_unary(
                "/grpc.health.v1.Health/Check",
                request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
                response_deserializer=health_pb2.HealthCheckResponse.FromString,
            )
            out.append(check(health_pb2.HealthCheckRequest(), timeout=10).status)
            watch = ch.unary_stream(
                "/grpc.health.v1.Health/Watch",
                request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
                response_deserializer=health_pb2.HealthCheckResponse.FromString,
            )
            stream = watch(health_pb2.HealthCheckRequest(), timeout=10)
            out.append(next(stream).status)
            stream.cancel()
        return out

    jax_r, port_r = pair("auth", grpc_auth_token="s3cret")
    got = observe(port_r)
    assert [o[0] for o in got[:3]] == [grpc.StatusCode.UNAUTHENTICATED] * 3
    assert rls_pb2.RateLimitResponse.FromString(got[3]).overall_code == OK
    assert got[4:] == [health_pb2.HealthCheckResponse.SERVING] * 2
    assert got == observe(jax_r)


def test_proxy_speaks_tls_and_auth_to_replicas(pair, pki):
    """The cluster hop, secured: each package's production transport
    (build_router with channel credentials and the token) through a
    replica of its own package with TLS and the token; without the
    token the replica's UNAUTHENTICATED propagates and ejects nothing."""
    import ratelimit_tpu.cluster.proxy as jax_proxy
    import ratelimit_tpu_torch.cluster.proxy as port_proxy

    def observe(proxy, r):
        addr = _addr(r)
        router = proxy.build_router(
            [addr], channel_credentials=proxy.replica_channel_credentials(pki["ca"]),
            auth_token="cluster-secret", eject_after=1,
        )
        bad = proxy.build_router(
            [addr], channel_credentials=proxy.replica_channel_credentials(pki["ca"]), eject_after=1,
        )
        try:
            out = [_outcome(lambda: router.should_rate_limit(_request("via-proxy")))]
            out += [_outcome(lambda: bad.should_rate_limit(_request("via-proxy"))) for _ in range(3)]
            out += [bad.live_replica_count(), bad.stats()["ejections"], bad.stats()["failovers"]]
            out.append(_outcome(lambda: router.should_rate_limit(_request("via-proxy"))))
            return out
        finally:
            router.close()
            bad.close()

    jax_r, port_r = pair(
        "cluster-tls", grpc_server_tls_cert=pki["server_cert"], grpc_server_tls_key=pki["server_key"],
        grpc_auth_token="cluster-secret",
    )
    got = observe(port_proxy, port_r)
    first = rls_pb2.RateLimitResponse.FromString(got[0])
    assert first.overall_code == OK and first.statuses[0].limit_remaining == 4
    assert [o[0] for o in got[1:4]] == [grpc.StatusCode.UNAUTHENTICATED] * 3
    assert got[4:7] == [1, 0, 0]  # never ejected, never failed over
    assert rls_pb2.RateLimitResponse.FromString(got[7]).statuses[0].limit_remaining == 3
    assert got == observe(jax_proxy, jax_r)


def test_proxy_presents_a_client_certificate_to_mtls_replicas(pair, pki):
    """Beyond the JAX test: replica channel credentials with a client
    certificate reach an mTLS replica with the token; without the
    certificate the handshake fails, which is a replica-health failure
    (UNAVAILABLE) and ejects, in both packages alike."""
    import ratelimit_tpu.cluster.proxy as jax_proxy
    import ratelimit_tpu_torch.cluster.proxy as port_proxy

    def observe(proxy, r):
        addr = _addr(r)
        good = proxy.build_router(
            [addr], auth_token="m-secret", eject_after=1,
            channel_credentials=proxy.replica_channel_credentials(
                pki["ca"], pki["client_cert"], pki["client_key"]
            ),
        )
        anon = proxy.build_router(
            [addr], auth_token="m-secret", eject_after=1,
            channel_credentials=proxy.replica_channel_credentials(pki["ca"]),
        )
        try:
            served = _outcome(lambda: good.should_rate_limit(_request("mtls-proxy")))
            refused = _outcome(lambda: anon.should_rate_limit(_request("mtls-proxy")))
            return served, refused, anon.live_replica_count(), anon.stats()["fallback_descriptors"]
        finally:
            good.close()
            anon.close()

    jax_r, port_r = pair(
        "mtls-proxy", grpc_server_tls_cert=pki["server_cert"], grpc_server_tls_key=pki["server_key"],
        grpc_server_tls_ca=pki["ca"], grpc_auth_token="m-secret",
    )
    got = observe(port_proxy, port_r)
    assert rls_pb2.RateLimitResponse.FromString(got[0]).statuses[0].limit_remaining == 4
    # The failure policy (allow) answered the descriptor of the ejected replica.
    assert rls_pb2.RateLimitResponse.FromString(got[1]).overall_code == OK
    assert got[2:] == (0, 1)
    assert got == observe(jax_proxy, jax_r)


def test_cli_client_speaks_tls_and_auth(pair, pki, capsys):
    from ratelimit_tpu.cli.client import main as jax_client
    from ratelimit_tpu_torch.cli.client import main as port_client

    def observe(client, r):
        addr = _addr(r, "localhost")
        args = ["--dial_string", addr, "--domain", "sec", "--descriptors", "key1=cli", "--tls-ca", pki["ca"]]
        out = []
        for extra in (["--auth-token", "cli-secret"], [], ["--auth-token", "cli-secret", "--hits-addend", "3"]):
            rc = client(args + extra)
            cap = capsys.readouterr()
            out.append((rc, cap.out, cap.err))
        return out

    jax_r, port_r = pair(
        "cli-tls", grpc_server_tls_cert=pki["server_cert"], grpc_server_tls_key=pki["server_key"],
        grpc_auth_token="cli-secret",
    )
    got = observe(port_client, port_r)
    assert got[0][0] == 0 and "overall_code: OK" in got[0][1]
    assert got[1][0] == 1 and "UNAUTHENTICATED" in got[1][2]
    assert got[2][0] == 0 and "limit_remaining: 1" in got[2][1]
    assert got == observe(jax_client, jax_r)
