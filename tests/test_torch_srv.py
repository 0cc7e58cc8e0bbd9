"""DNS SRV discovery (ratelimit_tpu_torch/utils/srv.py) and the statsd
exporter's STATSD_SRV target, through both packages, against a fake
DNS server on a loopback UDP socket (real DNS wire format; no query
leaves the machine).

The three scenarios of the JAX package's tests/test_srv.py run once per
package, and then each package's StatsdExporter resolves its target
from an SRV record, re-resolves it on its refresh cadence, keeps the
last good target when a refresh finds no answer, and flushes to the
resolved address.
"""

import importlib
import socket
import struct
import threading
from types import SimpleNamespace

import pytest

PACKAGES = ("ratelimit_tpu", "ratelimit_tpu_torch")


@pytest.fixture(params=PACKAGES)
def P(request):
    return SimpleNamespace(
        srv=importlib.import_module(request.param + ".utils.srv"),
        statsd=importlib.import_module(request.param + ".stats.statsd"),
        manager=importlib.import_module(request.param + ".stats.manager"),
    )


def test_parse_srv(P):
    assert P.srv.parse_srv("_memcache._tcp.mycompany.com") == (
        "memcache",
        "tcp",
        "mycompany.com",
    )
    for bad in ("memcache.tcp.x", "_memcache.tcp.x", "_m._t", ""):
        with pytest.raises(P.srv.SrvError):
            P.srv.parse_srv(bad)


def _encode_name(name):
    out = b""
    for label in name.rstrip(".").split("."):
        out += bytes([len(label)]) + label.encode()
    return out + b"\x00"


class FakeDns(threading.Thread):
    """A DNS server answering one SRV query per entry of `rounds`, each
    a list of (priority, weight, port, target) records."""

    def __init__(self, *rounds):
        super().__init__(daemon=True)
        self.rounds = list(rounds)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(30)
        self.addr = self.sock.getsockname()

    def run(self):
        try:
            for answers in self.rounds:
                data, client = self.sock.recvfrom(4096)
                resp = data[:2] + struct.pack("!HHHHH", 0x8180, 1, len(answers), 0, 0)
                resp += data[12:]  # echo the question section
                for prio, weight, port, target in answers:
                    rdata = struct.pack("!HHH", prio, weight, port) + _encode_name(target)
                    resp += (
                        b"\xc0\x0c"  # pointer to qname
                        + struct.pack("!HHIH", 33, 1, 60, len(rdata))
                        + rdata
                    )
                self.sock.sendto(resp, client)
        finally:
            self.sock.close()


def test_lookup_and_ordering(P):
    dns = FakeDns(
        [
            (20, 0, 11212, "backup.example.com"),
            (10, 5, 11211, "cache1.example.com"),
        ]
    )
    dns.start()
    out = P.srv.server_strings_from_srv("_memcache._tcp.example.com", resolver=dns.addr)
    # priority 10 before 20 (srv.go ordering contract).
    assert out == ["cache1.example.com:11211", "backup.example.com:11212"]
    dns.join(timeout=10)
    assert not dns.is_alive()


def test_no_answers_is_error(P):
    dns = FakeDns([])
    dns.start()
    with pytest.raises(P.srv.SrvError):
        P.srv.server_strings_from_srv("_x._tcp.example.com", resolver=dns.addr)
    dns.join(timeout=10)
    assert not dns.is_alive()


def test_statsd_exporter_follows_its_srv_record(P):
    """STATSD_SRV: the target comes from the record at startup, moves
    when a refresh answers elsewhere, stays when a refresh finds no
    answer, and the flush lands on the resolved address."""
    sinks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2)]
    for s in sinks:
        s.bind(("127.0.0.1", 0))
        s.settimeout(30)
    ports = [s.getsockname()[1] for s in sinks]
    dns = FakeDns(
        [(10, 0, ports[0], "127.0.0.1")],
        [(10, 0, ports[1], "127.0.0.1."), (20, 0, ports[0], "127.0.0.1")],
        [],
    )
    dns.start()
    store = P.manager.StatsStore()
    exporter = P.statsd.StatsdExporter(
        store,
        srv_record="_statsd._udp.metrics.local",
        srv_refresh_s=1e-6,
        srv_resolver=dns.addr,
    )
    try:
        seen = [exporter.addr]
        exporter._maybe_refresh_srv()  # moves to the priority-10 answer
        seen.append(exporter.addr)
        exporter._maybe_refresh_srv()  # no answer: keeps the last good one
        seen.append(exporter.addr)
        assert seen == [
            ("127.0.0.1", ports[0]),
            ("127.0.0.1", ports[1]),
            ("127.0.0.1", ports[1]),
        ]
        store.counter("ratelimit.service.srv_probe").add(3)
        exporter.flush()
        assert sinks[1].recv(4096) == b"ratelimit.service.srv_probe:3|c"
    finally:
        exporter.stop()
        for s in sinks:
            s.close()
    dns.join(timeout=10)
    assert not dns.is_alive()


def test_statsd_exporter_refuses_a_record_with_no_answer(P):
    dns = FakeDns([])
    dns.start()
    with pytest.raises(P.srv.SrvError):
        P.statsd.StatsdExporter(
            P.manager.StatsStore(), srv_record="_statsd._udp.x", srv_resolver=dns.addr
        )
    dns.join(timeout=10)
