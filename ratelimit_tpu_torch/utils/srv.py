"""DNS SRV resolution (reference src/srv/srv.go).

A copy of ratelimit_tpu/utils/srv.py (standard library only).

The reference uses SRV records to discover memcached servers
(`_service._proto.name` -> host:port list, srv.go:148-171).  Kept for
parity and for discovering peer replicas/statsd targets; implemented
on the stdlib only (no dnspython in the image): a minimal RFC 1035
query/response codec over UDP against the system resolver.
"""

from __future__ import annotations

import random
import re
import socket
import struct
from typing import List, Optional, Tuple

# _service._proto.name (srv.go:130).
_SRV_RE = re.compile(r"^_(?P<service>.+?)\._(?P<proto>.+?)\.(?P<name>.+)$")

QTYPE_SRV = 33
QCLASS_IN = 1


class SrvError(Exception):
    pass


def parse_srv(record: str) -> Tuple[str, str, str]:
    """Split `_service._proto.name` (srv.go:138-146)."""
    m = _SRV_RE.match(record)
    if m is None:
        raise SrvError(f"invalid srv record: {record}")
    return m.group("service"), m.group("proto"), m.group("name")


def _encode_qname(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        raw = label.encode("idna") if label else b""
        if not 0 < len(raw) < 64:
            raise SrvError(f"invalid dns label in {name!r}")
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def _skip_name(buf: bytes, off: int) -> int:
    while True:
        if off >= len(buf):
            raise SrvError("truncated dns name")
        length = buf[off]
        if length == 0:
            return off + 1
        if length & 0xC0 == 0xC0:  # compression pointer
            return off + 2
        off += 1 + length


def _read_name(buf: bytes, off: int, depth: int = 0) -> str:
    if depth > 10:
        raise SrvError("dns name compression loop")
    labels = []
    while True:
        length = buf[off]
        if length == 0:
            break
        if length & 0xC0 == 0xC0:
            ptr = struct.unpack_from("!H", buf, off)[0] & 0x3FFF
            labels.append(_read_name(buf, ptr, depth + 1))
            return ".".join(labels)
        off += 1
        labels.append(buf[off : off + length].decode("ascii", "replace"))
        off += length
    return ".".join(labels)


def _default_resolver() -> Tuple[str, int]:
    try:
        with open("/etc/resolv.conf") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "nameserver":
                    return parts[1], 53
    except OSError:
        pass
    return "127.0.0.1", 53


def lookup_srv(
    record: str,
    resolver: Optional[Tuple[str, int]] = None,
    timeout: float = 3.0,
) -> List[Tuple[int, int, int, str]]:
    """Query SRV `record`; returns [(priority, weight, port, target)]."""
    parse_srv(record)  # validate shape first (srv.go:150-153)
    resolver = resolver or _default_resolver()
    txid = random.randrange(1 << 16)
    query = struct.pack("!HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    query += _encode_qname(record) + struct.pack("!HH", QTYPE_SRV, QCLASS_IN)

    family = socket.AF_INET6 if ":" in resolver[0] else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(query, resolver)
        buf, _ = sock.recvfrom(4096)
    except socket.timeout as e:
        raise SrvError(f"dns timeout resolving {record}") from e
    except OSError as e:
        # gaierror, refused ports, unreachable resolvers, ... — all
        # surface through the module's SrvError contract.
        raise SrvError(f"dns query failed for {record}: {e}") from e
    finally:
        sock.close()

    try:
        return _parse_answers(buf, txid, record)
    except (struct.error, IndexError) as e:
        raise SrvError(f"malformed dns response for {record}: {e}") from e


def _parse_answers(buf: bytes, txid: int, record: str):
    if len(buf) < 12:
        raise SrvError("short dns response")
    rid, flags, qd, an, _, _ = struct.unpack_from("!HHHHHH", buf, 0)
    if rid != txid:
        raise SrvError("dns transaction id mismatch")
    if flags & 0x0200:  # TC: answers didn't fit the UDP datagram
        raise SrvError(f"truncated dns response for {record}")
    rcode = flags & 0xF
    if rcode != 0:
        raise SrvError(f"dns error rcode={rcode} for {record}")

    off = 12
    for _ in range(qd):
        off = _skip_name(buf, off) + 4
    out = []
    for _ in range(an):
        off = _skip_name(buf, off)
        rtype, _rclass, _ttl, rdlen = struct.unpack_from("!HHIH", buf, off)
        off += 10
        if rtype == QTYPE_SRV:
            prio, weight, port = struct.unpack_from("!HHH", buf, off)
            target = _read_name(buf, off + 6)
            out.append((prio, weight, port, target))
        off += rdlen
    return out


def server_strings_from_srv(
    record: str,
    resolver: Optional[Tuple[str, int]] = None,
) -> List[str]:
    """`host:port` list for an SRV record (srv.go:148-171, sorted by
    priority then randomized within equal weight groups like Go's
    LookupSRV ordering contract — we keep it simple: priority order)."""
    answers = lookup_srv(record, resolver=resolver)
    if not answers:
        raise SrvError(f"no srv answers for {record}")
    answers.sort(key=lambda a: (a[0], -a[1]))
    return [f"{target}:{port}" for _, _, port, target in answers]
