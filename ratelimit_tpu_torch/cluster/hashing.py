"""Cluster key ownership: the hash identity shared by routing and
counter handoff.

Port of ratelimit_tpu/cluster/hashing.py, unchanged: a replica of
either package and the JAX package's proxy must agree on the same
bytes.  Dependency-free on purpose (stdlib only): the front proxy and
rendezvous router (the JAX package's cluster/proxy.py and router.py),
the handoff coordinator (`cluster/handoff.py`) AND the replica backend
(which evaluates the ownership predicate over its own stored keys)
all compute ownership with these functions.

The routing identity of one descriptor is its **cache-key stem** —
``<domain>_<k>_<v>_..._`` with a trailing underscore, exactly the
window-independent prefix `limiter/cache_key.py` builds (minus the
replica-local CACHE_KEY_PREFIX, which is not part of the cluster
identity).  Earlier rounds routed on a private ``domain|k_v`` string;
unifying on the stem is what makes counter handoff possible at all:
a replica can recover the stem of every key it stores by stripping
the window suffix (`stem_of_cache_key`), so the "which of my keys
moved?" predicate needs no descriptor parsing and can never disagree
with the proxy's routing byte-for-byte.  Two descriptors that collide
into one cache key (the reference's known `k_v` ambiguity,
cache_key.go:62-74) share a counter — and, with stem routing, also an
owner, which the old scheme did not guarantee.
"""

from __future__ import annotations

import hashlib
from typing import Sequence


def routing_key(domain: str, descriptor) -> str:
    """Window-less counter identity of one descriptor: the cache-key
    stem (``<domain>_<k>_<v>_..._``, limiter/cache_key.py build_stem
    with an empty prefix), so every window of a counter routes to the
    same owner AND a replica can evaluate ownership over its stored
    keys (see stem_of_cache_key).  Duck-typed over anything with
    ``.entries`` of ``.key``/``.value`` pairs (wire protos and
    api.Descriptor alike)."""
    parts = [domain, "_"]
    append = parts.append  # hoisted: 4 loads/lane otherwise (tpu-lint)
    for entry in descriptor.entries:
        append(entry.key)
        append("_")
        append(entry.value)
        append("_")
    return "".join(parts)


def stem_of_cache_key(key: str, prefix: str = "") -> str:
    """Recover the routing stem from a STORED cache key
    (``<prefix><stem><window_start>``): strip the replica-local prefix
    and the trailing window token.  The stem always ends with ``_``
    and the window start is the digits after the LAST underscore, so
    ``rsplit`` is exact whatever underscores the entry values carry.
    Stable-stem keys (sliding-window/GCRA banks carry no window
    suffix but DO end with ``_``) come back unchanged."""
    if prefix and key.startswith(prefix):
        key = key[len(prefix):]
    if key.endswith("_"):
        return key
    return key.rsplit("_", 1)[0] + "_"


def _score(replica_id: str, key: str) -> int:
    h = hashlib.blake2b(
        f"{replica_id}|{key}".encode("utf-8"), digest_size=8
    )
    return int.from_bytes(h.digest(), "big")


def owner_of(key: str, replica_ids: Sequence[str]) -> int:
    """Rendezvous owner: index (into THIS list) of the replica with
    the highest score; the id strings, not the positions, are the
    stable identity.  Score ties break toward the lexically-LARGEST
    id — any reimplementation (a proxy in another language) must use
    the same rule or tied keys would split across two owners."""
    best_i = 0
    best = None
    for i, rid in enumerate(replica_ids):
        s = (_score(rid, key), rid)
        if best is None or s > best:
            best = s
            best_i = i
    return best_i


def owner_id(key: str, replica_ids: Sequence[str]) -> str:
    """The owning replica's id string (convenience over owner_of)."""
    return replica_ids[owner_of(key, replica_ids)]
