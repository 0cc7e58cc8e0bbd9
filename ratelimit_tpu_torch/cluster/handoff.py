"""Counter handoff on cluster membership change.

Port of ratelimit_tpu/cluster/handoff.py: the same wire format (a blob
packed by either package unpacks in the other), the same sections,
coordinator and admin transports.  Export and import are restructured
so that no bank's dispatcher is held for a pass over its table in
Python (ROADMAP.md, Queue 3): the reference lists every entry, runs
the ownership predicate, copies the whole state table both ways and
rebuilds the slot table, all on the dispatcher thread, which at 2^18
live keys outlasts the kernel deadline and quarantines a healthy bank.
Here:

- export copies the state rows and the slot table's entries under
  exclusivity (checkpoint.copy_engine, the snapshot's copy), decodes
  the keys and decides ownership on the caller's thread, then releases
  the moved keys in a second short exclusive leg that zeroes their
  slots by id -- only where a slot still holds the same key and
  expiry, so a slot that gc gave to another key in between is never
  cleared (CounterEngine.release_keys);
- import drops expired entries and splits sections by lane on the
  caller's thread, then lands them in chunks of HANDOFF_CHUNK keys,
  each one exclusive leg that assigns the chunk's slots in one batch
  and gathers and scatters only those slots (CounterEngine.land_keys).

The hits that land on the old owner between the copy and the release
are forgiven, inside the envelope below.

The DCN tier's other half: rendezvous routing (the JAX package's
cluster/router.py) moves ~1/n of the keys when membership changes, and
without this module those keys would restart their windows on the new
owner -- momentary over-admission at scale.  Handoff closes it:

1. the proxy swaps in the new-membership router with the **forwarding
   window** armed: moved keys keep routing to their old owner, so
   admission stays exact while the transfer runs;
2. the coordinator asks each old owner to **export** the live keys it
   no longer owns (`export_from_cache`), partitions the exported
   entries by their NEW owner, and **imports** each partition
   (`import_into_cache`, merge-on-collision);
3. the forwarding window closes; the new owner is authoritative with
   the transferred counters.

Consistency envelope: hits that land on the old owner between its
export snapshot and the forwarding window closing are forgiven — the
over-admission bound is (per-key rate x transfer duration), not a
full window restart.  A failed export/import falls back to exactly the
pre-handoff envelope (window restart for the affected keys), never
worse.

Replicas must share CACHE_KEY_PREFIX (key strings travel verbatim);
the cluster identity itself is prefix-free (`cluster/hashing.py`).

Module-level functions (not cache methods) on purpose: they need only
the cache's public seams (`engines`/`run_exclusive`/`key_generator`),
and this module imports numpy and the stdlib only.
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence
from zlib import crc32

import numpy as np

from .hashing import owner_id, stem_of_cache_key

logger = logging.getLogger("ratelimit.cluster.handoff")

BLOB_VERSION = 1

#: Keys a per-key Python pass handles between two yields of the
#: interpreter lock (about a millisecond of work): a handoff shares the
#: process with the banks' dispatcher threads, which must keep making
#: their kernel deadline while it runs.
YIELD_EVERY = 256


def _owners(stems, ids: Sequence[str]):
    """hashing.owner_id of each stem over `ids`, yielding the
    interpreter lock every YIELD_EVERY stems."""
    out = []
    for n, stem in enumerate(stems, 1):
        out.append(owner_id(stem, ids))
        if n % YIELD_EVERY == 0:
            time.sleep(0)
    return out


class HandoffLog:
    """Per-replica handoff bookkeeping: the `ratelimit.cluster.*`
    counter source and the `GET /debug/cluster` summary.  Counters are
    cumulative (statsd delta-flushes them via the counter_fn path);
    `last_export`/`last_import` keep the most recent operation's
    summary for operators."""

    def __init__(self):
        self._lock = threading.Lock()
        self.exports = 0
        self.imports = 0
        self.exported_keys = 0
        self.imported_keys = 0
        self.merged_keys = 0
        self.dropped_keys = 0
        self.last_export: Optional[dict] = None
        self.last_import: Optional[dict] = None

    def note_export(self, summary: dict) -> None:
        with self._lock:
            self.exports += 1
            self.exported_keys += int(summary.get("keys", 0))
            self.last_export = summary

    def note_import(self, summary: dict) -> None:
        with self._lock:
            self.imports += 1
            self.imported_keys += int(summary.get("imported", 0))
            self.merged_keys += int(summary.get("merged", 0))
            self.dropped_keys += int(summary.get("dropped", 0))
            self.last_import = summary

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "exports": self.exports,
                "imports": self.imports,
                "exported_keys": self.exported_keys,
                "imported_keys": self.imported_keys,
                "merged_keys": self.merged_keys,
                "dropped_keys": self.dropped_keys,
                "last_export": self.last_export,
                "last_import": self.last_import,
            }

    def register_stats(self, store, scope: str = "ratelimit.cluster") -> None:
        store.counter_fn(scope + ".handoff.exports", lambda: self.exports)
        store.counter_fn(scope + ".handoff.imports", lambda: self.imports)
        store.counter_fn(
            scope + ".handoff.exported_keys", lambda: self.exported_keys
        )
        store.counter_fn(
            scope + ".handoff.imported_keys", lambda: self.imported_keys
        )
        store.counter_fn(
            scope + ".handoff.merged_keys", lambda: self.merged_keys
        )
        store.counter_fn(
            scope + ".handoff.dropped_keys", lambda: self.dropped_keys
        )


# ---------------------------------------------------------------------------
# replica side: export / import against a live cache
# ---------------------------------------------------------------------------


def _cache_prefix(cache) -> str:
    kg = getattr(cache, "key_generator", None)
    return getattr(kg, "prefix", "") or ""


def export_from_cache(
    cache, membership: Sequence[str], self_id: str, drop: bool = True
) -> List[dict]:
    """Export every live key THIS replica no longer owns under
    ``membership`` (rendezvous over prefix-stripped stems — the exact
    bytes the proxy routes on, cluster/hashing.py).  One section per
    non-empty engine bank: {role, algorithm, keys, stems, expiries,
    state rows}.  ``drop`` releases the exported keys locally.  Each
    bank is copied under cache.run_exclusive like a checkpoint, the
    ownership is decided here, and with ``drop`` a second exclusive leg
    releases the moved keys by slot id (module docstring).  A bank
    whose dispatcher is dead (quarantined) raises its DispatcherDead,
    as in the JAX package."""
    from ..backends.checkpoint import bank_roles, copy_engine

    prefix = _cache_prefix(cache)
    membership = list(membership)

    sections: List[dict] = []
    total = 0
    for role, engine in zip(bank_roles(cache), cache.engines()):
        grabbed: dict = {}

        def grab(e=engine, out=grabbed):
            out["state"], out["entries"] = copy_engine(e)

        cache.run_exclusive(engine, grab)
        copied = grabbed["entries"].arrays()
        # Keys decoded alone and the moved entries selected as arrays
        # (for the release leg too), with no tuple per entry for the
        # cyclic collector to trace.
        all_keys = copied.keys()
        owners = _owners((stem_of_cache_key(k, prefix) for k in all_keys), membership)
        mask = np.fromiter((o != self_id for o in owners), dtype=bool, count=len(owners))
        keys = [all_keys[i] for i in np.flatnonzero(mask).tolist()]
        del all_keys, owners
        if not keys:
            continue
        moved = copied.select(mask)
        if drop:

            def release(e=engine, moved=moved):
                e.release_keys(moved)

            cache.run_exclusive(engine, release)
        total += len(keys)
        sections.append(
            {
                "role": role,
                "algorithm": getattr(engine, "algorithm", "fixed_window"),
                "prefix": prefix,
                "keys": keys,
                "stems": [stem_of_cache_key(k, prefix) for k in keys],
                "expiries": moved.expiries,
                "state": {
                    name: np.asarray(arr)[moved.slots].copy()
                    for name, arr in grabbed["state"].items()
                },
            }
        )
    log = getattr(cache, "handoff_log", None)
    if log is not None:
        log.note_export(
            {
                "keys": total,
                "sections": len(sections),
                "membership": membership,
                "self": self_id,
                "at": time.time(),
            }
        )
    events = getattr(cache, "events", None)
    if events is not None:
        # The replica's half of the handoff timeline (the proxy journal
        # carries begin/end; this replica's journal shows what LEFT it).
        events.emit("handoff_export", keys=total, sections=len(sections))
    logger.warning(
        "handoff export: %d keys across %d banks leave %s",
        total,
        len(sections),
        self_id,
    )
    return sections


#: Keys landed per exclusive leg of an import: one batch assign and one
#: gather and scatter of that many slots, so an import into a full
#: bank interleaves with the bank's launches instead of holding them.
HANDOFF_CHUNK = 16384


def import_into_cache(cache, sections: List[dict], now: Optional[int] = None) -> dict:
    """Land exported sections in THIS replica's banks.  Keys re-route
    to their LOCAL lane (crc32 of the local-prefixed stem — the same
    hash the serving path uses, so an imported counter is found by the
    very next request); per-second and algorithm sections go to their
    dedicated banks.  Sections this replica has no matching bank for
    (algorithm bank not configured, kernel mismatch) are dropped with
    a count — never mis-imported.  Entries whose lease passed at `now`
    are dropped here; the rest land in exclusive legs of HANDOFF_CHUNK
    keys (CounterEngine.land_keys).  Returns {keys, imported, merged,
    dropped}."""
    if now is None:
        now = cache.time_source.unix_now()
    prefix = _cache_prefix(cache)
    n_lanes = len(cache.lanes)
    totals = {"keys": 0, "imported": 0, "merged": 0, "dropped": 0}
    for sec in sections:
        keys = sec["keys"]
        stems = sec["stems"]
        exp = np.asarray(sec["expiries"], dtype=np.int64)
        state = sec["state"]
        algo = sec.get("algorithm", "fixed_window")
        role = sec.get("role", "")
        totals["keys"] += len(keys)
        if role == "per_second":
            eng = cache.per_second_engine
            targets = None if eng is None else [(eng, list(range(len(keys))))]
        elif role.startswith("algo_"):
            eng = cache.algorithm_banks.get(role[len("algo_"):])
            targets = None if eng is None else [(eng, list(range(len(keys))))]
        else:
            # Lane banks: split by the local lane hash.
            groups: Dict[int, List[int]] = {}
            for i, stem in enumerate(stems):
                lane = crc32((prefix + stem).encode("utf-8")) % n_lanes
                groups.setdefault(lane, []).append(i)
                if i % YIELD_EVERY == YIELD_EVERY - 1:
                    time.sleep(0)
            targets = [(cache.lanes[lane], idxs) for lane, idxs in groups.items()]
        if targets is None:
            totals["dropped"] += len(keys)
            continue
        for eng, idxs in targets:
            if getattr(eng, "algorithm", "fixed_window") != algo:
                # Kernel state is not interchangeable (the checkpoint
                # restore guard, applied to handoff).
                totals["dropped"] += len(idxs)
                continue
            idxs = np.asarray(idxs, dtype=np.int64)
            live = idxs[exp[idxs] > now]
            totals["dropped"] += len(idxs) - len(live)
            for lo in range(0, len(live), HANDOFF_CHUNK):
                part = live[lo : lo + HANDOFF_CHUNK]
                res: dict = {}

                def land(
                    e=eng,
                    ks=[keys[i] for i in part],
                    ex=exp[part],
                    st={name: np.asarray(arr)[part] for name, arr in state.items()},
                    out=res,
                ):
                    out.update(e.land_keys(ks, ex, st, now))

                cache.run_exclusive(eng, land)
                for k in ("imported", "merged"):
                    totals[k] += int(res.get(k, 0))
    log = getattr(cache, "handoff_log", None)
    if log is not None:
        log.note_import({**totals, "at": time.time()})
    events = getattr(cache, "events", None)
    if events is not None:
        events.emit("handoff_import", **totals)
    logger.warning("handoff import: %s", totals)
    return totals


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def pack_sections(sections: List[dict]) -> bytes:
    """Serialize sections the checkpoint way (np.savez_compressed, no
    pickle: keys as length-prefixed utf-8 blobs) so import can run
    allow_pickle=False on bytes from another process."""
    meta = {"version": BLOB_VERSION, "sections": []}
    arrays: Dict[str, np.ndarray] = {}
    for si, sec in enumerate(sections):
        key_bytes = [k.encode("utf-8") for k in sec["keys"]]
        arrays[f"s{si}_key_lens"] = np.array(
            [len(b) for b in key_bytes], dtype=np.int64
        )
        arrays[f"s{si}_key_blob"] = np.frombuffer(
            b"".join(key_bytes), dtype=np.uint8
        )
        arrays[f"s{si}_expiries"] = np.asarray(
            sec["expiries"], dtype=np.int64
        )
        for name, arr in sec["state"].items():
            arrays[f"s{si}_state_{name}"] = np.asarray(arr, dtype=np.uint32)
        meta["sections"].append(
            {
                "role": sec["role"],
                "algorithm": sec.get("algorithm", "fixed_window"),
                "prefix": sec.get("prefix", ""),
                "n": len(sec["keys"]),
                "state_rows": sorted(sec["state"]),
            }
        )
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


def unpack_sections(blob: bytes) -> List[dict]:
    """Inverse of pack_sections (stems recomputed from the packed
    prefix, so partitioning on the coordinator needs no extra data)."""
    out: List[dict] = []
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("version") != BLOB_VERSION:
            raise ValueError(
                f"handoff blob version {meta.get('version')!r} != "
                f"{BLOB_VERSION}"
            )
        for si, m in enumerate(meta["sections"]):
            blob_arr = bytes(z[f"s{si}_key_blob"])
            keys: List[str] = []
            off = 0
            for n, ln in enumerate(z[f"s{si}_key_lens"].tolist(), 1):
                keys.append(blob_arr[off : off + ln].decode("utf-8"))
                off += ln
                if n % YIELD_EVERY == 0:
                    time.sleep(0)
            prefix = m.get("prefix", "")
            out.append(
                {
                    "role": m["role"],
                    "algorithm": m.get("algorithm", "fixed_window"),
                    "prefix": prefix,
                    "keys": keys,
                    "stems": [stem_of_cache_key(k, prefix) for k in keys],
                    "expiries": z[f"s{si}_expiries"],
                    "state": {
                        name: z[f"s{si}_state_{name}"]
                        for name in m["state_rows"]
                    },
                }
            )
    return out


def _subset(sec: dict, idxs: List[int]) -> dict:
    return {
        "role": sec["role"],
        "algorithm": sec.get("algorithm", "fixed_window"),
        "prefix": sec.get("prefix", ""),
        "keys": [sec["keys"][i] for i in idxs],
        "stems": [sec["stems"][i] for i in idxs],
        "expiries": np.asarray(sec["expiries"])[idxs],
        "state": {
            name: np.asarray(arr)[idxs] for name, arr in sec["state"].items()
        },
    }


def partition_sections(
    sections: List[dict], new_ids: Sequence[str]
) -> Dict[str, List[dict]]:
    """Split exported sections by each entry's NEW rendezvous owner
    (over the prefix-free stems) — one section list per target
    replica, ready to import."""
    new_ids = list(new_ids)
    out: Dict[str, List[dict]] = {}
    for sec in sections:
        groups: Dict[str, List[int]] = {}
        for i, owner in enumerate(_owners(sec["stems"], new_ids)):
            groups.setdefault(owner, []).append(i)
        for target, idxs in groups.items():
            out.setdefault(target, []).append(_subset(sec, idxs))
    return out


# ---------------------------------------------------------------------------
# coordinator (runs in the proxy, or in a script driving replicas)
# ---------------------------------------------------------------------------


class AdminTransport:
    """One replica's handoff admin surface: `export(membership,
    self_id) -> sections`, `import_(sections) -> {imported, merged,
    dropped}`.  LocalAdminTransport wraps an in-process cache;
    HttpAdminTransport speaks to a replica's debug listener."""

    def export(self, membership: Sequence[str], self_id: str) -> List[dict]:
        raise NotImplementedError

    def import_(self, sections: List[dict]) -> dict:
        raise NotImplementedError


class LocalAdminTransport(AdminTransport):
    """In-process admin transport (tests, smokes):
    drives export/import directly against a cache object."""

    def __init__(self, cache, drop: bool = True):
        self.cache = cache
        self.drop = drop

    def export(self, membership, self_id):
        return export_from_cache(
            self.cache, membership, self_id, drop=self.drop
        )

    def import_(self, sections):
        return import_into_cache(self.cache, sections)


class HttpAdminTransport(AdminTransport):
    """Admin transport over a replica's debug listener
    (`POST /debug/cluster/export` / `POST /debug/cluster/import`,
    server/http_server.py; the replica must run with
    CLUSTER_HANDOFF_ENABLED=1).  The debug listener is the management
    surface (loopback/management interface, never client-facing), the
    same trust model as /debug/profile."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _post(self, path: str, body: bytes, content_type: str) -> bytes:
        import urllib.request

        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            headers={"Content-Type": content_type},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def export(self, membership, self_id):
        body = json.dumps(
            {"membership": list(membership), "self": self_id}
        ).encode("utf-8")
        blob = self._post("/debug/cluster/export", body, "application/json")
        return unpack_sections(blob)

    def import_(self, sections):
        blob = pack_sections(sections)
        out = self._post(
            "/debug/cluster/import", blob, "application/octet-stream"
        )
        return json.loads(out.decode("utf-8"))


def parse_admin_map(spec: str) -> Dict[str, str]:
    """Proxy --replica-admin parser: ``grpc_addr=http://host:port``
    comma list mapping each replica's hash identity to its debug
    listener.  Malformed entries raise (startup config error, not a
    silent no-handoff cluster)."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--replica-admin entry {part!r} is not addr=url"
            )
        rid, url = part.split("=", 1)
        rid, url = rid.strip(), url.strip()
        if not rid or not url:
            raise ValueError(
                f"--replica-admin entry {part!r} is not addr=url"
            )
        out[rid] = url
    return out


class HandoffCoordinator:
    """Drives one membership change's counter movement: export from
    each old owner, partition by new owner, import.  Failures are
    recorded, never fatal — a key whose transfer failed falls back to
    the pre-handoff amnesia envelope (its window restarts), which is
    the safe direction."""

    def __init__(
        self,
        admin_for: Callable[[str], Optional[AdminTransport]],
    ):
        self.admin_for = admin_for

    def run(self, old_ids: Sequence[str], new_ids: Sequence[str]) -> dict:
        t0 = time.monotonic()
        old_ids, new_ids = list(old_ids), list(new_ids)
        summary: dict = {
            "old": old_ids,
            "new": new_ids,
            "moved_keys": 0,
            "imported": 0,
            "merged": 0,
            "dropped": 0,
            "exports": [],
            "errors": [],
        }
        for rid in old_ids:
            admin = self.admin_for(rid)
            if admin is None:
                # A replica without an admin surface (or a dead one)
                # cannot export; its moved keys restart their windows
                # — the documented pre-handoff envelope.
                summary["errors"].append(f"no admin transport for {rid}")
                continue
            try:
                sections = admin.export(new_ids, rid)
            except Exception as e:
                summary["errors"].append(f"export from {rid} failed: {e!r}")
                continue
            moved = sum(len(s["keys"]) for s in sections)
            summary["exports"].append({"from": rid, "keys": moved})
            summary["moved_keys"] += moved
            if not moved:
                continue
            for target, tsections in partition_sections(
                sections, new_ids
            ).items():
                n_target = sum(len(s["keys"]) for s in tsections)
                tadmin = self.admin_for(target) if target != rid else None
                if tadmin is None:
                    summary["errors"].append(
                        f"no admin transport for import target {target}"
                    )
                    summary["dropped"] += n_target
                    continue
                try:
                    res = tadmin.import_(tsections)
                except Exception as e:
                    summary["errors"].append(
                        f"import into {target} failed: {e!r}"
                    )
                    summary["dropped"] += n_target
                    continue
                for k in ("imported", "merged", "dropped"):
                    summary[k] += int(res.get(k, 0))
        summary["duration_s"] = round(time.monotonic() - t0, 6)
        logger.warning(
            "membership handoff %s -> %s: moved=%d imported=%d merged=%d "
            "dropped=%d errors=%d in %.3fs",
            old_ids,
            new_ids,
            summary["moved_keys"],
            summary["imported"],
            summary["merged"],
            summary["dropped"],
            len(summary["errors"]),
            summary["duration_s"],
        )
        return summary
