"""The replica half of the cluster tier (ratelimit_tpu_torch/cluster/)
against the JAX package's, on the CPU.

The replica-side tests of the JAX package's tests/test_cluster_handoff.py
(hashing, export by ownership, import with lane re-routing, merge and
stale drops, the wire format, partitioning, the coordinator, the admin
surface over a real debug listener) and its transport fault injector
run through both packages -- TpuRateLimitCache over the JAX engine and
CudaRateLimitCache over CounterEngine(device="cpu") -- with the JAX
test's checks, and every scenario's observations (codes, remaining,
sections, counts, /debug/cluster bodies, HTTP statuses) must be equal.
Beyond them: owner_of and stem_of_cache_key agree on 10,000 seeded keys
over one to five replicas; blobs cross both ways (the JAX package's
tpu-sharded and algorithm banks into the port's cuda backend, and the
port's into the JAX package's); a quarantined bank refuses an export at
once in both packages, over the admin POST too; the port's two-leg
export never clears a slot that gc gave to another key between its
legs; and the device fault injector keeps one engine identity in the
port's cache as in the JAX package's.
"""

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import ratelimit_tpu.cluster.faults as jax_faults
import ratelimit_tpu.cluster.handoff as jax_ho
import ratelimit_tpu.cluster.hashing as jax_hashing
import ratelimit_tpu_torch.cluster.faults as port_faults
import ratelimit_tpu_torch.cluster.handoff as port_ho
import ratelimit_tpu_torch.cluster.hashing as port_hashing
from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends.dispatcher import DispatcherDead as JaxDispatcherDead
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import RateLimitRule as JaxRule
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.limiter.cache_key import build_stem as jax_build_stem
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu.server import http_server as jax_http
from ratelimit_tpu.stats import manager as jax_manager
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends import engine as port_engine
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.dispatcher import DispatcherDead
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.fault_domain import classify_fault
from ratelimit_tpu_torch.config import RateLimitRule
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.limiter.cache_key import build_stem
from ratelimit_tpu_torch.models.registry import get_algorithm
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.server import http_server
from ratelimit_tpu_torch.stats import manager
from ratelimit_tpu_torch.utils import time as port_time

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    ho=jax_ho,
    hashing=jax_hashing,
    faults=jax_faults,
    Engine=JaxEngine,
    engine_kw={},
    algo=lambda name, ns: jax_algorithm(name).make_model(ns, 0.8),
    Cache=TpuRateLimitCache,
    Rule=JaxRule,
    loader=jax_loader,
    build_stem=jax_build_stem,
    time=jax_time,
    http=jax_http,
    mgr=jax_manager,
    Dead=JaxDispatcherDead,
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    ho=port_ho,
    hashing=port_hashing,
    faults=port_faults,
    Engine=CounterEngine,
    engine_kw={"device": "cpu"},
    algo=lambda name, ns: get_algorithm(name).make_model(ns, 0.8, device="cpu"),
    Cache=CudaRateLimitCache,
    Rule=RateLimitRule,
    loader=loader,
    build_stem=build_stem,
    time=port_time,
    http=http_server,
    mgr=manager,
    Dead=DispatcherDead,
)

NOW = 1_700_000_000  # mid-window nowhere near a minute rollover
#: Fields measured on a wall clock, masked wherever they occur.
WALL_KEYS = {"at", "duration_s"}


def masked(x):
    if isinstance(x, dict):
        return {k: ("<t>" if k in WALL_KEYS else masked(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [masked(v) for v in x]
    if isinstance(x, np.ndarray):
        return [masked(v) for v in x.tolist()]
    if hasattr(x, "name") and hasattr(x, "value"):  # a Code
        return x.name
    return x


def both(scenario, *args):
    """Run `scenario(P, *args)` through each package; the observations
    must be equal.  Returns the port's."""
    want = masked(scenario(JAX, *args))
    got = masked(scenario(PORT, *args))
    assert got == want
    return got


def make_cache(P, n_lanes=1, per_second=False, clock=None, prefix="", native=None, **kw):
    def engine():
        return P.Engine(num_slots=1 << 10, buckets=(8, 32), native_table=native, **P.engine_kw)

    lanes = [engine() for _ in range(n_lanes)]
    return P.Cache(
        lanes if n_lanes > 1 else lanes[0],
        clock or P.time.PinnedTimeSource(NOW),
        per_second_engine=engine() if per_second else None,
        cache_key_prefix=prefix,
        **kw,
    )


def make_rule(P, mgr, key="domain.key_value", rpu=10, unit="MINUTE"):
    return P.Rule(
        full_key=key,
        limit=P.api.RateLimit(rpu, getattr(P.api.Unit, unit)),
        stats=mgr.rate_limit_stats(key),
    )


def hit(P, cache, rule, desc, times=1, hits=0):
    out = []
    for _ in range(times):
        [st] = cache.do_limit(P.api.RateLimitRequest("domain", [desc], hits), [rule])
        out.append((st.code.name, st.limit_remaining))
    return out


def codes(log):
    return [c for c, _ in log]


def desc(P, value, key="key"):
    return P.api.Descriptor.of((key, value))


def stem_for(P, d, domain="domain", prefix=""):
    return P.build_stem(prefix, domain, d.entries)


def sections_view(sections):
    """The sections with each one's entries in key order: a C slot
    table lists its entries in its own hash order."""
    out = []
    for s in sections:
        order = np.argsort(np.array(s["keys"], dtype=object), kind="stable")
        out.append(
            dict(
                role=s["role"],
                algorithm=s["algorithm"],
                prefix=s["prefix"],
                keys=[s["keys"][i] for i in order],
                stems=[s["stems"][i] for i in order],
                expiries=np.asarray(s["expiries"])[order].tolist(),
                state={n: np.asarray(a)[order].tolist() for n, a in sorted(s["state"].items())},
            )
        )
    return out


# -- hashing ----------------------------------------------------------------


def test_stem_of_cache_key_strips_window_and_prefix():
    def scenario(P):
        f = P.hashing.stem_of_cache_key
        out = [
            f("d_k_v_1700000040"),
            f("p:d_k_v_1700000040", "p:"),
            f("d_k_a_b_9_1700000040"),
            f("d_k_v_"),
        ]
        assert out == ["d_k_v_", "d_k_v_", "d_k_a_b_9_", "d_k_v_"]
        return out

    both(scenario)


def test_owner_of_and_stems_agree_on_seeded_keys():
    """10,000 seeded cache keys (values with underscores, prefixes,
    stable stems) over membership of 1 to 5 replicas: the port's stem,
    owner index and routing key equal the JAX package's."""
    rng = np.random.default_rng(2026)
    alphabet = np.array(list("abcxyz_019:"))
    ids = [f"10.0.0.{i}:8081" for i in range(1, 6)]
    for n in range(10_000):
        value = "".join(rng.choice(alphabet, size=int(rng.integers(1, 12))))
        prefix = "" if n % 3 else "px:"
        key = f"{prefix}dom_k_{value}_" + ("" if n % 7 == 0 else str(1_700_000_000 + n))
        stem = port_hashing.stem_of_cache_key(key, prefix)
        assert stem == jax_hashing.stem_of_cache_key(key, prefix)
        members = ids[: 1 + n % 5]
        assert port_hashing.owner_of(stem, members) == jax_hashing.owner_of(stem, members)
        assert port_hashing.owner_id(stem, members) == jax_hashing.owner_id(stem, members)
    d_port, d_jax = desc(PORT, "a_b"), desc(JAX, "a_b")
    assert port_hashing.routing_key("dom", d_port) == jax_hashing.routing_key("dom", d_jax)


def test_handoff_owner_pass_equals_owner_id():
    """The handoff's yielding owner pass (digests compared as bytes)
    gives the JAX package's owner_id on seeded stems, ties included."""
    rng = np.random.default_rng(7)
    stems = [f"d_k_{int(v)}_" for v in rng.integers(0, 1 << 40, 3000)] + ["", "é_ü_"]
    for ids in (["A"], ["A", "B"], ["10.0.0.1:8081", "10.0.0.2:8081", "x"], ["B", "A", "A"]):
        assert port_ho._owners(stems, ids) == [jax_hashing.owner_id(s, ids) for s in stems]


# -- engine/cache export + import --------------------------------------------


def test_handoff_preserves_counter_no_window_restart():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P), make_cache(P)
        rule = make_rule(P, mgr)
        d = desc(P, "value")
        try:
            log = [hit(P, a, rule, d, 6)]
            sections = P.ho.export_from_cache(a, ["B"], "A")
            assert sum(len(s["keys"]) for s in sections) == 1
            res = P.ho.import_into_cache(b, sections)
            assert res["imported"] == 1 and res["dropped"] == 0
            log.append(hit(P, b, rule, d, 5))
            assert codes(log[-1]) == ["OK"] * 4 + ["OVER_LIMIT"]
            log.append(hit(P, a, rule, d, 1, hits=0))
            assert log[-1] == [("OK", 9)]
            assert a.handoff_log.snapshot()["exported_keys"] == 1
            assert b.handoff_log.snapshot()["imported_keys"] == 1
            return log, sections_view(sections), res, a.handoff_log.snapshot(), b.handoff_log.snapshot()
        finally:
            a.close()
            b.close()

    both(scenario)


@pytest.mark.parametrize("native", [None, False], ids=["native_table", "python_table"])
def test_export_is_ownership_selective(native):
    def scenario(P):
        mgr = P.mgr.Manager()
        a = make_cache(P, native=native)
        rule = make_rule(P, mgr)
        membership = ["A", "B"]
        mine, moved = [], []
        for i in range(40):
            d = desc(P, f"v{i}")
            owner = P.hashing.owner_id(stem_for(P, d), membership)
            (mine if owner == "A" else moved).append(d)
        assert mine and moved
        try:
            for d in mine + moved:
                hit(P, a, rule, d, 1)
            sections = P.ho.export_from_cache(a, membership, "A")
            exported = {k for s in sections for k in s["stems"]}
            assert exported == {stem_for(P, d) for d in moved}
            # The moved keys left A (a hit there starts afresh); the
            # kept ones still count there.
            after = [hit(P, a, rule, d, 1)[0] for d in mine + moved]
            assert after == [("OK", 8)] * len(mine) + [("OK", 9)] * len(moved)
            return sections_view(sections), len(a.engine.slot_table)
        finally:
            a.close()

    assert both(scenario)[1] == 40


def test_import_merges_counts_when_both_sides_counted():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P), make_cache(P)
        rule = make_rule(P, mgr)
        d = desc(P, "value")
        try:
            hit(P, a, rule, d, 6)
            hit(P, b, rule, d, 3)
            res = P.ho.import_into_cache(b, P.ho.export_from_cache(a, ["B"], "A"))
            assert res["merged"] == 1 and res["imported"] == 0
            after = hit(P, b, rule, d, 2)
            assert codes(after) == ["OK", "OVER_LIMIT"]
            return res, after
        finally:
            a.close()
            b.close()

    both(scenario)


def test_import_drops_expired_entries():
    def scenario(P):
        mgr = P.mgr.Manager()
        clock_b = P.time.PinnedTimeSource(NOW)
        a, b = make_cache(P), make_cache(P, clock=clock_b)
        rule = make_rule(P, mgr)
        d = desc(P, "value")
        try:
            hit(P, a, rule, d, 10)
            sections = P.ho.export_from_cache(a, ["B"], "A")
            clock_b.advance(3600)
            res = P.ho.import_into_cache(b, sections)
            assert res["dropped"] == 1 and res["imported"] == 0
            after = hit(P, b, rule, d, 1, hits=0)
            assert codes(after) == ["OK"]
            return res, after
        finally:
            a.close()
            b.close()

    both(scenario)


def test_import_reroutes_to_local_lanes():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P, n_lanes=1), make_cache(P, n_lanes=2)
        rule = make_rule(P, mgr)
        descs = [desc(P, f"v{i}") for i in range(16)]
        try:
            for d in descs:
                hit(P, a, rule, d, 6)
            res = P.ho.import_into_cache(b, P.ho.export_from_cache(a, ["B"], "A"))
            logs = [hit(P, b, rule, d, 5) for d in descs]
            for log in logs:
                assert codes(log) == ["OK"] * 4 + ["OVER_LIMIT"]
            sizes = [len(b.lanes[0].slot_table), len(b.lanes[1].slot_table)]
            assert all(sizes)
            return res, logs, sizes
        finally:
            a.close()
            b.close()

    both(scenario)


def test_import_routes_per_second_bank():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P, per_second=True), make_cache(P, per_second=True)
        rule = make_rule(P, mgr, rpu=10, unit="SECOND")
        d = desc(P, "value")
        try:
            hit(P, a, rule, d, 6)
            sections = P.ho.export_from_cache(a, ["B"], "A")
            assert [s["role"] for s in sections] == ["per_second"]
            P.ho.import_into_cache(b, sections)
            after = hit(P, b, rule, d, 5)
            assert codes(after) == ["OK"] * 4 + ["OVER_LIMIT"]
            return sections_view(sections), after
        finally:
            a.close()
            b.close()

    both(scenario)


def test_import_drops_sections_with_no_matching_bank():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P, per_second=True), make_cache(P, per_second=False)
        rule = make_rule(P, mgr, rpu=10, unit="SECOND")
        try:
            hit(P, a, rule, desc(P, "value"), 3)
            res = P.ho.import_into_cache(b, P.ho.export_from_cache(a, ["B"], "A"))
            assert res["dropped"] == 1 and res["imported"] == 0
            return res
        finally:
            a.close()
            b.close()

    both(scenario)


def test_import_refuses_algorithm_mismatch():
    def scenario(P):
        b = make_cache(P)
        sec = {
            "role": "lane0of1",
            "algorithm": "gcra",
            "prefix": "",
            "keys": ["domain_key_value_1700000040"],
            "stems": ["domain_key_value_"],
            "expiries": np.array([NOW + 600], dtype=np.int64),
            "state": {"counts": np.array([5], dtype=np.uint32)},
        }
        try:
            res = P.ho.import_into_cache(b, [sec])
            assert res["dropped"] == 1 and res["imported"] == 0
            return res
        finally:
            b.close()

    both(scenario)


# -- algorithm banks --------------------------------------------------------

ALGO_YAML = """
domain: domain
descriptors:
  - key: fw
    rate_limit: {unit: minute, requests_per_unit: 10}
  - key: sw
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: sliding_window}
  - key: tb
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: gcra}
"""


def algo_cache(P, clock=None):
    banks = {
        name: P.Engine(num_slots=1 << 10, buckets=(8, 32), model=P.algo(name, 1 << 10), **P.engine_kw)
        for name in ("sliding_window", "gcra")
    }
    return make_cache(P, clock=clock, algorithm_banks=banks)


def resolved(P, cache, cfg, key, value, times):
    out = []
    for _ in range(times):
        req = P.api.RateLimitRequest("domain", [P.api.Descriptor.of((key, value))], 1)
        [st], _, _ = cache.do_limit_resolved(req, cfg)
        out.append((st.code.name, st.limit_remaining))
    return out


def test_algorithm_sections_move_with_their_state():
    """Sliding-window and GCRA keys leave in algo_* sections carrying
    their state rows and continue exactly on the new owner."""

    def scenario(P):
        cfg = P.loader.load_config([P.loader.ConfigFile("config.a", ALGO_YAML)], P.mgr.Manager())
        a, b = algo_cache(P), algo_cache(P)
        try:
            for key in ("fw", "sw", "tb"):
                resolved(P, a, cfg, key, "x", 6)
            sections = P.ho.export_from_cache(a, ["B"], "A")
            assert sorted(s["role"] for s in sections) == ["algo_gcra", "algo_sliding_window", "lane0of1"]
            res = P.ho.import_into_cache(b, sections)
            after = {key: resolved(P, b, cfg, key, "x", 5) for key in ("fw", "sw", "tb")}
            for log in after.values():
                assert codes(log) == ["OK"] * 4 + ["OVER_LIMIT"]
            return sections_view(sorted(sections, key=lambda s: s["role"])), res, after
        finally:
            a.close()
            b.close()

    both(scenario)


# -- wire format + partitioning ---------------------------------------------


def test_pack_unpack_roundtrip():
    def scenario(P):
        mgr = P.mgr.Manager()
        a = make_cache(P, prefix="px:")
        rule = make_rule(P, mgr)
        try:
            for i in range(5):
                hit(P, a, rule, desc(P, f"v{i}"), i + 1)
            sections = P.ho.export_from_cache(a, ["B"], "A")
            back = P.ho.unpack_sections(P.ho.pack_sections(sections))
            assert sections_view(back) == sections_view(sections)
            return sections_view(back)
        finally:
            a.close()

    both(scenario)


def test_unpack_rejects_unknown_version():
    import io

    meta = {"version": 99, "sections": []}
    buf = io.BytesIO()
    np.savez_compressed(buf, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))

    def scenario(P):
        with pytest.raises(ValueError) as e:
            P.ho.unpack_sections(buf.getvalue())
        assert P.ho.unpack_sections(P.ho.pack_sections([])) == []
        return str(e.value), P.ho.BLOB_VERSION

    both(scenario)


def test_partition_sections_by_new_owner():
    new_ids = ["A", "B", "C"]
    stems = [f"d_k_v{i}_" for i in range(30)]
    sec = {
        "role": "lane0of1",
        "algorithm": "fixed_window",
        "prefix": "",
        "keys": [s + "123" for s in stems],
        "stems": stems,
        "expiries": np.arange(30, dtype=np.int64),
        "state": {"counts": np.arange(30, dtype=np.uint32)},
    }

    def scenario(P):
        parts = P.ho.partition_sections([sec], new_ids)
        seen = {}
        for target, tsections in parts.items():
            for ts in tsections:
                for stem, cnt in zip(ts["stems"], ts["state"]["counts"]):
                    assert P.hashing.owner_id(stem, new_ids) == target
                    seen[stem] = int(cnt)
        assert seen == {s: i for i, s in enumerate(stems)}
        return {t: sections_view(ts) for t, ts in sorted(parts.items())}

    both(scenario)


BLOB_YAML = ALGO_YAML + "  - key: ps\n    rate_limit: {unit: second, requests_per_unit: 10}\n"
BLOB_KEYS = [("fw", f"v{i}") for i in range(12)] + [("sw", "s"), ("tb", "t"), ("ps", "p")]


def blob_replica(P, sharded=False):
    """Two fixed-window lanes, the per-second bank and both algorithm
    banks; `sharded` makes the lanes and the per-second bank
    bank-sharded tables over 8 banks (tpu-sharded / cuda-sharded)."""

    def lane():
        if sharded and P is JAX:
            return JaxShardedEngine(jax_make_mesh(8), num_slots=1 << 10, buckets=(8, 32))
        if sharded:
            return ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=1 << 10, buckets=(8, 32))
        return P.Engine(num_slots=1 << 10, buckets=(8, 32), **P.engine_kw)

    banks = {
        name: P.Engine(num_slots=1 << 10, buckets=(8, 32), model=P.algo(name, 1 << 10), **P.engine_kw)
        for name in ("sliding_window", "gcra")
    }
    return P.Cache(
        [lane(), lane()], P.time.PinnedTimeSource(NOW), per_second_engine=lane(), algorithm_banks=banks
    )


def blob_cross(src_P, dst_P, src_sharded=False):
    """Fill a `src_P` replica (4 hits a key), export everything into a
    blob, land it in a `dst_P` replica; returns the exported sections,
    the import result and each key's next 7 answers there."""
    src, dst = blob_replica(src_P, src_sharded), blob_replica(dst_P)
    scfg = src_P.loader.load_config([src_P.loader.ConfigFile("c", BLOB_YAML)], src_P.mgr.Manager())
    dcfg = dst_P.loader.load_config([dst_P.loader.ConfigFile("c", BLOB_YAML)], dst_P.mgr.Manager())
    try:
        for key, value in BLOB_KEYS:
            resolved(src_P, src, scfg, key, value, 4)
        sections = src_P.ho.export_from_cache(src, ["B"], "A")
        blob = src_P.ho.pack_sections(sections)
        res = dst_P.ho.import_into_cache(dst, dst_P.ho.unpack_sections(blob))
        rest = {f"{k}/{v}": codes(resolved(dst_P, dst, dcfg, k, v, 7)) for k, v in BLOB_KEYS}
        return sorted(sections_view(sections), key=lambda s: s["role"]), res, rest
    finally:
        src.close()
        dst.close()


REST = ["OK"] * 6 + ["OVER_LIMIT"]


@pytest.mark.parametrize(
    "src,dst,sharded",
    [(JAX, PORT, False), (PORT, JAX, False), (PORT, JAX, True)],
    ids=["jax_tpu_to_port_cuda", "port_cuda_to_jax_tpu", "port_cuda_sharded_to_jax_tpu"],
)
def test_blobs_cross_between_the_packages(src, dst, sharded):
    """A blob packed by either package's replica (fixed-window lanes,
    the per-second bank, sliding-window and GCRA banks) lands in the
    other's: every key admits exactly the rest of its limit there, and
    the sections equal those the destination's own package exports."""
    sections, res, rest = blob_cross(src, dst, sharded)
    assert res == {"keys": len(BLOB_KEYS), "imported": len(BLOB_KEYS), "merged": 0, "dropped": 0}
    assert rest == {f"{k}/{v}": REST for k, v in BLOB_KEYS}
    assert masked(sections) == masked(blob_cross(dst, dst, False)[0])


def test_blob_of_a_jax_tpu_sharded_replica_lands_as_in_the_jax_package():
    """A JAX tpu-sharded replica's blob lands in the port's cuda replica
    exactly as in the JAX package's tpu replica: the same import result
    and the same answers for every key.  (Its counts are the JAX
    engine's export_state of a banked table, read in bank-major order:
    a fault of the reference recorded in ROADMAP.md, Queue 3.  The
    port's cuda-sharded export reads the table in global slot order and
    is exact, test_blobs_cross_between_the_packages.)"""
    jax_sections, jax_res, jax_rest = blob_cross(JAX, JAX, src_sharded=True)
    port_sections, port_res, port_rest = blob_cross(JAX, PORT, src_sharded=True)
    assert masked(port_sections) == masked(jax_sections)
    assert port_res == jax_res and port_rest == jax_rest


# -- the port's two-leg export ------------------------------------------------


def export_with(cache, between_legs):
    """export_from_cache(cache, ["B"], "A") with `between_legs()` run
    after the copy leg and before the release leg, outside both."""
    run = cache.run_exclusive
    calls = []

    def run_exclusive(engine, fn):
        calls.append(fn)
        if len(calls) == 2:
            between_legs()
        return run(engine, fn)

    cache.run_exclusive = run_exclusive
    try:
        return port_ho.export_from_cache(cache, ["B"], "A")
    finally:
        del cache.run_exclusive
        assert len(calls) == 2


@pytest.mark.parametrize("native", [None, False], ids=["native_table", "python_table"])
def test_release_leg_spares_a_slot_gc_gave_to_another_key(native):
    """Between the export's copy and its release, gc reclaims a moved
    key and its slot goes to another key, and a second moved key takes
    one more hit.  The release leg leaves the reassigned slot and its
    state alone, and releases (zeroes) the key that was only hit again:
    that hit is forgiven, inside the reference's envelope."""
    mgr = manager.Manager()
    a = make_cache(PORT, native=native)
    rule = make_rule(PORT, mgr)
    gone, again = desc(PORT, "gone"), desc(PORT, "again")
    try:
        hit(PORT, a, rule, gone, 3)
        hit(PORT, a, rule, again, 2)
        eng = a.engine
        by_key = {k: (s, e) for k, s, e in eng.slot_table.entries()}
        gone_key = next(k for k in by_key if "gone" in k)
        slot, expiry = by_key[gone_key]

        def between_legs():
            eng.gc(expiry)  # the window of "gone" ended (as has "again"'s)
            got, fresh = eng.slot_table.assign("other_key_1700000040", NOW, NOW + 3600)
            assert (got, fresh) == (slot, True)
            eng.write_slots([slot], {"counts": np.array([7], np.uint32)})

        sections = export_with(a, between_legs)
        entries = {k: (s, e) for k, s, e in eng.slot_table.entries()}
        assert entries == {"other_key_1700000040": (slot, NOW + 3600)}
        assert eng.read_slots([slot])["counts"].tolist() == [7]
        counts = dict(zip(sections[0]["keys"], sections[0]["state"]["counts"].tolist()))
        assert sorted(counts.values()) == [2, 3]
    finally:
        a.close()


@pytest.mark.parametrize("native", [None, False], ids=["native_table", "python_table"])
def test_release_leg_forgives_a_hit_between_the_legs(native):
    mgr = manager.Manager()
    a = make_cache(PORT, native=native)
    rule = make_rule(PORT, mgr)
    d = desc(PORT, "value")
    try:
        hit(PORT, a, rule, d, 4)
        eng = a.engine
        # A hit lands on the old owner between the legs, in the same slot.
        sections = export_with(a, lambda: hit(PORT, a, rule, d, 1))
        assert sections[0]["state"]["counts"].tolist() == [4]
        assert len(eng.slot_table) == 0
        assert eng.export_state()["counts"].sum() == 0
    finally:
        a.close()


@pytest.mark.parametrize("chunk", [1, 3, 16384])
def test_import_lands_alike_in_any_chunk_size(monkeypatch, chunk):
    """The import lands its keys in exclusive legs of HANDOFF_CHUNK: the
    result and every key's answers do not depend on the leg size."""
    monkeypatch.setattr(port_ho, "HANDOFF_CHUNK", chunk)
    mgr = manager.Manager()
    a, b = make_cache(PORT), make_cache(PORT, n_lanes=2)
    rule = make_rule(PORT, mgr)
    descs = [desc(PORT, f"v{i}") for i in range(10)]
    try:
        for i, d in enumerate(descs):
            hit(PORT, a, rule, d, 1 + i % 4)
        hit(PORT, b, rule, descs[0], 2)  # merges
        res = port_ho.import_into_cache(b, port_ho.export_from_cache(a, ["B"], "A"))
        assert res == {"keys": 10, "imported": 9, "merged": 1, "dropped": 0}
        left = [hit(PORT, b, rule, d, 1)[0][1] for d in descs]
        assert left == [10 - 1 - 2 - 1] + [10 - (1 + i % 4) - 1 for i in range(1, 10)]
    finally:
        a.close()
        b.close()


def test_native_release_frees_only_exact_matches():
    """The C release leg (csrc/slot_release.cpp) frees a slot only where
    the table holds the same key in the same slot with the same
    expiry."""
    from ratelimit_tpu_torch.backends import native_slot_table
    from ratelimit_tpu_torch.backends.slot_table import EntryArrays

    if not native_slot_table.available():
        pytest.skip("no native slot table library on this machine")
    t = native_slot_table.NativeSlotTable(16)
    slots, _ = t.assign_batch(["a_1", "b_1", "c_1"], NOW, [NOW + 60, NOW + 60, NOW + 60])
    sa, sb, sc = (int(x) for x in slots)
    moved = EntryArrays.from_entries(
        [("a_1", sa, NOW + 60), ("b_1", sb, NOW + 61), ("c_1", sa, NOW + 60), ("d_1", sc, NOW + 60)]
    )
    assert t.release_arrays(moved).tolist() == [sa]
    assert sorted(k for k, _s, _e in t.entries()) == ["b_1", "c_1"]
    slot, fresh = t.assign("e_1", NOW, NOW + 60)
    assert (slot, fresh) == (sa, True)  # the freed slot is reused


@pytest.mark.parametrize("refresh", [False, True])
def test_python_release_has_the_native_contract(refresh):
    """SlotTable.release_arrays frees what the C release frees: the same
    key in the same slot with the same expiry.  A refreshing table
    (sliding window, GCRA) also frees a key whose lease a touch
    extended past the copied expiry."""
    from ratelimit_tpu_torch.backends.slot_table import EntryArrays, SlotTable

    t = SlotTable(16, refresh_expiry=refresh)
    slots, _ = t.assign_batch(["a_", "b_", "c_"], NOW, [NOW + 60, NOW + 62, NOW + 60])
    sa, sb, sc = (int(x) for x in slots)
    moved = EntryArrays.from_entries(
        [("a_", sa, NOW + 60), ("b_", sb, NOW + 61), ("c_", sa, NOW + 60), ("d_", sc, NOW + 60)]
    )
    freed = t.release_arrays(moved)
    assert freed.dtype == np.int64
    assert freed.tolist() == ([sa, sb] if refresh else [sa])
    assert sorted(k for k, _s, _e in t.entries()) == (["c_"] if refresh else ["b_", "c_"])


def test_land_keys_merges_duplicates_as_one_at_a_time():
    """The import leg lands a batch with a key twice as the reference's
    per-key loop does: the first lands, the second merges."""
    e = CounterEngine(num_slots=64, buckets=(8,), device="cpu")
    je = JaxEngine(num_slots=64, buckets=(8,))
    keys = ["k1_1", "k2_1", "k1_1", "k3_1"]
    exp = [NOW + 60] * 4
    state = {"counts": np.array([3, 0xFFFFFFF0, 0x20, 5], np.uint32)}
    je.import_keys({"counts": state["counts"][:2]}, list(zip(keys[:2], exp[:2])), NOW)
    e.land_keys(keys[:2], exp[:2], {"counts": state["counts"][:2]}, NOW)
    res_j = je.import_keys({"counts": state["counts"][1:]}, list(zip(keys[1:], exp[1:])), NOW)
    res_p = e.land_keys(keys[1:], exp[1:], {"counts": state["counts"][1:]}, NOW)
    assert res_p == {k: res_j[k] for k in ("imported", "merged")}
    view = lambda eng: {  # noqa: E731
        k: int(eng.export_state()["counts"][s]) for k, s, _ in eng.slot_table.entries()
    }
    assert view(e) == view(je) == {"k1_1": 0x23, "k2_1": 0xFFFFFFFF, "k3_1": 5}


# -- coordinator --------------------------------------------------------------


def test_coordinator_moves_keys_to_their_new_owner():
    def scenario(P):
        mgr = P.mgr.Manager()
        caches = {rid: make_cache(P) for rid in ("A", "B", "C")}
        rule = make_rule(P, mgr)
        old_ids, new_ids = ["A", "B"], ["A", "B", "C"]
        moved = []
        try:
            for i in range(60):
                d = desc(P, f"v{i}")
                stem = stem_for(P, d)
                hit(P, caches[P.hashing.owner_id(stem, old_ids)], rule, d, 6)
                if P.hashing.owner_id(stem, new_ids) == "C":
                    moved.append(d)
            assert moved
            admins = {rid: P.ho.LocalAdminTransport(c) for rid, c in caches.items()}
            summary = P.ho.HandoffCoordinator(admins.get).run(old_ids, new_ids)
            assert summary["moved_keys"] == summary["imported"] == len(moved)
            assert summary["errors"] == []
            logs = [hit(P, caches["C"], rule, d, 5) for d in moved]
            for log in logs:
                assert codes(log) == ["OK"] * 4 + ["OVER_LIMIT"]
            return summary, logs
        finally:
            for c in caches.values():
                c.close()

    both(scenario)


def test_coordinator_survives_dead_exporter():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, c = make_cache(P), make_cache(P)
        rule = make_rule(P, mgr)
        hit(P, a, rule, desc(P, "v1"), 3)

        def boom(membership, self_id):
            raise OSError("connection refused")

        class DeadAdmin(P.ho.AdminTransport):
            export = staticmethod(boom)

        admins = {"A": P.ho.LocalAdminTransport(a), "B": DeadAdmin(), "C": P.ho.LocalAdminTransport(c)}
        try:
            summary = P.ho.HandoffCoordinator(admins.get).run(["A", "B"], ["C"])
            assert any("export from B failed" in e for e in summary["errors"])
            assert summary["moved_keys"] >= 1
            return summary
        finally:
            a.close()
            c.close()

    both(scenario)


def test_parse_admin_map():
    def scenario(P):
        got = P.ho.parse_admin_map(" a:1=http://h:1 , b:2=http://h:2,")
        for bad in ("nourl", "=http://x", "a="):
            with pytest.raises(ValueError):
                P.ho.parse_admin_map(bad)
        return got

    assert both(scenario) == {"a:1": "http://h:1", "b:2": "http://h:2"}


# -- admin surface over the real debug listener -------------------------------


class _ServiceStub:
    def __init__(self, cache):
        self.cache = cache

    def get_current_config(self):
        return None


def _debug_server(P, cache, enabled=True):
    srv = P.http.HttpServer("127.0.0.1", 0, name="debug-test")
    P.http.add_debug_routes(srv, P.mgr.Manager().store, _ServiceStub(cache), cluster_handoff_enabled=enabled)
    srv.start()
    return srv


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_admin_roundtrip_and_debug_cluster():
    def scenario(P):
        mgr = P.mgr.Manager()
        a, b = make_cache(P), make_cache(P)
        rule = make_rule(P, mgr)
        d = desc(P, "value")
        hit(P, a, rule, d, 6)
        sa, sb = _debug_server(P, a), _debug_server(P, b)
        try:
            ta = P.ho.HttpAdminTransport(f"http://127.0.0.1:{sa.bound_port}")
            tb = P.ho.HttpAdminTransport(f"http://127.0.0.1:{sb.bound_port}")
            sections = ta.export(["B"], "A")
            res = tb.import_(sections)
            assert res["imported"] == 1
            after = hit(P, b, rule, d, 5)
            assert codes(after) == ["OK"] * 4 + ["OVER_LIMIT"]
            views = [json.loads(_http(s.bound_port, "/debug/cluster")[1]) for s in (sa, sb)]
            assert views[1]["handoff_enabled"] is True
            assert views[1]["handoff"]["imported_keys"] == 1
            assert views[1]["handoff"]["last_import"]["imported"] == 1
            bad = _http(sa.bound_port, "/debug/cluster/export", b"not json")
            badblob = _http(sb.bound_port, "/debug/cluster/import", b"not a blob")
            assert bad[0] == badblob[0] == 400
            return sections_view(sections), res, after, views, bad[0], badblob[0]
        finally:
            sa.stop()
            sb.stop()
            a.close()
            b.close()

    both(scenario)


def test_admin_posts_gated_by_setting():
    def scenario(P):
        cache = make_cache(P)
        srv = _debug_server(P, cache, enabled=False)
        try:
            body = json.dumps({"membership": ["B"], "self": "A"}).encode()
            export = _http(srv.bound_port, "/debug/cluster/export", body)
            imp = _http(srv.bound_port, "/debug/cluster/import", b"x")
            view = _http(srv.bound_port, "/debug/cluster")
            assert export[0] == imp[0] == 403 and json.loads(view[1])["handoff_enabled"] is False
            return export, imp, view
        finally:
            srv.stop()
            cache.close()

    both(scenario)


def test_admin_posts_on_a_backend_without_handoff():
    """Write-behind and memory have no handoff log: the POSTs answer
    the JAX server's 404 and the view a null summary."""

    def scenario(P):
        srv = _debug_server(P, object(), enabled=True)
        try:
            body = json.dumps({"membership": ["B"], "self": "A"}).encode()
            out = [
                _http(srv.bound_port, "/debug/cluster/export", body),
                _http(srv.bound_port, "/debug/cluster/import", b"x"),
                _http(srv.bound_port, "/debug/cluster"),
            ]
            assert out[0][0] == out[1][0] == 404
            return out
        finally:
            srv.stop()

    both(scenario)


# -- a quarantined bank -------------------------------------------------------


def test_export_from_a_quarantined_bank_fails_fast():
    """A bank quarantined by the fault domain has a dead dispatcher:
    run_exclusive raises DispatcherDead at once in both packages, so the
    export raises and the admin POST answers 500 instead of hanging."""

    def scenario(P):
        inj = P.faults.DeviceFaultInjector()
        eng = inj.wrap_engine("lane0", P.Engine(num_slots=256, buckets=(8,), **P.engine_kw))
        cache = P.Cache(
            eng,
            time_source=P.time.PinnedTimeSource(NOW),
            batch_window_us=100,
            kernel_deadline_s=0.25,
            fault_interval_s=0,
            fault_restart_backoff_s=1000.0,
            fault_clock=P.time.FakeMonotonicClock(100.0),
        )
        mgr = P.mgr.Manager()
        rule = make_rule(P, mgr)
        srv = _debug_server(P, cache, enabled=True)
        try:
            first = hit(P, cache, rule, desc(P, "v"), 2)
            inj.raise_error("lane0")
            during = hit(P, cache, rule, desc(P, "v"), 1)
            assert cache.fault_domain.is_quarantined(0)
            t0 = time.monotonic()
            with pytest.raises(P.Dead):
                P.ho.export_from_cache(cache, ["B"], "A")
            body = json.dumps({"membership": ["B"], "self": "A"}).encode()
            status, _ = _http(srv.bound_port, "/debug/cluster/export", body)
            assert status == 500
            assert time.monotonic() - t0 < 5.0
            return first, during, status, dict(cache.fault_domain.stat_faults)
        finally:
            inj.heal()
            srv.stop()
            cache.close()

    both(scenario)


# -- fault injectors ---------------------------------------------------------


def test_fault_injector_modes():
    def scenario(P):
        inj = P.faults.FaultInjector(sleep=lambda s: None)
        log = []

        def inner(req, timeout_s=None):
            log.append(timeout_s)
            return "resp"

        t = inj.wrap("r1", inner)
        out = [t("req")]
        inj.kill("r1")
        with pytest.raises(P.faults.FaultStatusError) as ei:
            t("req")
        out.append(ei.value.code().name)
        inj.heal("r1")
        out.append(t("req"))
        waits = []
        inj2 = P.faults.FaultInjector(sleep=waits.append)
        t2 = inj2.wrap("r1", inner)
        inj2.hang("r1", 3600.0)
        with pytest.raises(P.faults.FaultStatusError) as ei:
            t2("req", timeout_s=7.0)
        out.append(ei.value.code().name)
        assert waits == [7.0]
        inj2.delay("r1", 0.5)
        out.append(t2("req"))
        inj2.partition("r1", "r2")
        out.append((inj2.mode_of("r2"), waits, log, inj.stat_injected, inj2.stat_injected))
        assert out[:5] == ["resp", "UNAVAILABLE", "resp", "DEADLINE_EXCEEDED", "resp"]
        return out

    both(scenario)


def test_device_fault_injector_keeps_one_engine_identity():
    """The engine proxy is the bank's identity in both caches (engines,
    dispatcher and inline-lock keys, the fault domain's bank), its
    faults classify alike, and a supervised restart builds a plain
    engine in its place in both packages."""

    def scenario(P):
        inj = P.faults.DeviceFaultInjector()
        clock = P.time.FakeMonotonicClock(100.0)
        eng = inj.wrap_engine("lane0", P.Engine(num_slots=256, buckets=(8,), **P.engine_kw))
        cache = P.Cache(
            eng,
            time_source=P.time.PinnedTimeSource(NOW),
            batch_window_us=100,
            kernel_deadline_s=0.25,
            fault_interval_s=0,
            fault_restart_backoff_s=0.05,
            fault_snapshot_interval_s=1000.0,
            fault_probe_timeout_s=10.0,
            fault_clock=clock,
        )
        rule = make_rule(P, P.mgr.Manager())
        fd = cache.fault_domain
        try:
            ids = (
                cache.engines()[0] is eng,
                id(eng) in cache._dispatchers,
                id(eng) in cache._inline_locks,
                fd.engine_at(0) is eng,
            )
            assert ids == (True,) * 4
            log = hit(P, cache, rule, desc(P, "v"), 2)
            inj.device_lost("lane0", at="complete")
            log += hit(P, cache, rule, desc(P, "v"), 2)
            faults = dict(fd.stat_faults)
            inj.heal()
            for _ in range(50):
                if not fd.is_quarantined(0):
                    break
                clock.advance(0.06)
                fd.tick()
            restarted = fd.engine_at(0)
            log += hit(P, cache, rule, desc(P, "v"), 2)
            return (
                log,
                faults,
                fd.is_quarantined(0),
                type(restarted).__name__,
                restarted is cache.engines()[0],
                inj.stat_injected,
            )
        finally:
            inj.heal()
            cache.close()

    got = both(scenario)
    assert got[1]["device_lost"] == 1 and got[2] is False and got[3] == "CounterEngine"
    assert classify_fault(port_faults.DeviceLostError("lane0")) == "device_lost"


def test_engine_proxy_gives_back_its_engines_stream():
    """give_back_stream on the proxy frees the stream its engine holds
    (a restart retires the proxy, not the engine inside it), and the
    module's release_stream stays an identity check: handed the proxy,
    it frees nothing."""
    eng = CounterEngine(num_slots=64, buckets=(8,), device="cpu")
    proxy = port_faults.DeviceFaultInjector().wrap_engine("lane0", eng)
    fake = SimpleNamespace(cuda_stream=0xC0FFEE)
    eng._stream = fake
    with port_engine._HELD_LOCK:
        port_engine._HELD_STREAMS[fake.cuda_stream] = eng
    port_engine.release_stream(proxy)
    assert port_engine._HELD_STREAMS[fake.cuda_stream] is eng
    proxy.give_back_stream()
    assert fake.cuda_stream not in port_engine._HELD_STREAMS
