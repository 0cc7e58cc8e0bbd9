"""Live key export/import (CounterEngine.export_keys / import_keys)
between the JAX engine and the port's, on the CPU.

Two source engines, one per package, take the same seeded traffic, and
so do two destination engines (traffic that overlaps the sources'
keys).  Each source exports the keys a predicate selects; the JAX
export is imported into the port's destination and the port's export
into the JAX destination, at a clock where some leases have expired.
Both imports must report the same {imported, merged, dropped}, and
every key's state must then be equal across the packages: fresh keys
land their columns, live keys merge (fixed-window counts add with
saturation, algorithm rows take the element-wise max), expired leases
are dropped, and the exported keys leave their source.
"""

import numpy as np
import pytest

from ratelimit_tpu.backends.dispatcher import LANE_DTYPE
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.host_engine import HostEngine as JaxHostEngine
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.host_engine import HostEngine
from ratelimit_tpu_torch.models.registry import get_algorithm

ALGOS = ("fixed_window", "sliding_window", "gcra")
NUM_SLOTS = 64
NOW = 1_700_000_040


def _engines(algo, native_table=None):
    jax_engine = JaxEngine(
        num_slots=NUM_SLOTS,
        buckets=(32,),
        model=jax_algorithm(algo).make_model(NUM_SLOTS, 0.8),
        native_table=native_table,
    )
    port_engine = CounterEngine(
        num_slots=NUM_SLOTS,
        buckets=(32,),
        device="cpu",
        model=get_algorithm(algo).make_model(NUM_SLOTS, 0.8, device="cpu"),
        native_table=native_table,
    )
    return jax_engine, port_engine


def _traffic(rng, algo, keys, now):
    """Seeded lanes over `keys`: leases end at now + 30 for keys whose
    first letter has an odd code, at now + 3600 otherwise; "hot" takes
    hits near u32 max (fixed window saturates there)."""
    spec = get_algorithm(algo)
    generic = algo != "fixed_window"
    rows = []
    for _ in range(24):
        k = keys[rng.integers(0, len(keys))]
        hits = 0xC0000000 if (k == "hot" and not generic) else int(rng.integers(1, 4))
        expiry = now + (30 if ord(k[0]) % 2 else 3600)
        rows.append((k, hits, int(rng.integers(5, 40)), expiry, 60 if generic else 0))
    enc = [k.encode() for k, *_ in rows]
    meta = np.zeros(len(rows), LANE_DTYPE)
    for j, ((_k, hits, limit, expiry, divider), b) in enumerate(zip(rows, enc)):
        meta[j] = (expiry, hits, limit, len(b), 0, divider, spec.algo_id)
    return b"".join(enc), meta


def _feed(engines, algo, seed, keys, now):
    rng = np.random.default_rng(seed)
    for step in range(3):
        blob, meta = _traffic(rng, algo, keys, now + step)
        for e in engines:
            e.step_complete(e.submit_packed(now + step, blob, meta.copy()))


def _per_key(engine):
    state = engine.export_state()
    return {
        k: (e, tuple(int(np.asarray(state[n]).reshape(-1)[s]) for n in sorted(state)))
        for k, s, e in engine.slot_table.entries()
    }


def _by_key(export):
    """{key: (expiry, its state columns)} of an export_keys result (the
    entry order is each slot table's own)."""
    state, entries = export
    return {
        k: (e, tuple(int(np.asarray(state[n])[i]) for n in sorted(state)))
        for i, (k, e) in enumerate(entries)
    }


def _same_export(a, b):
    assert sorted(a[0]) == sorted(b[0])
    assert _by_key(a) == _by_key(b)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("native_table", [None, False], ids=["native", "python"])
def test_export_import_keys_across_packages(algo, native_table):
    src = _engines(algo, native_table)
    dst = _engines(algo, native_table)
    src_keys = ["hot", "a", "b", "c", "d", "e", "f", "g", "j", "l"]
    dst_keys = ["hot", "a", "b", "d", "x", "y"]
    _feed(src, algo, 1, src_keys, NOW)
    _feed(dst, algo, 2, dst_keys, NOW)
    assert _per_key(src[0]) == _per_key(src[1])
    assert _per_key(dst[0]) == _per_key(dst[1])

    def pred(k):
        return k not in ("f", "g")

    exported = [e.export_keys(pred, drop=True) for e in src]
    _same_export(*exported)
    # The exported keys left both sources; the rest stayed as it was.
    for e in src:
        assert sorted(k for k, *_ in e.slot_table.entries()) == ["f", "g"]
    assert _per_key(src[0]) == _per_key(src[1])

    # Cross import at a clock past the short leases: JAX -> port and
    # port -> JAX.
    later = NOW + 60
    res_port = dst[1].import_keys(*exported[0], later)
    res_jax = dst[0].import_keys(*exported[1], later)
    assert res_port == res_jax
    assert res_port["dropped"] > 0 and res_port["merged"] > 0 and res_port["imported"] > 0
    assert _per_key(dst[0]) == _per_key(dst[1])
    if algo == "fixed_window":
        state = dst[1].export_state()["counts"]
        slot = {k: s for k, s, _ in dst[1].slot_table.entries()}
        assert int(state[slot["hot"]]) == 0xFFFFFFFF  # the merge saturates


@pytest.mark.parametrize("algo", ALGOS)
def test_host_mirror_keys_across_packages(algo):
    """The restart merge's source is the host mirror: the JAX mirror's
    export and the port's are equal, and the port's imports into the
    JAX engine as the JAX mirror's imports into the port's."""
    mirrors = (
        JaxHostEngine(num_slots=NUM_SLOTS, algorithm=algo),
        HostEngine(num_slots=NUM_SLOTS, algorithm=algo),
    )
    _feed(mirrors, algo, 5, ["hot", "p", "q", "r"], NOW)
    exported = [m.export_keys(lambda _k: True, drop=True) for m in mirrors]
    _same_export(*exported)
    assert all(len(m.slot_table) == 0 for m in mirrors)
    dst = _engines(algo)
    _feed(dst, algo, 6, ["p", "z"], NOW)
    assert dst[1].import_keys(*exported[0], NOW + 5) == dst[0].import_keys(
        *exported[1], NOW + 5
    )
    assert _per_key(dst[0]) == _per_key(dst[1])


def test_import_keys_empty_and_export_nothing():
    jax_engine, port_engine = _engines("fixed_window")
    assert port_engine.import_keys({"counts": np.zeros(0, np.uint32)}, [], NOW) == {
        "imported": 0,
        "merged": 0,
        "dropped": 0,
    }
    state, entries = port_engine.export_keys(lambda _k: True)
    assert entries == [] and state["counts"].shape == (0,)
    _same_export((state, entries), jax_engine.export_keys(lambda _k: True))
