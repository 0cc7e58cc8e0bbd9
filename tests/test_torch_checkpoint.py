"""Checkpoint files (ratelimit_tpu_torch/backends/checkpoint.py) against
the JAX package's, on the CPU.

Every scenario of the JAX package's tests/test_checkpoint.py runs
through both packages -- ratelimit_tpu's TpuRateLimitCache over its
CounterEngine, and the port's CudaRateLimitCache over
CounterEngine(device="cpu") -- with the same inputs, and must give the
same codes and restored state (tolerance 0).  Files cross between the
packages both ways for fixed-window, sliding-window, GCRA and sharded
banks, and each package refuses the other's file on the same guards
(version, age, role, num_slots, algorithm).  Then what is the port's
own: the restore lands in the fault domain's mirror seed, a snapshot
decodes no key on the dispatcher thread, and the graceful drain of a
port Runner writes the drained decision (a twin of
tests/test_graceful_drain.py that waits on the dispatcher, not on a
sleep).
"""

import json
import threading
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from test_torch_fault_domain import Injector

from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends import checkpoint as jax_cp
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.models.registry import get_algorithm as jax_algorithm
from ratelimit_tpu.parallel import ShardedCounterEngine as JaxShardedEngine
from ratelimit_tpu.parallel import make_mesh as jax_make_mesh
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends import checkpoint as cp
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.slot_table import EntryArrays
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.models.registry import get_algorithm
from ratelimit_tpu_torch.parallel import ShardedCounterEngine, make_mesh
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils import time as port_time

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 5
  - key: slide
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: sliding_window
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: gcra
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    cp=jax_cp,
    Cache=TpuRateLimitCache,
    loader=jax_loader,
    Manager=JaxManager,
    time=jax_time,
    engine=lambda ns=64, **kw: JaxEngine(num_slots=ns, **kw),
    sharded=lambda ns=64: JaxShardedEngine(jax_make_mesh(8), num_slots=ns),
    algo=lambda name, ns=64: JaxEngine(
        buckets=(8, 32), model=jax_algorithm(name).make_model(ns, 0.8)
    ),
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    cp=cp,
    Cache=CudaRateLimitCache,
    loader=loader,
    Manager=Manager,
    time=port_time,
    engine=lambda ns=64, **kw: CounterEngine(num_slots=ns, device="cpu", **kw),
    sharded=lambda ns=64: ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=ns),
    algo=lambda name, ns=64: CounterEngine(
        buckets=(8, 32),
        device="cpu",
        model=get_algorithm(name).make_model(ns, 0.8, device="cpu"),
    ),
)
BOTH = (JAX, PORT)


def _config(P, yaml=YAML):
    return P.loader.load_config([P.loader.ConfigFile("config.c", yaml)], P.Manager())


def _rule(P, key="k"):
    return _config(P).get_limit("d", P.api.Descriptor.of((key, "x")))


def _hit(P, cache, rule, n=1, key="k", value="x"):
    return [
        cache.do_limit(
            P.api.RateLimitRequest("d", [P.api.Descriptor.of((key, value))], 1), [rule]
        )[0].code.name
        for _ in range(n)
    ]


def _clock(P):
    return P.time.PinnedTimeSource(1234)


def _dir(tmp_path, P):
    d = tmp_path / P.name
    d.mkdir(exist_ok=True)
    return d


def _table(engine) -> list:
    return sorted(engine.slot_table.entries())


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's scenarios, each run on one package
# ---------------------------------------------------------------------------


def restart_does_not_forgive_window(P, tmp):
    path = str(tmp / "bank0.npz")
    clock = _clock(P)
    cache_a = P.Cache(P.engine(), time_source=clock)
    rule = _rule(P)
    codes = _hit(P, cache_a, rule, 3)
    P.cp.save_engine(cache_a.engine, path)
    cache_b = P.Cache(P.engine(), time_source=clock)
    restored = P.cp.restore_engine(cache_b.engine, path)
    codes += _hit(P, cache_b, rule, 3)
    assert codes == ["OK"] * 5 + ["OVER_LIMIT"]
    return dict(codes=codes, restored=restored, table=_table(cache_b.engine))


def restore_missing_or_mismatched(P, tmp):
    engine = P.engine()
    missing = P.cp.restore_engine(engine, str(tmp / "nope.npz"))
    P.cp.save_engine(engine, str(tmp / "bank0.npz"))
    other = P.engine(128)
    mismatched = P.cp.restore_engine(other, str(tmp / "bank0.npz"))
    assert missing is False and mismatched is False
    return dict(missing=missing, mismatched=mismatched, live=len(other.slot_table))


def sharded_checkpoint_roundtrip(P, tmp):
    path = str(tmp / "bank0.npz")
    clock = _clock(P)
    cache_a = P.Cache(P.sharded(), time_source=clock)
    rule = _rule(P)
    codes = _hit(P, cache_a, rule, 4)
    P.cp.save_engine(cache_a.engine, path)
    cache_b = P.Cache(P.sharded(), time_source=clock)
    restored = P.cp.restore_engine(cache_b.engine, path)
    np.testing.assert_array_equal(
        cache_b.engine.export_counts(), cache_a.engine.export_counts()
    )
    codes += _hit(P, cache_b, rule, 2)
    assert codes == ["OK"] * 5 + ["OVER_LIMIT"]
    return dict(
        codes=codes,
        restored=restored,
        counts=np.asarray(cache_b.engine.export_counts()).tolist(),
    )


def checkpoint_manager_with_dispatcher(P, tmp):
    clock = _clock(P)
    cache = P.Cache(P.engine(), time_source=clock, batch_window_us=200)
    try:
        rule = _rule(P)
        codes = _hit(P, cache, rule, 3)
        P.cp.CheckpointManager(cache, str(tmp), interval_s=3600).checkpoint()
        fresh = P.Cache(P.engine(), time_source=clock)
        mgr2 = P.cp.CheckpointManager(
            P.Cache(fresh.engine, time_source=clock), str(tmp), interval_s=3600
        )
        restored = mgr2.restore()
        codes += _hit(P, fresh, rule, 3)
        assert restored == 1 and codes == ["OK"] * 5 + ["OVER_LIMIT"]
        return dict(codes=codes, restored=restored)
    finally:
        cache.close()


def restore_refuses_stale_snapshot(P, tmp):
    import time as _time

    path = str(tmp / "bank0.npz")
    cache_a = P.Cache(P.engine(), time_source=_clock(P))
    codes = _hit(P, cache_a, _rule(P), 5)
    saved_at = _time.time()
    P.cp.save_engine(cache_a.engine, path)
    wall = P.time.FakeMonotonicClock(saved_at + 60.0)
    fresh = P.engine()
    within = P.cp.restore_engine(fresh, path, wall_now=wall.now)
    wall.advance(P.cp.MAX_RESTORE_AGE_S + 120.0)
    stale = P.engine()
    refused = P.cp.restore_engine(stale, path, wall_now=wall.now)
    refused_live = len(stale.slot_table)
    overridden = P.cp.restore_engine(stale, path, max_age_s=0, wall_now=wall.now)
    assert (within, refused, overridden) == (True, False, True)
    return dict(
        codes=codes,
        results=(within, len(fresh.slot_table), refused, refused_live, overridden,
                 len(stale.slot_table)),
    )


def crash_mid_snapshot_preserves_previous(P, tmp, monkeypatch):
    path = str(tmp / "bank0.npz")
    clock = _clock(P)
    cache = P.Cache(P.engine(), time_source=clock)
    rule = _rule(P)
    codes = _hit(P, cache, rule, 3)
    P.cp.save_engine(cache.engine, path)

    def dying_savez(f, **arrays):
        f.write(b"\x00garbage")
        raise OSError("disk died mid-write")

    codes += _hit(P, cache, rule, 1)
    with monkeypatch.context() as m:
        m.setattr(P.cp.np, "savez_compressed", dying_savez)
        with pytest.raises(OSError):
            P.cp.save_engine(cache.engine, path)
    fresh = P.Cache(P.engine(), time_source=clock)
    restored = P.cp.restore_engine(fresh.engine, path)
    after = _hit(P, fresh, rule, 3)
    assert after == ["OK", "OK", "OVER_LIMIT"]
    return dict(codes=codes, restored=restored, after=after)


def snapshot_under_concurrent_traffic_is_consistent(P, tmp):
    cache = P.Cache(P.engine(256), time_source=_clock(P), batch_window_us=100)
    cfg = _config(P, YAML.replace("requests_per_unit: 5", "requests_per_unit: 1000000", 1))
    rule = cfg.get_limit("d", P.api.Descriptor.of(("k", "x")))
    n_threads, per_thread = 4, 50
    manager = P.cp.CheckpointManager(cache, str(tmp), interval_s=1000.0)

    def traffic(tid):
        for _ in range(per_thread):
            cache.do_limit(
                P.api.RateLimitRequest("d", [P.api.Descriptor.of(("k", f"t{tid}"))], 1),
                [rule],
            )

    def restored_counts():
        eng = P.engine(256)
        assert P.cp.restore_engine(eng, str(tmp / "bank0.npz"), "lane0of1")
        counts = np.asarray(eng.export_counts())
        return {k: int(counts[s]) for k, s, _e in eng.slot_table.entries()}

    threads = [threading.Thread(target=traffic, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    mid = []
    try:
        for _ in range(5):
            manager.checkpoint()
            per_key = restored_counts()
            assert all(0 <= c <= per_thread for c in per_key.values()), per_key
            mid.append(sum(per_key.values()))
    finally:
        for t in threads:
            t.join()
    assert mid == sorted(mid)
    cache.flush()
    manager.checkpoint()
    total = sum(restored_counts().values())
    cache.close()
    assert total == n_threads * per_thread
    return dict(total=total, monotone=mid == sorted(mid))


def checkpoint_snapshots_mirror_while_quarantined(P, tmp):
    inj = Injector()
    engine = inj.wrap("lane0", P.engine(buckets=(8,)))
    clock = _clock(P)
    cache = P.Cache(
        engine,
        time_source=clock,
        batch_window_us=100,
        kernel_deadline_s=0.2,
        device_failure_mode="host",
        fault_interval_s=0,
        fault_snapshot_interval_s=1000.0,
    )
    rule = _rule(P)
    try:
        codes = _hit(P, cache, rule, 3)
        cache.fault_domain.snapshot_now()
        inj.set("lane0", "raise")
        codes += _hit(P, cache, rule, 1)  # the 4th, answered by the mirror
        quarantined = cache.fault_domain.is_quarantined(0)
        P.cp.CheckpointManager(cache, str(tmp), interval_s=1000.0).checkpoint()
        fresh = P.Cache(P.engine(), time_source=clock)
        restored = P.cp.restore_engine(fresh.engine, str(tmp / "bank0.npz"), "lane0of1")
        after = _hit(P, fresh, rule, 2)
        assert quarantined and restored and after == ["OK", "OVER_LIMIT"]
        return dict(codes=codes, quarantined=quarantined, restored=restored, after=after)
    finally:
        inj.heal()
        cache.close()


SCENARIOS = [
    restart_does_not_forgive_window,
    restore_missing_or_mismatched,
    sharded_checkpoint_roundtrip,
    checkpoint_manager_with_dispatcher,
    restore_refuses_stale_snapshot,
    snapshot_under_concurrent_traffic_is_consistent,
    checkpoint_snapshots_mirror_while_quarantined,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_checkpoint_scenario_same_in_both_packages(scenario, tmp_path):
    jax_outcome = scenario(JAX, _dir(tmp_path, JAX))
    port_outcome = scenario(PORT, _dir(tmp_path, PORT))
    assert port_outcome == jax_outcome


def test_crash_mid_snapshot_same_in_both_packages(tmp_path, monkeypatch):
    jax_outcome = crash_mid_snapshot_preserves_previous(JAX, _dir(tmp_path, JAX), monkeypatch)
    port_outcome = crash_mid_snapshot_preserves_previous(PORT, _dir(tmp_path, PORT), monkeypatch)
    assert port_outcome == jax_outcome


# ---------------------------------------------------------------------------
# files cross between the packages
# ---------------------------------------------------------------------------


def _bank(P, kind):
    """(cache, engine, key) of one bank of `kind` with a few keys."""
    clock = _clock(P)
    if kind == "fixed_window":
        engine = P.engine(64)
        return P.Cache(engine, time_source=clock), engine, "k"
    if kind == "sharded":
        engine = P.sharded(64)
        return P.Cache(engine, time_source=clock), engine, "k"
    engine = P.algo(kind)
    cache = P.Cache(P.engine(64), time_source=clock, algorithm_banks={kind: engine})
    return cache, engine, {"sliding_window": "slide", "gcra": "tb"}[kind]


def _serve(P, cache, key, values, hits=1):
    cfg = _config(P)
    out = []
    for v in values:
        req = P.api.RateLimitRequest("d", [P.api.Descriptor.of((key, v))], hits)
        statuses, _limits, _unl = cache.do_limit_resolved(req, cfg)
        out += [(s.code.name, s.limit_remaining) for s in statuses]
    return out


def _state(engine) -> dict:
    """The bank's state rows, a fixed-window table in global slot order
    (export_counts) in both packages."""
    if getattr(engine, "algorithm", "fixed_window") == "fixed_window":
        return {"counts": np.asarray(engine.export_counts()).tolist()}
    return {k: np.asarray(v).tolist() for k, v in engine.export_state().items()}


@pytest.mark.parametrize("kind", ["fixed_window", "sliding_window", "gcra", "sharded"])
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax_to_port", "port_to_jax"])
def test_files_cross_between_packages(kind, writer, reader, tmp_path):
    """A bank's file written by one package restores into the other as
    into the writer's own package -- state rows and live entries equal,
    and both then answer the same traffic alike -- and, but for a JAX
    sharded file (test_jax_sharded_file_is_bank_major), equal to the
    writer's bank."""
    rng = np.random.default_rng(12)
    values = [f"v{int(i)}" for i in rng.integers(0, 12, 40)]
    w_cache, w_engine, key = _bank(writer, kind)
    r_cache, r_engine, _ = _bank(reader, kind)
    s_cache, s_engine, _ = _bank(writer, kind)  # the writer's package reads it too
    _serve(writer, w_cache, key, values)
    path = str(tmp_path / "bank.npz")
    writer.cp.save_engine(w_engine, path, "lane0of1")
    assert reader.cp.restore_engine(r_engine, path, "lane0of1")
    assert writer.cp.restore_engine(s_engine, path, "lane0of1")
    assert _state(r_engine) == _state(s_engine)
    assert _table(r_engine) == _table(s_engine) == _table(w_engine)
    if not (writer is JAX and kind == "sharded"):
        assert _state(r_engine) == _state(w_engine)
    more = [f"v{int(i)}" for i in rng.integers(0, 16, 30)]
    assert _serve(reader, r_cache, key, more) == _serve(writer, s_cache, key, more)


def test_jax_sharded_file_is_bank_major(tmp_path):
    """A fault of the reference, not copied: the JAX sharded engine's
    export_state flattens its (banks, slots_per_bank) table bank by bank
    while every import_state reads global slot order, so the JAX package
    restoring its own sharded file moves counters between keys.  The
    port writes global order: its file restores exactly, into either
    package; a JAX file restores into the port as into JAX."""
    rng = np.random.default_rng(3)
    values = [f"v{int(i)}" for i in rng.integers(0, 12, 40)]
    files = {}
    for P in BOTH:
        cache, engine, key = _bank(P, "sharded")
        _serve(P, cache, key, values)
        files[P.name] = (str(tmp_path / f"{P.name}.npz"), engine)
        P.cp.save_engine(engine, files[P.name][0], "lane0of1")
    jax_path, jax_engine = files["jax"]
    port_path, port_engine = files["port"]
    written = np.asarray(jax_engine.export_counts())
    np.testing.assert_array_equal(np.asarray(port_engine.export_counts()), written)
    with np.load(jax_path) as z:
        jax_file = z["counts"]
    with np.load(port_path) as z:
        port_file = z["counts"]
    banks, per_bank = 8, 64 // 8
    np.testing.assert_array_equal(port_file, written)
    np.testing.assert_array_equal(jax_file, written.reshape(per_bank, banks).T.reshape(-1))
    for P in BOTH:
        back = P.sharded(64)
        assert P.cp.restore_engine(back, port_path, "lane0of1")
        np.testing.assert_array_equal(np.asarray(back.export_counts()), written)
        moved = P.sharded(64)
        assert P.cp.restore_engine(moved, jax_path, "lane0of1")
        assert not np.array_equal(np.asarray(moved.export_counts()), written)


#: Sharded engines of 8 banks: the JAX mesh, and the port's banks in one
#: group and in four groups of the CPU.
SHARDED_ENGINES = {
    "jax": (JAX, lambda: JaxShardedEngine(jax_make_mesh(8), num_slots=64)),
    "port-1-group": (PORT, lambda: ShardedCounterEngine(make_mesh(8, "cpu"), num_slots=64)),
    "port-4-groups": (
        PORT,
        lambda: ShardedCounterEngine(make_mesh(8, devices=("cpu",) * 4), num_slots=64),
    ),
}


def _sharded_bank(name):
    P, make = SHARDED_ENGINES[name]
    engine = make()
    return P, P.Cache(engine, time_source=_clock(P)), engine


@pytest.mark.parametrize("reader", SHARDED_ENGINES)
@pytest.mark.parametrize("writer", SHARDED_ENGINES)
def test_sharded_files_cross_between_groups(writer, reader, tmp_path):
    """A sharded bank's file crosses between the JAX mesh, one port
    group and four port groups in every direction: the reader's state is
    byte-equal to the JAX sharded engine's after it reads the same file,
    and to the writer's own state for a port file (the port writes
    global slot order whatever its groups; a JAX file is bank-major,
    test_jax_sharded_file_is_bank_major); the reader then answers more
    traffic as that JAX engine does."""
    rng = np.random.default_rng(31)
    values = [f"v{int(i)}" for i in rng.integers(0, 12, 40)]
    w_P, w_cache, w_engine = _sharded_bank(writer)
    _serve(w_P, w_cache, "k", values)
    path = str(tmp_path / "bank.npz")
    w_P.cp.save_engine(w_engine, path, "lane0of1")
    r_P, r_cache, r_engine = _sharded_bank(reader)
    _, j_cache, j_engine = _sharded_bank("jax")
    assert r_P.cp.restore_engine(r_engine, path, "lane0of1")
    assert JAX.cp.restore_engine(j_engine, path, "lane0of1")
    got = np.asarray(r_engine.export_counts())
    assert got.dtype == np.uint32 and got.tobytes() == np.asarray(j_engine.export_counts()).tobytes()
    assert _table(r_engine) == _table(j_engine) == _table(w_engine)
    if writer != "jax":
        assert got.tobytes() == np.asarray(w_engine.export_counts()).tobytes()
    more = [f"v{int(i)}" for i in rng.integers(0, 16, 30)]
    assert _serve(r_P, r_cache, "k", more) == _serve(JAX, j_cache, "k", more)


GUARDS = ["version", "age", "role", "num_slots", "algorithm"]


@pytest.mark.parametrize("guard", GUARDS)
@pytest.mark.parametrize("writer", BOTH, ids=lambda P: P.name)
def test_both_packages_refuse_a_file_alike(guard, writer, tmp_path):
    """Each guard refuses the file in both packages and leaves the
    engine fresh: another format version, a snapshot older than a day,
    another bank role, another slot count, another algorithm."""
    cache, engine, key = _bank(writer, "fixed_window")
    _serve(writer, cache, key, ["a", "b"])
    path = str(tmp_path / "bank0.npz")
    writer.cp.save_engine(engine, path, "lane0of2")
    if guard == "version":
        with np.load(path) as z:
            arrays = dict(z)
        meta = json.loads(bytes(arrays["meta"]).decode())
        meta["version"] = 2
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)
    results = []
    for P in BOTH:
        role = "per_second" if guard == "role" else "lane0of2"
        fresh = {
            "num_slots": lambda: P.engine(128),
            "algorithm": lambda: P.algo("gcra"),
        }.get(guard, lambda: P.engine(64))()
        wall = (lambda: 2e12) if guard == "age" else None
        kw = {"wall_now": wall} if wall else {}
        results.append((P.cp.restore_engine(fresh, path, role, **kw), len(fresh.slot_table)))
    assert results == [(False, 0), (False, 0)]


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_restore_lands_in_the_mirror_seed(tmp_path):
    """The supervisor's first pass seeds each bank's mirror from the
    still-empty table; a restore must replace that seed, or a quarantine
    before the next pass would forgive the restored windows."""
    clock = _clock(PORT)
    rule = _rule(PORT)
    first = PORT.Cache(PORT.engine(buckets=(8,)), time_source=clock)
    assert _hit(PORT, first, rule, 3) == ["OK"] * 3
    PORT.cp.CheckpointManager(first, str(tmp_path), interval_s=3600).checkpoint()

    inj = Injector()
    cache = PORT.Cache(
        inj.wrap("lane0", PORT.engine(buckets=(8,))),
        time_source=clock,
        batch_window_us=100,
        kernel_deadline_s=0.2,
        fault_interval_s=0,
        fault_snapshot_interval_s=1000.0,
    )
    fd = cache.fault_domain
    try:
        fd.tick()  # the first pass: a seed of the empty table
        assert fd._records[0].snapshot is not None
        assert PORT.cp.CheckpointManager(cache, str(tmp_path), interval_s=3600).restore() == 1
        inj.set("lane0", "raise")
        assert _hit(PORT, cache, rule, 3) == ["OK", "OK", "OVER_LIMIT"]
        assert fd.is_quarantined(0) and fd.stat_fallback_decisions == 3
    finally:
        inj.heal()
        cache.close()


def test_a_snapshot_decodes_no_key_on_the_dispatcher_thread(tmp_path, monkeypatch):
    """Only the copy runs under the bank's exclusivity: the keys are
    decoded on the caller's thread, by the checkpoint writer and by the
    fault domain's periodic snapshot alike."""
    decoded_on = []
    real = EntryArrays.entries

    def entries(self):
        decoded_on.append(threading.current_thread().name)
        return real(self)

    monkeypatch.setattr(EntryArrays, "entries", entries)
    cache = PORT.Cache(
        PORT.engine(buckets=(8,), native_table=True),
        time_source=_clock(PORT),
        batch_window_us=100,
        kernel_deadline_s=0.2,
        fault_interval_s=0,
    )
    try:
        _hit(PORT, cache, _rule(PORT), 3)
        mgr = PORT.cp.CheckpointManager(cache, str(tmp_path), interval_s=3600)
        mgr.checkpoint()
        assert cache.fault_domain.snapshot_now() == 1
        assert decoded_on and not any(n.startswith("cuda-dispatcher") for n in decoded_on)
        (bank,) = mgr.last
        assert bank["role"] == "lane0of1" and bank["keys"] == 1 and bank["bytes"] > 0
        assert bank["exclusive_ms"] >= 0
    finally:
        cache.close()


@pytest.mark.parametrize("native_table", [False, True], ids=["python", "native"])
def test_write_snapshot_takes_either_tables_copy(native_table, tmp_path):
    """The copy of either slot table writes the arrays that its decoded
    entries encode to, and restores the same keys."""
    engine = PORT.engine(native_table=native_table)
    _serve(PORT, PORT.Cache(engine, time_source=_clock(PORT)), "k", ["a", "b", "c"])
    state, copied = cp.copy_engine(engine)
    path = str(tmp_path / "a.npz")
    cp.write_snapshot(path, 64, state, copied, "r")
    want = EntryArrays.from_entries(copied.entries())
    with np.load(path) as z:
        for name in want._fields:
            np.testing.assert_array_equal(z[name], getattr(want, name), err_msg=name)
    fresh = PORT.engine(native_table=native_table)
    assert cp.restore_engine(fresh, path, "r", max_age_s=0)
    assert sorted(fresh.slot_table.entries()) == sorted(copied.entries())


def test_a_mirror_snapshot_decodes_outside_the_mirror_lock(tmp_path, monkeypatch):
    """A checkpoint during a quarantine holds the mirror lock, which the
    bank's answers wait on, only for the copy: the mirror's keys are
    turned into arrays after the lock is released."""
    from ratelimit_tpu_torch.backends import slot_table as slot_table_mod

    inj = Injector()
    cache = PORT.Cache(
        inj.wrap("lane0", PORT.engine(buckets=(8,))),
        time_source=_clock(PORT),
        batch_window_us=100,
        kernel_deadline_s=0.2,
        device_failure_mode="host",
        fault_interval_s=0,
        fault_snapshot_interval_s=1000.0,
    )
    fd = cache.fault_domain
    rule = _rule(PORT)
    locked_at_decode = []
    real = slot_table_mod._MapCopy.arrays

    def arrays(self):
        locked_at_decode.append(fd._records[0].lock.locked())
        return real(self)

    monkeypatch.setattr(slot_table_mod._MapCopy, "arrays", arrays)
    try:
        _hit(PORT, cache, rule, 3)
        fd.snapshot_now()
        inj.set("lane0", "raise")
        _hit(PORT, cache, rule, 1)
        assert fd.is_quarantined(0)
        mgr = PORT.cp.CheckpointManager(cache, str(tmp_path), interval_s=3600)
        mgr.checkpoint()
        assert locked_at_decode == [False]
        (bank,) = mgr.last
        assert bank["mirror"] and bank["keys"] == 1 and bank["bytes"] > 0
    finally:
        inj.heal()
        cache.close()


DRAIN_YAML = """
domain: drain
descriptors:
  - key: key1
    rate_limit:
      unit: minute
      requests_per_unit: 100
"""


def test_sigterm_drain_completes_inflight_and_snapshots(tmp_path):
    """A twin of tests/test_graceful_drain.py through the port's Runner:
    stop() during an RPC completes it with a real decision, flips health
    first, and the final checkpoint (read by the JAX package) holds the
    drained hit.  The test waits until the dispatcher has taken the RPC
    (its intake, in-flight and completed counts), not on a sleep."""
    root = tmp_path / "runtime"
    config_dir = root / "ratelimit" / "config"
    config_dir.mkdir(parents=True)
    (config_dir / "basic.yaml").write_text(DRAIN_YAML)
    ckpt_dir = tmp_path / "ckpt"
    r = Runner(
        Settings(
            host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
            debug_host="127.0.0.1", debug_port=0, use_statsd=False,
            backend_type="cuda", tpu_num_slots=1 << 10,
            tpu_batch_window_us=150_000, tpu_batch_buckets=[8],
            tpu_checkpoint_dir=str(ckpt_dir), tpu_checkpoint_interval_s=10_000.0,
            runtime_path=str(root), runtime_subdirectory="ratelimit",
            local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
            kernel_deadline_s=0.0,
        ),
        time_source=PORT.time.PinnedTimeSource(1_000_000),
        device="cpu",
    )
    r.start()
    d = r.cache.dispatcher

    def taken():
        return d.queue_depth() + d.inflight() + d.completed_launches

    before = taken()
    port = r.grpc_server.bound_port
    results = {}

    def rpc():
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            req = rls_pb2.RateLimitRequest(domain="drain", hits_addend=1)
            e = req.descriptors.add().entries.add()
            e.key, e.value = "key1", "x"
            try:
                resp = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                    request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )(req, timeout=30)
                results["code"] = resp.overall_code
            except grpc.RpcError as exc:  # pragma: no cover - failure detail
                results["error"] = exc

    t = threading.Thread(target=rpc)
    t.start()
    reached = threading.Event()
    for _ in range(3000):
        if taken() > before or not t.is_alive():
            reached.set()
            break
        reached.wait(0.01)
    assert reached.is_set(), "the RPC never reached the dispatcher"
    r.stop()
    t.join(timeout=20)
    assert not t.is_alive()
    assert results.get("code") == rls_pb2.RateLimitResponse.OK, results
    assert not r.health.healthy

    bank0 = ckpt_dir / "bank0.npz"
    assert bank0.exists()
    for P in BOTH:
        eng = P.engine(1 << 10)
        assert P.cp.restore_engine(eng, str(bank0), "lane0of1")
        counts = np.asarray(eng.export_counts())
        entries = eng.slot_table.entries()
        assert entries, "snapshot lost the drained key"
        assert sum(int(counts[s]) for _k, s, _e in entries) == 1
