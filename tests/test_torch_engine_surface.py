"""The last of the JAX package's surface, through both packages on the
CPU: ``CounterEngine.reset`` and ``assign_slot``,
``checkpoint.snapshot_engine`` and ``grpc_server.set_stage_sink``.

The same numpy-seeded traffic goes through a JAX engine and its port
(fixed window, sliding window, GCRA, and the bank-sharded table: JAX's
mesh of 8 devices against the port's 8 banks in two groups of the CPU).
Decisions, exported state and slot-table entries must be equal
(tolerance 0: the state is integer).  Then the stage sink on an
in-process port gRPC server.
"""

import time
from dataclasses import asdict

import grpc
import numpy as np
import pytest

from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends import checkpoint as jax_cp
from ratelimit_tpu.backends.dispatcher import LANE_DTYPE
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
from ratelimit_tpu_torch.server import grpc_server
from ratelimit_tpu_torch.server.health import HealthChecker
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils import time as port_time

from ratelimit_tpu_torch.server import pb  # noqa: F401  (sys.path for generated)
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

NUM_SLOTS = 64
NOW = 1_700_000_040
KINDS = ("fixed_window", "sliding_window", "gcra", "sharded")


def _engines(kind, native_table=None):
    """(JAX engine, port engine) of one kind, on the CPU."""
    if kind == "sharded":
        # JAX's sharded engine takes the C slot table where it loads.
        assert native_table is None
        return (JaxShardedEngine(jax_make_mesh(8), num_slots=NUM_SLOTS, buckets=(32,)),
                ShardedCounterEngine(make_mesh(8, devices=("cpu",) * 2), num_slots=NUM_SLOTS,
                                     buckets=(32,), native_table=native_table))
    return (
        JaxEngine(num_slots=NUM_SLOTS, buckets=(32,), native_table=native_table,
                  model=jax_algorithm(kind).make_model(NUM_SLOTS, 0.8)),
        CounterEngine(num_slots=NUM_SLOTS, buckets=(32,), device="cpu", native_table=native_table,
                      model=get_algorithm(kind).make_model(NUM_SLOTS, 0.8, device="cpu")),
    )


def _traffic(rng, kind, now, keys=("hot", "a", "b", "c", "d", "e", "f")):
    """One packed request of 24 seeded lanes over `keys` (repeats
    included); "hot" takes hits near u32 max on a fixed-window table."""
    algo = "fixed_window" if kind == "sharded" else kind
    spec = get_algorithm(algo)
    generic = algo != "fixed_window"
    rows = []
    for _ in range(24):
        k = keys[rng.integers(0, len(keys))]
        hits = 0xC0000000 if (k == "hot" and not generic) else int(rng.integers(1, 4))
        rows.append((k, hits, int(rng.integers(5, 40)), now + 600, 60 if generic else 0))
    enc = [k.encode() for k, *_ in rows]
    meta = np.zeros(len(rows), LANE_DTYPE)
    for j, ((_k, hits, limit, expiry, divider), b) in enumerate(zip(rows, enc)):
        meta[j] = (expiry, hits, limit, len(b), 0, divider, spec.algo_id)
    return b"".join(enc), meta


def _serve(engine, kind, seed, steps=3):
    """`steps` seeded requests; each one's decisions as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        blob, meta = _traffic(rng, kind, NOW + step)
        dec = engine.step_complete(engine.submit_packed(NOW + step, blob, meta))
        out.append({k: np.asarray(v) for k, v in asdict(dec).items()})
    return out


#: GCRA's fields computed from its f32 budget: within one cell of the
#: jitted JAX step and >= 90 % exact, the JAX package's own tolerance
#: (XLA may fuse the f32 multiply and add); every other field is exact.
GCRA_BUDGET = ("limit_remaining", "befores", "afters")


def _same_decisions(a, b, kind=""):
    """Equal decisions, GCRA's budget fields within GCRA_BUDGET's
    tolerance."""
    assert len(a) == len(b)
    exact = total = 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if kind == "gcra" and k in GCRA_BUDGET:
                d = np.abs(x[k].astype(np.int64) - y[k].astype(np.int64))
                assert d.max(initial=0) <= 1, k
                exact, total = exact + int((d == 0).sum()), total + len(d)
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert exact >= 0.9 * total


def _state(engine, kind):
    """The engine's state rows in global slot order.  The JAX sharded
    engine's export_state flattens its table bank by bank (a fault of
    the reference the port does not copy, tests/test_torch_checkpoint.py),
    so a sharded table is read through export_counts, global in both."""
    if kind == "sharded":
        return {"counts": np.asarray(engine.export_counts())}
    return engine.export_state()


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_reset_then_serve_matches_jax(kind):
    """Serve, reset, serve again: the same decisions (_same_decisions)
    and export_state (exact) as the JAX engine after the same calls, an
    empty slot table, every state row zero, and the second round
    answered as by a fresh engine (a served request counts from 0)."""
    jax_e, port_e = _engines(kind)
    _same_decisions(_serve(jax_e, kind, 11), _serve(port_e, kind, 11), kind)
    _same_state(_state(jax_e, kind), _state(port_e, kind))
    assert any(np.asarray(v).any() for v in port_e.export_state().values())
    for e in (jax_e, port_e):
        e.reset()
        assert len(e.slot_table) == 0 and e.slot_table.entries() == []
        assert not any(np.asarray(v).any() for v in e.export_state().values())
    _same_state(_state(jax_e, kind), _state(port_e, kind))
    again = [_serve(e, kind, 12) for e in (jax_e, port_e)]
    _same_decisions(*again, kind)
    _same_state(_state(jax_e, kind), _state(port_e, kind))
    fresh = _engines(kind)[1]
    _same_decisions(again[1], _serve(fresh, kind, 12))
    _same_state(_state(port_e, kind), _state(fresh, kind))
    assert sorted(port_e.slot_table.entries()) == sorted(fresh.slot_table.entries())


def test_sharded_reset_zeroes_every_group_on_its_card():
    """The grouped engine's reset makes each group's tensor anew on the
    device (and, on a card, the stream) of the card that holds it: the
    state keeps its groups, shapes and devices, and reads zero."""
    _, e = _engines("sharded")
    _serve(e, "sharded", 3)
    before = e.model.parts(e._counts)
    e.reset()
    after = e.model.parts(e._counts)
    assert len(after) == len(before) == 2
    for b, a, dev in zip(before, after, e.model.mesh.devices):
        assert a is not b and a.shape == b.shape and a.dtype == b.dtype and a.device == dev
        assert not a.any()


@pytest.mark.parametrize("kind,native_table", [("fixed_window", None), ("fixed_window", False),
                                               ("sharded", None)],
                         ids=["native", "python", "sharded"])
def test_assign_slot_matches_jax(kind, native_table):
    """The same key sequence -- repeats, a lease renewed, keys past
    their expiry after a gc -- gives the same (slot, fresh) from both
    engines, and the same slot-table entries."""
    engines = _engines(kind, native_table)
    rng = np.random.default_rng(21)
    keys = [f"k{i}" for i in range(12)]
    got = [[], []]
    for step in range(40):
        key = keys[rng.integers(0, len(keys))]
        now = NOW + step
        expiry = now + int(rng.integers(1, 20))
        for i, e in enumerate(engines):
            slot, fresh = e.assign_slot(key, now, expiry)
            got[i].append((int(slot), bool(fresh)))
        if step % 10 == 9:
            assert engines[0].gc(now) == engines[1].gc(now)
    assert got[0] == got[1]
    assert len({s for s, _ in got[0]}) > 1 and any(f for _, f in got[0])
    assert not all(f for _, f in got[0])
    assert sorted(engines[0].slot_table.entries()) == sorted(engines[1].slot_table.entries())


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_engine_matches_jax(kind, tmp_path):
    """After the same history, snapshot_engine gives the JAX function's
    state arrays bit for bit and its entries; the port's write_snapshot
    of that snapshot is a file the JAX restore_engine accepts, and the
    restored engine equals the port's."""
    jax_e, port_e = _engines(kind)
    for e in (jax_e, port_e):
        _serve(e, kind, 31)
        e.gc(NOW + 1)
    j_state, j_entries = jax_cp.snapshot_engine(jax_e)
    p_state, p_entries = cp.snapshot_engine(port_e)
    if kind == "sharded":
        # JAX's rows bank by bank (_state): the port's global rows,
        # transposed.
        nb = port_e.model.num_banks
        j_state = {"counts": j_state["counts"].reshape(nb, -1).T.reshape(-1)}
    _same_state(j_state, p_state)
    # The same triples; each table lists them in its own order.
    assert isinstance(p_entries, list) and p_entries and sorted(p_entries) == sorted(j_entries)
    copied_state, copied = cp.copy_engine(port_e)
    _same_state(copied_state, p_state)
    assert copied.entries() == p_entries
    path = str(tmp_path / "bank0.npz")
    cp.write_snapshot(path, port_e.model.num_slots, p_state, EntryArrays.from_entries(p_entries),
                      "lane0of1", port_e.algorithm)
    restored = _engines(kind)[0]
    assert jax_cp.restore_engine(restored, path, "lane0of1")
    _same_state(_state(restored, kind), p_state)
    assert sorted(restored.slot_table.entries()) == sorted(p_entries)


YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 5
"""


@pytest.mark.parametrize("package", ["jax", "port"])
def test_reset_through_exclusive_access_counts_from_zero(package):
    """A cache with its dispatcher running: a 5/minute key admits 5 and
    refuses the 6th; reset() run through run_exclusive drops the count,
    so the next 5 are admitted again (the port's cache with the fault
    domain armed, which records no fault and quarantines nothing)."""
    if package == "jax":
        a, ld, mgr, clock = jax_api, jax_loader, JaxManager, jax_time.PinnedTimeSource(1234)
        cache = TpuRateLimitCache(JaxEngine(num_slots=NUM_SLOTS), time_source=clock,
                                  batch_window_us=200)
    else:
        a, ld, mgr, clock = api, loader, Manager, port_time.PinnedTimeSource(1234)
        cache = CudaRateLimitCache(CounterEngine(num_slots=NUM_SLOTS, device="cpu"),
                                   time_source=clock, batch_window_us=200, kernel_deadline_s=0.25)
    try:
        rule = ld.load_config([ld.ConfigFile("config.c", YAML)], mgr()).get_limit(
            "d", a.Descriptor.of(("k", "x")))

        def hit(n):
            return [cache.do_limit(a.RateLimitRequest("d", [a.Descriptor.of(("k", "x"))], 1),
                                   [rule])[0].code.name for _ in range(n)]

        codes = hit(6)
        cache.run_exclusive(cache.engine, cache.engine.reset)
        codes += hit(6)
        assert codes == (["OK"] * 5 + ["OVER_LIMIT"]) * 2
        if package == "port":
            summary = cache.fault_domain.summary()
            assert not any(summary["faults"].values()) and summary["quarantined_banks"] == 0
    finally:
        cache.close()


class _Service:
    def should_rate_limit(self, request):
        return api.RateLimitResponse(overall_code=api.Code.OK)


def _grpc_calls(port, n):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        req = rls_pb2.RateLimitRequest(domain="d")
        e = req.descriptors.add().entries.add()
        e.key, e.value = "k", "x"
        return [call(req, timeout=30).overall_code for _ in range(n)]


def test_stage_sink_stamps_every_rpc_until_cleared():
    """set_stage_sink(fn): each ShouldRateLimit calls fn once with four
    non-decreasing perf_counter stamps (recv, decoded, serviced,
    serialized) taken within the RPC; set_stage_sink(None) stops it."""
    server = grpc_server.create_grpc_server(_Service(), HealthChecker(), host="127.0.0.1",
                                            port=0)
    server.start()
    stamps = []
    try:
        grpc_server.set_stage_sink(lambda *s: stamps.append(s))
        t0 = time.perf_counter()
        codes = _grpc_calls(server.bound_port, 5)
        t1 = time.perf_counter()
        assert codes == [rls_pb2.RateLimitResponse.OK] * 5
        assert len(stamps) == 5
        for s in stamps:
            assert len(s) == 4 and list(s) == sorted(s) and t0 <= s[0] and s[3] <= t1
        grpc_server.set_stage_sink(None)
        assert _grpc_calls(server.bound_port, 3) == [rls_pb2.RateLimitResponse.OK] * 3
        assert len(stamps) == 5
    finally:
        grpc_server.set_stage_sink(None)
        server.stop(0)
