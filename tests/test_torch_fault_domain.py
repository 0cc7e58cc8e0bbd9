"""The device fault domain (ratelimit_tpu_torch/backends/fault_domain.py)
against the JAX package's, on the CPU.

Every scenario of the JAX package's tests/test_fault_domain.py runs
through both packages -- ratelimit_tpu's TpuRateLimitCache over its CounterEngine,
and the port's CudaRateLimitCache over CounterEngine(device="cpu") --
and must give the same outcome: fault kinds, quarantine state and when
it started, the per-request codes under host / allow / deny, the exact
limit across hang -> fallback -> restart, the probe failure that keeps
a bank quarantined, the caller deadline that does not fault, the
counters and the summary, an inert disabled domain.  Faults come from a
host-side injector defined here, at the engine's submit_packed /
step_complete seams; the domain's clock and the dispatchers' liveness
stamps run on a FakeMonotonicClock and the supervisor is driven by
tick().  The port's CUDA fault taxonomy is checked on its own, and so
are its kernel defects (a kernel that does not build, load or launch
raises and goes NOT_SERVING, never to the mirror) and its restart races
(an RPC held on the mirror lock across the swap, a merge that fails).
The observability hooks run through both packages too: a fallback
answer's flight record carries FLIGHT_CODE_FALLBACK, the journal tells
quarantine -> fallback -> half-open -> restart (or restart_failed) in
seq order, and each fallback answer is one OUTCOME_FALLBACK launch
record.  In the port the journal hears of a transition only after its
health is published, and a fallback answer waits for the
bank_quarantine event.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import ratelimit_tpu.backends.fault_domain as jax_fd
import ratelimit_tpu.observability as jax_obs
import ratelimit_tpu_torch.backends.fault_domain as fd_mod
import ratelimit_tpu_torch.observability as port_obs
from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends.engine import CounterEngine as JaxEngine
from ratelimit_tpu.backends.tpu_cache import TpuRateLimitCache
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.server.health import HealthChecker as JaxHealth
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils import time as jax_time
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.dispatcher import DispatcherDead
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.fault_domain import (
    FAULT_DEVICE_LOST,
    FAULT_EXCEPTION,
    FAULT_HANG,
    classify_fault,
)
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.kernels import KernelError
from ratelimit_tpu_torch.server.health import HealthChecker
from ratelimit_tpu_torch.service import CacheError
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils import time as port_time

YAML = """
domain: d
descriptors:
  - key: k
    rate_limit:
      unit: minute
      requests_per_unit: 20
  - key: shadowed
    rate_limit:
      unit: minute
      requests_per_unit: 1
    shadow_mode: true
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    Engine=JaxEngine,
    engine_kw={},
    Cache=TpuRateLimitCache,
    fd=jax_fd,
    loader=jax_loader,
    Manager=JaxManager,
    time=jax_time,
    Health=JaxHealth,
    obs=jax_obs,
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    Engine=CounterEngine,
    engine_kw={"device": "cpu"},
    Cache=CudaRateLimitCache,
    fd=fd_mod,
    loader=loader,
    Manager=Manager,
    time=port_time,
    Health=HealthChecker,
    obs=port_obs,
)
CLOCK0 = 100.0


class DeviceLost(RuntimeError):
    """An injected loss of the device, worded so that both packages'
    taxonomies read it as one (PJRT's "device lost", CUDA's sticky
    "unspecified launch failure")."""

    def __init__(self, label: str):
        super().__init__(
            f"device lost: CUDA error: unspecified launch failure "
            f"(injected on bank {label})"
        )


class Injector:
    """Per-bank fault switchboard at an engine's two dispatcher-facing
    calls: ``submit_packed`` (the collector's launch) and
    ``step_complete`` (the completer's wait).  Modes: ``hang`` blocks
    the call until healed, then raises DeviceLost; ``stall`` blocks
    until healed, then lets the call run (a stream that stalls and then
    drains); ``raise`` and ``device_lost`` raise at once, and so does an
    exception given as the mode."""

    def __init__(self):
        self._lock = threading.Lock()
        self._mode = {}
        self._release = threading.Event()

    def set(self, label, mode, at="submit"):
        with self._lock:
            if mode in ("hang", "stall"):
                self._release.clear()
            self._mode[label] = (mode, at)

    def heal(self):
        with self._lock:
            self._mode.clear()
            self._release.set()

    def check(self, label, seam):
        with self._lock:
            m = self._mode.get(label)
        if m is None or m[1] != seam:
            return
        mode = m[0]
        if mode in ("hang", "stall"):
            self._release.wait()
            if mode == "stall":
                return
            raise DeviceLost(label)
        if mode == "device_lost":
            raise DeviceLost(label)
        if isinstance(mode, BaseException):
            raise mode
        raise RuntimeError(f"injected device-step failure on bank {label}")

    def wrap(self, label, engine):
        return _FaultyEngine(self, label, engine)


class _FaultyEngine:
    """Engine proxy: the two seams inject, everything else delegates."""

    def __init__(self, injector, label, engine):
        self._injector = injector
        self._label = label
        self._engine = engine

    def submit_packed(self, now, key_blob, meta):
        self._injector.check(self._label, "submit")
        return self._engine.submit_packed(now, key_blob, meta)

    def step_complete(self, token):
        self._injector.check(self._label, "complete")
        return self._engine.step_complete(token)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def make_cache(P, inj=None, mode="host", deadline=0.25, clock=None, **kw):
    engine = P.Engine(num_slots=256, buckets=(8,), **P.engine_kw)
    if inj is not None:
        engine = inj.wrap("lane0", engine)
    kw.setdefault("fault_restart_backoff_s", 0.05)
    kw.setdefault("fault_snapshot_interval_s", 1000.0)
    kw.setdefault("fault_probe_timeout_s", 10.0)
    return P.Cache(
        engine,
        time_source=P.time.PinnedTimeSource(1234),
        batch_window_us=100,
        kernel_deadline_s=deadline,
        device_failure_mode=mode,
        fault_interval_s=0,  # no supervisor thread: tick() by hand
        fault_clock=clock,
        **kw,
    )


def _rule(P, mgr, key="k"):
    cfg = P.loader.load_config([P.loader.ConfigFile("config.c", YAML)], mgr)
    return cfg.get_limit("d", P.api.Descriptor.of((key, "x")))


def _req(P, key="k", hits=1):
    return P.api.RateLimitRequest("d", [P.api.Descriptor.of((key, "x"))], hits)


def _code(P, cache, rule, key="k", req=None):
    return cache.do_limit(req or _req(P, key), [rule])[0].code.name


def _restart(fd, clock, step=0.06, tries=50):
    """Advance the fake clock past the backoff and tick until the bank
    closes."""
    for _ in range(tries):
        if not fd.is_quarantined(0):
            return
        clock.advance(step)
        fd.tick()
    assert not fd.is_quarantined(0)


# ---------------------------------------------------------------------------
# scenarios: each runs on one package and returns its outcome
# ---------------------------------------------------------------------------


def hang_bounds_the_rpc_and_quarantines(P):
    """A hung launch answers within the kernel deadline (never the
    dispatch timeout), records a hang fault and re-routes the bank to
    the host mirror, which keeps counting from the snapshot."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule) for _ in range(5)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "hang")
        t0 = time.monotonic()
        codes.append(_code(P, cache, rule))
        assert time.monotonic() - t0 < 2.0, "not deadline-bounded"
        quarantined_at = fd._records[0].quarantined_at
        codes += [_code(P, cache, rule) for _ in range(30)]
        assert codes.count("OK") == 20
        return dict(
            codes=codes,
            faults=dict(fd.stat_faults),
            quarantined=fd.is_quarantined(0),
            quarantined_at=quarantined_at,
            fallback_decisions=fd.stat_fallback_decisions,
        )
    finally:
        inj.heal()
        cache.close()


def _one_fault(P, mode, at, expect):
    inj = Injector()
    cache = make_cache(P, inj, clock=P.time.FakeMonotonicClock(CLOCK0))
    rule = _rule(P, P.Manager())
    try:
        codes = [_code(P, cache, rule)]
        inj.set("lane0", mode, at)
        codes.append(_code(P, cache, rule))
        fd = cache.fault_domain
        assert fd.stat_faults[expect] == 1
        return dict(codes=codes, faults=dict(fd.stat_faults), summary=fd.summary())
    finally:
        inj.heal()
        cache.close()


def exception_fault_classified_and_served(P):
    return _one_fault(P, "raise", "submit", "exception")


def device_lost_fault_classified(P):
    return _one_fault(P, "device_lost", "complete", "device_lost")


def watchdog_tick_detects_hang_without_traffic(P):
    """The watchdog quarantines a bank from the stuck stamp alone: the
    collector is held in a launch, the fake clock moves past the
    deadline, one tick quarantines; the RPC is then answered by the
    fallback."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.5, clock=clock)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        first = _code(P, cache, rule)
        inj.set("lane0", "hang")
        got = {}
        t = threading.Thread(target=lambda: got.update(code=_code(P, cache, rule)))
        t.start()
        d = cache._dispatchers[id(cache.engine)]
        deadline = time.monotonic() + 5
        while d._launch_busy_since is None and time.monotonic() < deadline:
            time.sleep(0.005)
        clock.advance(1.0)
        fd.tick()
        assert fd.is_quarantined(0)
        t.join(timeout=5)
        assert not t.is_alive()
        return dict(
            codes=[first, got["code"]],
            faults=dict(fd.stat_faults),
            fault_error=fd.summary()["banks"][0]["fault_error"],
        )
    finally:
        inj.heal()
        cache.close()


def mode_allow_answers_ok_without_stats(P):
    inj = Injector()
    cache = make_cache(P, inj, mode="allow", clock=P.time.FakeMonotonicClock(CLOCK0))
    mgr = P.Manager()
    rule = _rule(P, mgr)
    try:
        inj.set("lane0", "raise")
        before = {k: v for k, v in mgr.store.counters().items() if "over_limit" in k}
        codes = [_code(P, cache, rule) for _ in range(50)]  # far past 20
        after = {k: v for k, v in mgr.store.counters().items() if "over_limit" in k}
        assert codes == ["OK"] * 50 and before == after
        return dict(codes=codes, over_limit_stats=after)
    finally:
        inj.heal()
        cache.close()


def mode_deny_answers_over_limit_but_not_shadow(P):
    inj = Injector()
    cache = make_cache(P, inj, mode="deny", clock=P.time.FakeMonotonicClock(CLOCK0))
    mgr = P.Manager()
    rule, shadow_rule = _rule(P, mgr), _rule(P, mgr, "shadowed")
    try:
        inj.set("lane0", "raise")
        codes = [_code(P, cache, rule), _code(P, cache, shadow_rule, "shadowed")]
        assert codes == ["OVER_LIMIT", "OK"]  # shadow rules never enforce
        return dict(codes=codes)
    finally:
        inj.heal()
        cache.close()


def warm_restart_admits_exactly_the_limit(P):
    """Snapshot -> hang -> fallback counts -> supervised restart imports
    the mirror -> the key admits EXACTLY its limit over the episode."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule) for _ in range(5)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "hang")
        codes += [_code(P, cache, rule) for _ in range(10)]
        assert fd.is_quarantined(0)
        inj.heal()
        _restart(fd, clock)
        codes += [_code(P, cache, rule) for _ in range(20)]
        assert codes.count("OK") == 20 and fd.stat_restarts == 1
        return dict(codes=codes, restarts=fd.stat_restarts, faults=dict(fd.stat_faults))
    finally:
        inj.heal()
        cache.close()


def stall_at_completion_then_late_completion(P):
    """A stream that stalls and later drains (CUDA's shape: the
    completer is held in its event wait): the bank is quarantined and
    restarted while the stall lasts; when it ends, the old completer
    finishes the stalled batch, whose RPC was already answered from the
    mirror, and nothing of the new engine moves: the limit holds
    exactly."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    old = cache._dispatchers[id(cache.engine)]
    try:
        codes = [_code(P, cache, rule) for _ in range(4)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "stall", at="complete")
        codes += [_code(P, cache, rule) for _ in range(6)]
        _restart(fd, clock)  # while the old completer is still held
        codes += [_code(P, cache, rule) for _ in range(5)]
        inj.heal()  # the stall ends: the late completion runs
        deadline = time.monotonic() + 5
        while old.inflight() and time.monotonic() < deadline:
            time.sleep(0.005)
        codes += [_code(P, cache, rule) for _ in range(10)]
        assert codes.count("OK") == 20
        return dict(
            codes=codes,
            faults=dict(fd.stat_faults),
            restarts=fd.stat_restarts,
            late_inflight=old.inflight(),
        )
    finally:
        inj.heal()
        cache.close()


def probe_failure_keeps_bank_quarantined(P):
    """Half-open discipline: while the device still fails the restart
    probe fails, the bank stays on the fallback and the backoff grows;
    once healed the next attempt re-admits."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)

    def factory(bank, old):
        return inj.wrap("lane0", P.fd.default_engine_factory(bank, old))

    cache = make_cache(
        P, inj, deadline=0.2, clock=clock, engine_factory=factory, fault_probe_timeout_s=0.5
    )
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule)]
        inj.set("lane0", "raise")
        codes.append(_code(P, cache, rule))  # fallback
        rec = fd._records[0]
        steps = [(rec.state, rec.backoff_s, fd.stat_probe_failures)]
        clock.advance(rec.backoff_s + 0.01)
        fd.tick()  # probe against the still-failing replacement
        steps.append((rec.state, rec.backoff_s, fd.stat_probe_failures))
        assert fd.is_quarantined(0) and fd.stat_probe_failures == 1
        inj.heal()
        _restart(fd, clock, step=0.11)
        codes.append(_code(P, cache, rule))
        steps.append((rec.state, rec.backoff_s, fd.stat_probe_failures))
        return dict(codes=codes, steps=steps, restarts=fd.stat_restarts)
    finally:
        inj.heal()
        cache.close()


def caller_deadline_without_fault_domain(P):
    """With the fault domain OFF a hung dispatch still answers per
    DEVICE_FAILURE_MODE by the caller's deadline."""
    inj = Injector()
    engine = inj.wrap("lane0", P.Engine(num_slots=256, buckets=(8,), **P.engine_kw))
    cache = P.Cache(
        engine,
        time_source=P.time.PinnedTimeSource(1234),
        batch_window_us=100,
        dispatch_timeout_s=30.0,
        kernel_deadline_s=0.0,
        device_failure_mode="allow",
    )
    rule = _rule(P, P.Manager())
    try:
        codes = [_code(P, cache, rule)]
        inj.set("lane0", "hang")
        req = _req(P)
        req.deadline = time.monotonic() + 0.3
        t0 = time.monotonic()
        codes.append(_code(P, cache, rule, req=req))
        assert time.monotonic() - t0 < 1.5
        return dict(
            codes=codes,
            deadline_answers=cache.stat_deadline_answers,
            domain=cache.fault_domain,
        )
    finally:
        inj.heal()
        cache.close()


def caller_deadline_shorter_than_kernel_deadline_does_not_fault(P):
    inj = Injector()
    cache = make_cache(P, inj, mode="deny", deadline=5.0, clock=P.time.FakeMonotonicClock(CLOCK0))
    rule = _rule(P, P.Manager())
    try:
        codes = [_code(P, cache, rule)]
        inj.set("lane0", "hang")
        req = _req(P)
        req.deadline = time.monotonic() + 0.2
        t0 = time.monotonic()
        codes.append(_code(P, cache, rule, req=req))
        assert time.monotonic() - t0 < 1.5
        assert codes == ["OK", "OVER_LIMIT"]  # deny
        return dict(
            codes=codes,
            quarantined=cache.fault_domain.is_quarantined(0),
            deadline_answers=cache.stat_deadline_answers,
        )
    finally:
        inj.heal()
        cache.close()


def fault_counters_and_summary(P):
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, clock=clock)
    mgr = P.Manager()
    cache.register_stats(mgr.store)
    rule = _rule(P, mgr)
    try:
        inj.set("lane0", "raise")
        _code(P, cache, rule)
        clock.advance(0.5)
        counters = {
            k: v for k, v in mgr.store.counters().items() if k.startswith("ratelimit.tpu.fault")
        }
        gauges = mgr.store.snapshot()
        summary = cache.fault_domain.summary()
        bank = summary["banks"][0]
        assert counters["ratelimit.tpu.fault.exception"] == 1
        assert gauges["ratelimit.tpu.fault.quarantined_banks"] == 1
        assert bank["state"] == "quarantined" and bank["fault_kind"] == "exception"
        assert bank["quarantined_for_s"] == 0.5
        return dict(
            counters=counters,
            quarantined_banks=gauges["ratelimit.tpu.fault.quarantined_banks"],
            summary=summary,
        )
    finally:
        inj.heal()
        cache.close()


def swap_safe_gauges_follow_restart(P):
    """Bank gauges resolve the engine by index: after a warm restart
    they read the NEW engine."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    mgr = P.Manager()
    cache.register_stats(mgr.store)
    rule = _rule(P, mgr)
    fd = cache.fault_domain
    try:
        for _ in range(3):
            _code(P, cache, rule)
        inj.set("lane0", "raise")
        _code(P, cache, rule)
        inj.heal()
        _restart(fd, clock)
        _code(P, cache, rule)
        cache.flush()
        live = mgr.store.snapshot()["ratelimit.tpu.bank0.live_keys"]
        assert live >= 1
        return dict(live_keys=live, restarts=fd.stat_restarts)
    finally:
        inj.heal()
        cache.close()


def disabled_fault_domain_is_inert(P):
    """kernel_deadline_s=0 (the library default): no domain, no
    watchdog thread, plain decisions."""
    cache = P.Cache(
        P.Engine(num_slots=256, buckets=(8,), **P.engine_kw),
        time_source=P.time.PinnedTimeSource(1234),
        batch_window_us=100,
    )
    rule = _rule(P, P.Manager())
    try:
        codes = [_code(P, cache, rule) for _ in range(25)]
        assert cache.fault_domain is None
        assert codes == ["OK"] * 20 + ["OVER_LIMIT"] * 5
        return dict(codes=codes, domain=cache.fault_domain)
    finally:
        cache.close()


def bad_failure_mode_rejected(P):
    with pytest.raises(ValueError, match="DEVICE_FAILURE_MODE") as e:
        P.Cache(
            P.Engine(num_slots=64, buckets=(8,), **P.engine_kw),
            device_failure_mode="open",
        )
    return dict(message=str(e.value))


def health_degraded_while_quarantined(P):
    """A quarantined bank that is still served makes the service
    DEGRADED, not NOT_SERVING; the restart clears it."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    health = P.Health()
    cache.bind_health(health)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        states = [(health.healthy, health.degraded)]
        _code(P, cache, rule)
        inj.set("lane0", "raise")
        _code(P, cache, rule)
        states.append((health.healthy, health.degraded))
        inj.heal()
        _restart(fd, clock)
        states.append((health.healthy, health.degraded))
        assert states == [(True, False), (True, True), (True, False)]
        return dict(states=states)
    finally:
        inj.heal()
        cache.close()


def failing_factory_keeps_bank_on_the_mirror(P):
    """The shape of a lost device: every rebuild fails, the bank stays
    on the mirror (DEGRADED, still counting) and the backoff doubles up
    to its 60 s cap."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)

    def factory(bank, old):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    cache = make_cache(P, inj, deadline=0.2, clock=clock, engine_factory=factory)
    health = P.Health()
    cache.bind_health(health)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "device_lost")
        codes.append(_code(P, cache, rule))
        rec = fd._records[0]
        backoffs = [rec.backoff_s]
        for _ in range(14):
            clock.advance(rec.backoff_s)
            fd.tick()
            backoffs.append(rec.backoff_s)
        codes += [_code(P, cache, rule) for _ in range(20)]
        assert backoffs[-1] == 60.0 and fd.is_quarantined(0) and health.degraded
        assert codes.count("OK") == 20
        return dict(codes=codes, backoffs=backoffs, faults=dict(fd.stat_faults))
    finally:
        inj.heal()
        cache.close()


def fallback_stamps_flight_code(P):
    """A request answered by the fallback stamps FLIGHT_CODE_FALLBACK in
    the flight ring; the note is consumed, so the next record is a plain
    decision."""
    inj = Injector()
    cache = make_cache(P, inj, clock=P.time.FakeMonotonicClock(CLOCK0))
    cache.flight = P.obs.make_flight_recorder(64, clock=P.time.FakeMonotonicClock(CLOCK0))
    rule = _rule(P, P.Manager())
    try:
        inj.set("lane0", "raise")
        status = cache.do_limit(_req(P), [rule])[0]
        # The transport stamps after the decision, on the same thread
        # (the note is thread-local).
        cache.flight.record("d", int(status.code), 1, 1.0)
        first = cache.flight.snapshot_dicts()[0]
        assert first["code"] == P.obs.FLIGHT_CODE_FALLBACK and first["fallback"] is True
        cache.flight.record("d", int(P.api.Code.OK), 1, 1.0)
        after = cache.flight.snapshot_dicts()[0]
        assert "fallback" not in after
        return dict(first=first, after=after, status=status.code.name)
    finally:
        inj.heal()
        cache.close()


def _journal(P, cache):
    j = P.obs.make_event_journal(64, clock=P.time.FakeMonotonicClock(5.0), wall=lambda: 1.7e9)
    cache.events = j
    cache.fault_domain.events = j
    return j


def journal_tells_quarantine_fallback_restart_in_order(P):
    """Snapshot, hang, fallback answers, supervised restart: the journal
    holds one bank_quarantine, ONE bank_fallback for the episode, the
    half-open probe and the restart, in seq order, with the reference's
    details."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(P, inj, deadline=0.2, clock=clock)
    j = _journal(P, cache)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule) for _ in range(3)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "raise")
        codes += [_code(P, cache, rule) for _ in range(5)]
        inj.heal()
        _restart(fd, clock)
        codes += [_code(P, cache, rule) for _ in range(3)]
        events = j.snapshot()
        assert [e["type"] for e in events] == [
            "bank_quarantine", "bank_fallback", "bank_half_open", "bank_restart",
        ]
        assert [e["seq"] for e in events] == [1, 2, 3, 4]
        return dict(codes=codes, events=events, counts=j.counts())
    finally:
        inj.heal()
        cache.close()


def journal_records_failed_restarts(P):
    """A probe that fails and a factory that fails each leave a
    bank_restart_failed naming its stage and the next backoff."""
    inj, clock = Injector(), P.time.FakeMonotonicClock(CLOCK0)
    builds = []

    def factory(bank, old):
        builds.append(bank)
        if len(builds) == 1:
            raise RuntimeError("rebuild refused")
        return inj.wrap("lane0", P.fd.default_engine_factory(bank, old))

    cache = make_cache(
        P, inj, deadline=0.2, clock=clock, engine_factory=factory, fault_probe_timeout_s=0.5
    )
    j = _journal(P, cache)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule)]
        inj.set("lane0", "raise")
        codes.append(_code(P, cache, rule))
        rec = fd._records[0]
        for _ in range(2):  # the factory fails, then the probe
            clock.advance(rec.backoff_s + 0.01)
            fd.tick()
        inj.heal()
        _restart(fd, clock, step=0.21)
        events = j.snapshot()
        assert [e["type"] for e in events] == [
            "bank_quarantine", "bank_fallback", "bank_restart_failed",
            "bank_half_open", "bank_restart_failed", "bank_half_open", "bank_restart",
        ]
        return dict(codes=codes, events=events)
    finally:
        inj.heal()
        cache.close()


def fallback_answers_stamp_launch_records(P):
    """Each fallback answer of a quarantined bank is one OUTCOME_FALLBACK
    launch record of that bank; the failed launch is one OUTCOME_FAULT
    record; healthy launches are ok.  Phase durations are measured time
    and masked; a fault and the fallback that answers it race, so the
    records compare as a multiset."""
    inj = Injector()
    cache = make_cache(P, inj, clock=P.time.FakeMonotonicClock(CLOCK0))
    lr = P.obs.make_launch_recorder(64, clock=P.time.FakeMonotonicClock(1.0))
    cache.attach_launch_recorder(lr)
    rule = _rule(P, P.Manager())
    fd = cache.fault_domain
    try:
        codes = [_code(P, cache, rule) for _ in range(2)]
        inj.set("lane0", "raise")
        codes += [_code(P, cache, rule) for _ in range(4)]
        records = [
            {k: v for k, v in r.items() if k not in ("seq", "ts_ns", "queue_wait_us", "launch_us", "complete_us")}
            for r in lr.snapshot_dicts()
        ]
        outcomes = [r["outcome"] for r in records]
        assert outcomes.count("fallback") == fd.stat_fallback_decisions == 4
        return dict(
            codes=codes,
            records=sorted(records, key=lambda r: sorted(r.items())),
            items_by_algo=lr.items_by_algo(),
        )
    finally:
        inj.heal()
        cache.close()


SCENARIOS = [
    hang_bounds_the_rpc_and_quarantines,
    exception_fault_classified_and_served,
    device_lost_fault_classified,
    watchdog_tick_detects_hang_without_traffic,
    mode_allow_answers_ok_without_stats,
    mode_deny_answers_over_limit_but_not_shadow,
    warm_restart_admits_exactly_the_limit,
    stall_at_completion_then_late_completion,
    probe_failure_keeps_bank_quarantined,
    caller_deadline_without_fault_domain,
    caller_deadline_shorter_than_kernel_deadline_does_not_fault,
    fault_counters_and_summary,
    swap_safe_gauges_follow_restart,
    disabled_fault_domain_is_inert,
    bad_failure_mode_rejected,
    health_degraded_while_quarantined,
    failing_factory_keeps_bank_on_the_mirror,
    fallback_stamps_flight_code,
    journal_tells_quarantine_fallback_restart_in_order,
    journal_records_failed_restarts,
    fallback_answers_stamp_launch_records,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fault_scenario_same_in_both_packages(scenario):
    jax_outcome = scenario(JAX)
    port_outcome = scenario(PORT)
    assert port_outcome == jax_outcome


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------


def _chained(exc, cause):
    exc.__cause__ = cause
    return exc


@pytest.mark.parametrize(
    "exc",
    [
        TimeoutError("stuck"),
        ValueError("bad batch"),
        DeviceLost("lane0"),
        _chained(RuntimeError("batch dispatcher is dead"), DeviceLost("lane0")),
    ],
    ids=["timeout", "value_error", "device_lost", "chained"],
)
def test_shared_failure_shapes_classify_alike(exc):
    assert classify_fault(exc) == jax_fd.classify_fault(exc)


@pytest.mark.parametrize(
    "exc,kind",
    [
        (TimeoutError("device call stuck"), FAULT_HANG),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), FAULT_DEVICE_LOST),
        (RuntimeError("CUDA error: unspecified launch failure"), FAULT_DEVICE_LOST),
        (RuntimeError("CUDA error: device-side assert triggered"), FAULT_DEVICE_LOST),
        (RuntimeError("CUDA error: misaligned address"), FAULT_DEVICE_LOST),
        (RuntimeError("CUDA error: uncorrectable ECC error encountered"), FAULT_DEVICE_LOST),
        (RuntimeError("GPU has fallen off the bus"), FAULT_DEVICE_LOST),
        (KernelError("rl_fw_unique_step_lanes: CUDA launch failed with error 700", code=700), FAULT_DEVICE_LOST),
        (KernelError("k: CUDA launch failed with error 719", code=719), FAULT_DEVICE_LOST),
        (KernelError("k: CUDA launch failed with error 710", code=710), FAULT_DEVICE_LOST),
        (KernelError("k: CUDA launch failed with error 214", code=214), FAULT_DEVICE_LOST),
        (KernelError("k: CUDA launch failed with error 1", code=1), FAULT_EXCEPTION),
        (KernelError("k: CUDA launch failed with error 720", code=720), FAULT_EXCEPTION),
        (KernelError("kernel build failed: fixed_window.cu (rc=1)"), FAULT_EXCEPTION),
        (_chained(DispatcherDead("batch dispatcher died"), KernelError("k", code=716)), FAULT_DEVICE_LOST),
        # XLA's wording means nothing to the port.
        (RuntimeError("XlaRuntimeError: INTERNAL: device"), FAULT_EXCEPTION),
    ],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_cuda_failure_shapes(exc, kind):
    assert classify_fault(exc) == kind


def test_kernel_check_carries_the_code():
    from ratelimit_tpu_torch import kernels

    with pytest.raises(KernelError) as e:
        kernels.check(700, "rl_fw_unique_step_lanes")
    assert e.value.code == 700 and "error 700" in str(e.value)
    assert classify_fault(e.value) == FAULT_DEVICE_LOST


# ---------------------------------------------------------------------------
# the port's own: kernel defects and the restart's races
# ---------------------------------------------------------------------------


def _port_cache(inj, **kw):
    clock = port_time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(PORT, inj, deadline=0.2, clock=clock, **kw)
    health = HealthChecker()
    cache.bind_health(health)
    return cache, clock, health, _rule(PORT, Manager())


def _count_fallbacks(fd):
    calls = []
    real = fd.run_fallback

    def run_fallback(bank, item):
        calls.append(bank)
        return real(bank, item)

    fd.run_fallback = run_fallback
    return calls


@pytest.mark.parametrize(
    "exc,at",
    [
        (KernelError("kernel build failed: fixed_window.cu (rc=1):\nerror"), "submit"),
        (KernelError("cannot load libfixed_window.so: undefined symbol"), "submit"),
        (KernelError("rl_fw_unique_step_lanes: CUDA launch failed with error 1", code=1), "submit"),
        (KernelError("k: CUDA launch failed with error 720", code=720), "complete"),
    ],
    ids=["build", "load", "refused_launch", "too_large_launch"],
)
def test_kernel_defect_raises_and_never_reaches_the_mirror(exc, at):
    """A kernel that does not build, load or launch (no sticky code) is
    a defect of the port: every RPC raises CacheError, no bank is
    quarantined, the fallback answers nothing, and the service goes
    NOT_SERVING after unhealthy_after failures -- back to SERVING once
    the kernel launches again."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    fallbacks = _count_fallbacks(fd)
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", exc, at)
        for _ in range(3):
            with pytest.raises(CacheError, match="counter engine failure"):
                _code(PORT, cache, rule)
        clock.advance(1.0)
        fd.tick()
        assert fallbacks == [] and fd.stat_fallback_decisions == 0
        assert not fd.is_quarantined(0) and sum(fd.stat_faults.values()) == 0
        assert (health.healthy, health.degraded) == (False, False)
        inj.heal()
        assert _code(PORT, cache, rule) == "OK"
        assert (health.healthy, health.degraded) == (True, False)
    finally:
        inj.heal()
        cache.close()


def test_sticky_kernel_error_quarantines_onto_the_mirror():
    """The contrast: a launch that returns a sticky code (700, an
    illegal address) has lost the context, so the bank is quarantined
    as device_lost and the mirror answers (DEGRADED, still SERVING)."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    fallbacks = _count_fallbacks(fd)
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", KernelError("k: CUDA launch failed with error 700", code=700))
        assert _code(PORT, cache, rule) == "OK"
        assert fd.is_quarantined(0) and fd.stat_faults[FAULT_DEVICE_LOST] == 1
        assert fallbacks == [0]
        assert (health.healthy, health.degraded) == (True, True)
    finally:
        inj.heal()
        cache.close()


def test_dispatcher_killed_by_a_kernel_defect_is_not_quarantined():
    """The watchdog leaves a dispatcher that a kernel defect killed
    alone: the bank stays closed, its RPCs raise CacheError, and the
    service is NOT_SERVING."""
    cache, clock, health, rule = _port_cache(None)
    fd = cache.fault_domain
    try:
        assert _code(PORT, cache, rule) == "OK"
        cache.dispatcher.kill(KernelError("kernel build failed: prefix.cu (rc=1)"))
        clock.advance(1.0)
        fd.tick()
        assert not fd.is_quarantined(0) and sum(fd.stat_faults.values()) == 0
        with pytest.raises(CacheError):
            _code(PORT, cache, rule)
        assert (health.healthy, health.degraded) == (False, False)
    finally:
        cache.close()


class _ObservedLock:
    """A lock that notes when a caller had to wait for it."""

    def __init__(self, lock):
        self._lock = lock
        self.contended = threading.Event()

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            self.contended.set()
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_rpc_held_on_the_mirror_lock_across_the_swap_goes_to_the_new_engine():
    """An RPC that waits for the bank's mirror lock while the restart
    merges and swaps finds the bank closed when it gets the lock: it is
    answered by the new engine, counted once, and the key still admits
    exactly its limit."""
    inj = Injector()
    merging, release = threading.Event(), threading.Event()

    def factory(bank, old):
        engine = fd_mod.default_engine_factory(bank, old)
        real = engine.import_keys

        def import_keys(*args):
            merging.set()
            assert release.wait(10)
            return real(*args)

        engine.import_keys = import_keys
        return engine

    cache, clock, health, rule = _port_cache(inj, engine_factory=factory)
    fd = cache.fault_domain
    rec = fd._records[0]
    try:
        codes = [_code(PORT, cache, rule) for _ in range(5)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "raise")
        codes.append(_code(PORT, cache, rule))  # quarantines; the mirror answers
        inj.heal()
        assert fd.is_quarantined(0) and fd.stat_fallback_decisions == 1
        rec.lock = _ObservedLock(rec.lock)
        clock.advance(1.0)
        supervisor = threading.Thread(target=fd.tick)
        supervisor.start()
        assert merging.wait(10)  # the restart holds the mirror lock
        got = {}
        rpc = threading.Thread(target=lambda: got.update(code=_code(PORT, cache, rule)))
        rpc.start()
        assert rec.lock.contended.wait(10)  # the RPC waits for it
        release.set()
        supervisor.join(10)
        rpc.join(10)
        assert not supervisor.is_alive() and not rpc.is_alive()
        codes.append(got["code"])
        assert not fd.is_quarantined(0) and fd.stat_restarts == 1
        assert fd.stat_fallback_decisions == 1  # the held RPC reached the card
        codes += [_code(PORT, cache, rule) for _ in range(20)]
        assert codes.count("OK") == 20 and codes[:20] == ["OK"] * 20
        assert (health.healthy, health.degraded) == (True, False)
    finally:
        release.set()
        inj.heal()
        cache.close()


def test_failed_merge_keeps_the_bank_on_an_intact_mirror():
    """A restart whose merge of the mirror's counters fails does not
    re-admit the bank: it stays quarantined on a mirror that still
    holds every key, and the next restart carries the counts over, so
    the key admits exactly its limit."""
    inj = Injector()
    failures = [RuntimeError("merge failed")]

    def factory(bank, old):
        engine = fd_mod.default_engine_factory(bank, old)
        real = engine.import_keys

        def import_keys(*args):
            if failures:
                raise failures.pop()
            return real(*args)

        engine.import_keys = import_keys
        return engine

    cache, clock, health, rule = _port_cache(inj, engine_factory=factory)
    fd = cache.fault_domain
    rec = fd._records[0]
    try:
        codes = [_code(PORT, cache, rule) for _ in range(5)]
        assert fd.snapshot_now() == 1
        inj.set("lane0", "raise")
        codes += [_code(PORT, cache, rule) for _ in range(5)]
        inj.heal()
        clock.advance(rec.backoff_s + 0.01)
        fd.tick()
        assert fd.is_quarantined(0) and rec.state == "quarantined"
        assert fd.stat_restarts == 0 and fd.stat_probe_failures == 1
        assert rec.fallback.stat_live_keys == 1
        assert (health.healthy, health.degraded) == (True, True)
        codes += [_code(PORT, cache, rule) for _ in range(5)]
        _restart(fd, clock, step=0.11)
        codes += [_code(PORT, cache, rule) for _ in range(20)]
        assert codes.count("OK") == 20 and codes[:20] == ["OK"] * 20
        assert fd.stat_restarts == 1
    finally:
        inj.heal()
        cache.close()


def test_stale_fault_of_a_replaced_engine_quarantines_nothing():
    """A fault reported against an engine that a restart has already
    replaced is stale: the bank stays closed on its new engine."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    try:
        _code(PORT, cache, rule)
        old = cache.engine
        inj.set("lane0", "raise")
        _code(PORT, cache, rule)
        inj.heal()
        _restart(fd, clock)
        fd.record_fault(0, FAULT_HANG, TimeoutError("late"), engine=old)
        assert not fd.is_quarantined(0) and fd.stat_faults[FAULT_HANG] == 0
        assert _code(PORT, cache, rule) == "OK"
    finally:
        inj.heal()
        cache.close()


def test_snapshot_now_counts_only_its_own_snapshots(monkeypatch):
    """snapshot_now(bank) answers how many snapshots IT took, even when
    the supervisor snapshots another bank meanwhile (its first pass,
    a few tenths of a second after boot, snapshots every bank)."""
    from ratelimit_tpu_torch.backends import checkpoint
    from ratelimit_tpu_torch.models.registry import get_algorithm

    gcra = CounterEngine(
        buckets=(8,), device="cpu", model=get_algorithm("gcra").make_model(256, 0.8, device="cpu")
    )
    cache = make_cache(PORT, algorithm_banks={"gcra": gcra})
    fd = cache.fault_domain
    real = checkpoint.copy_engine
    fixed_window = cache._bank_engines[0]

    def copy_engine(engine):
        if engine is fixed_window:
            # The supervisor's snapshot of the GCRA bank lands while this
            # one is on the fixed-window bank's dispatcher thread.
            other = threading.Thread(
                target=fd._snapshot_bank,
                args=(1, fd._records[1], cache._dispatchers[id(gcra)], 0.0),
            )
            other.start()
            other.join()
        return real(engine)

    monkeypatch.setattr(checkpoint, "copy_engine", copy_engine)
    try:
        assert fd.snapshot_now(0) == 1
        assert fd.stat_snapshots == 2
        assert fd._records[0].snapshot is not None and fd._records[1].snapshot is not None
    finally:
        cache.close()


def test_restart_count_moves_after_health_is_restored():
    """A reader that waits for a bank's restart count to move (the card
    smoke, an operator polling /debug/faults) then reads SERVING, not
    DEGRADED: the restart refreshes health before it counts."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    rec = fd._records[0]
    seen = []
    real = fd._report_health

    def report_health():
        real()
        seen.append((rec.state, rec.restarts, health.degraded))

    fd._report_health = report_health
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        assert _code(PORT, cache, rule) == "OK"
        assert (health.healthy, health.degraded) == (True, True)
        inj.heal()
        _restart(fd, clock)
        assert rec.restarts == 1 and (health.healthy, health.degraded) == (True, False)
        assert seen[-1] == ("closed", 0, False)
    finally:
        inj.heal()
        cache.close()


def test_quarantine_reports_degraded_before_it_releases_the_rpcs():
    """The kill that sends a quarantined bank's waiting RPCs to the
    fallback comes after the DEGRADED report, so an RPC answered by
    the mirror never reads a health that has not seen the fault."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    d = cache._dispatchers[id(cache.engine)]
    seen = []
    real = d.kill

    def kill(exc):
        seen.append(health.degraded)
        real(exc)

    d.kill = kill
    try:
        assert _code(PORT, cache, rule) == "OK"
        fd.record_fault(0, FAULT_HANG, TimeoutError("stuck"))
        assert seen == [True]
        assert _code(PORT, cache, rule) == "OK" and health.degraded
    finally:
        inj.heal()
        cache.close()


def test_journal_hears_of_a_transition_after_its_health():
    """bank_quarantine comes out once DEGRADED is published, and
    bank_restart once SERVING is, before the restart count moves: a
    reader that waits on the journal or on the count reads the health
    the event reports."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    rec = fd._records[0]
    seen = []

    class Journal:
        def emit(self, etype, **detail):
            seen.append((etype, health.healthy, health.degraded, rec.restarts))

    fd.events = Journal()
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        assert _code(PORT, cache, rule) == "OK"
        inj.heal()
        _restart(fd, clock)
        assert seen == [
            ("bank_quarantine", True, True, 0),
            ("bank_fallback", True, True, 0),
            ("bank_half_open", True, True, 0),
            ("bank_restart", True, False, 0),
        ]
        assert rec.restarts == 1
    finally:
        inj.heal()
        cache.close()


def test_fallback_answers_wait_for_the_quarantine_event():
    """An RPC that finds the bank quarantined while bank_quarantine is
    still being written waits on the bank's fallback lock, so its
    bank_fallback never precedes the quarantine in the journal."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain
    emitting = threading.Event()
    journal = port_obs.make_event_journal(32)
    real_emit = journal.emit

    def emit(etype, **detail):
        if etype == "bank_quarantine":
            emitting.set()
            time.sleep(0.2)
        return real_emit(etype, **detail)

    journal.emit = emit
    fd.events = journal
    codes = []
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        first = threading.Thread(target=lambda: codes.append(_code(PORT, cache, rule)))
        first.start()
        assert emitting.wait(5)
        second = threading.Thread(target=lambda: codes.append(_code(PORT, cache, rule)))
        second.start()
        first.join(5)
        second.join(5)
        assert codes == ["OK", "OK"]
        assert [e["type"] for e in journal.snapshot()] == ["bank_quarantine", "bank_fallback"]
        assert fd.stat_fallback_decisions == 2
    finally:
        inj.heal()
        cache.close()


def test_a_raising_journal_never_blocks_a_quarantine():
    """A journal that raises loses the event; the bank is still
    quarantined, answered by the mirror and restarted."""
    inj = Injector()
    cache, clock, health, rule = _port_cache(inj)
    fd = cache.fault_domain

    class Broken:
        def emit(self, etype, **detail):
            raise RuntimeError("journal broke")

    fd.events = Broken()
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        assert _code(PORT, cache, rule) == "OK"
        assert fd.is_quarantined(0) and health.degraded
        inj.heal()
        _restart(fd, clock)
        assert fd.stat_restarts == 1 and not health.degraded
    finally:
        inj.heal()
        cache.close()


def test_restart_waits_for_the_stalled_stream_to_drain():
    """The supervisor makes no restart attempt while the quarantined
    engine's stream still has work: on the card a new engine's first
    pinned allocation waits for a stalled kernel and holds every other
    bank's launches meanwhile.  Once the stream drains, the next tick
    restarts the bank as before.  The episode's first deferral goes to
    the journal once, and /debug/faults says the restart waits."""
    inj, clock = Injector(), port_time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(PORT, inj, clock=clock)
    rule = _rule(PORT, Manager())
    fd = cache.fault_domain
    j = _journal(PORT, cache)
    try:
        codes = [_code(PORT, cache, rule)]
        inj.set("lane0", "raise")
        codes.append(_code(PORT, cache, rule))
        assert fd.is_quarantined(0)
        inj.heal()
        busy = [True]
        stalled = fd.engine_at(0)
        stalled._stream = SimpleNamespace(query=lambda: not busy[0], cuda_stream=-1)
        for _ in range(10):
            clock.advance(0.06)
            fd.tick()
        assert fd.is_quarantined(0) and fd.stat_restarts == 0
        assert fd.stat_probe_failures == 0
        deferred = [e for e in j.snapshot() if e["type"] == "bank_restart_failed"]
        assert [e["stage"] for e in deferred] == ["stream_busy"]
        bank = fd.summary()["banks"][0]
        assert bank["restart_waits_for_stream"] is True
        assert bank["next_restart_in_s"] == pytest.approx(fd.interval_s, abs=0.07)
        busy[0] = False
        _restart(fd, clock)
        assert fd.stat_restarts == 1 and fd.engine_at(0) is not stalled
        codes.append(_code(PORT, cache, rule))
        assert codes == ["OK", "OK", "OK"]
    finally:
        inj.heal()
        cache.close()


def test_a_stream_whose_query_raises_does_not_hold_the_restart():
    """A lost context makes the stream's query raise: that is no busy
    stream.  The restart attempt goes ahead, its factory fails as on a
    sticky error, the journal says so and the backoff grows."""
    inj, clock = Injector(), port_time.FakeMonotonicClock(CLOCK0)
    calls = []

    def factory(bank, old):
        calls.append(bank)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    cache = make_cache(PORT, inj, clock=clock, engine_factory=factory)
    rule = _rule(PORT, Manager())
    fd = cache.fault_domain
    j = _journal(PORT, cache)
    try:
        assert _code(PORT, cache, rule) == "OK"
        inj.set("lane0", "raise")
        assert _code(PORT, cache, rule) == "OK"
        inj.heal()

        def lost():
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        fd.engine_at(0)._stream = SimpleNamespace(query=lost, cuda_stream=-1)
        backoffs = []
        for _ in range(3):
            clock.advance(fd._records[0].next_restart - clock.now() + 0.01)
            fd.tick()
            backoffs.append(fd._records[0].backoff_s)
        assert calls == [0, 0, 0] and fd.is_quarantined(0)
        assert backoffs == sorted(backoffs) and backoffs[-1] > backoffs[0]
        failed = [e["stage"] for e in j.snapshot() if e["type"] == "bank_restart_failed"]
        assert failed == ["factory"] * 3
        assert "restart_waits_for_stream" not in fd.summary()["banks"][0]
    finally:
        inj.heal()
        cache.close()


def test_a_snapshot_queued_behind_a_stall_is_a_hang():
    """On the card a snapshot's copy waits on the bank's stream.  One
    queued just behind a stalled kernel holds the dispatcher thread
    outside any launch: the copy runs as a device call, so the stuck
    stamp shows it, and the supervisor's wait gives up at the deadline
    and records the hang (the bank goes to its mirror) instead of
    holding the watchdog for the whole stall."""
    inj, clock = Injector(), port_time.FakeMonotonicClock(CLOCK0)
    cache = make_cache(PORT, inj, clock=clock)
    rule = _rule(PORT, Manager())
    fd = cache.fault_domain
    d = cache._dispatchers[id(cache.engine)]
    release = threading.Event()
    inner = cache.engine._engine
    real_export = inner.export_state

    def export_state():
        release.wait(10)  # the copy behind the stalled kernel
        return real_export()

    try:
        codes = [_code(PORT, cache, rule)]
        inner.export_state = export_state
        took = {}
        t = threading.Thread(target=lambda: took.update(n=fd.snapshot_now(0), at=time.monotonic()))
        t0 = time.monotonic()
        t.start()
        give_up = time.monotonic() + 5
        while d._launch_busy_since is None and time.monotonic() < give_up:
            time.sleep(0.005)
        assert d._launch_busy_since is not None  # the copy is stamped
        clock.advance(1.0)  # past the 0.25 s deadline
        t.join(timeout=5)
        assert not t.is_alive() and took["n"] == 0
        assert took["at"] - t0 < 0.9  # gave up before the 1 s token wait
        assert fd.is_quarantined(0) and fd.stat_faults["hang"] == 1
        codes.append(_code(PORT, cache, rule))  # the mirror answers
        assert fd.stat_fallback_decisions == 1
        release.set()
        inner.export_state = real_export
        _restart(fd, clock)
        codes.append(_code(PORT, cache, rule))
        assert codes == ["OK", "OK", "OK"] and fd.stat_faults["hang"] == 1
    finally:
        release.set()
        inj.heal()
        cache.close()


def test_run_on_thread_abandons_and_stamps_device_calls():
    """run_on_thread(abandon=...) gives up as soon as the predicate
    holds (the call still runs later); a device_call is stamped like a
    launch while it runs, and a plain call is not."""
    from ratelimit_tpu_torch.backends.dispatcher import BatchDispatcher

    clock = port_time.FakeMonotonicClock(CLOCK0)
    d = BatchDispatcher(
        CounterEngine(num_slots=64, buckets=(8,), device="cpu"), stamp_clock=clock
    )
    gate, seen = threading.Event(), []
    try:
        def blocked():
            seen.append(d.stuck_age(clock.now() + 1.0))
            gate.wait(10)

        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            d.run_on_thread(blocked, timeout=30.0, device_call=True,
                            abandon=lambda: d._launch_busy_since is not None)
        assert time.monotonic() - t0 < 5.0
        assert seen == [1.0]  # stamped while it runs
        gate.set()
        d.run_on_thread(lambda: seen.append(d.stuck_age(clock.now() + 1.0)))
        assert seen == [1.0, 0.0]  # a plain call is not
        assert d._launch_busy_since is None
    finally:
        gate.set()
        d.stop()
