"""The host-only memory backend (ratelimit_tpu_torch/backends/memory_cache.py)
against the JAX package's, on the CPU.

The same seeded request stream, under clocks pinned to the same second,
goes to both packages' MemoryRateLimitCache and must give equal
statuses, equal stats and equal window counters (tolerance 0): 2000
requests with shadow rules, a local over-limit cache and expiration
jitter drawn from equal seeds.  Then the twins of the concurrency
fixes of tests/test_concurrency_fixes.py (no lost increment under 8
threads, a gc sweep that resurrects no window), and the three-way
differential of tests/test_backends.py: the port's memory backend, the
port's counter backend on the CPU and the JAX memory backend agree.
"""

import random
import threading
from types import SimpleNamespace

import pytest

from ratelimit_tpu import api as jax_api
from ratelimit_tpu.backends.memory_cache import MemoryRateLimitCache as JaxMemory
from ratelimit_tpu.config import loader as jax_loader
from ratelimit_tpu.limiter.local_cache import LocalCache as JaxLocalCache
from ratelimit_tpu.stats.manager import Manager as JaxManager
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch import api
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
from ratelimit_tpu_torch.backends.engine import CounterEngine
from ratelimit_tpu_torch.backends.memory_cache import MemoryRateLimitCache
from ratelimit_tpu_torch.config import loader
from ratelimit_tpu_torch.limiter.local_cache import LocalCache
from ratelimit_tpu_torch.stats.manager import Manager
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

YAML = """
domain: diff
descriptors:
  - key: a
    rate_limit: {unit: second, requests_per_unit: 3}
  - key: b
    value: vb
    shadow_mode: true
    rate_limit: {unit: minute, requests_per_unit: 5}
  - key: c
    rate_limit: {unit: hour, requests_per_unit: 20}
  - key: d
    rate_limit: {unit: minute, requests_per_unit: 7}
  - key: big
    rate_limit: {unit: hour, requests_per_unit: 10000000}
  - key: g
    rate_limit: {unit: second, requests_per_unit: 1000}
"""

JAX = SimpleNamespace(
    name="jax",
    api=jax_api,
    loader=jax_loader,
    Manager=JaxManager,
    Clock=JaxPinned,
    Memory=JaxMemory,
    LocalCache=JaxLocalCache,
)
PORT = SimpleNamespace(
    name="port",
    api=api,
    loader=loader,
    Manager=Manager,
    Clock=PinnedTimeSource,
    Memory=MemoryRateLimitCache,
    LocalCache=LocalCache,
)
BOTH = (JAX, PORT)
BOTH_IDS = [P.name for P in BOTH]


def _cfg(P, mgr):
    return P.loader.load_config([P.loader.ConfigFile("d.yaml", YAML)], mgr)


def _do(P, cache, cfg, pairs, hits=0):
    """(code name, remaining, duration) per descriptor of one request
    whose descriptors are the (key, value) `pairs`."""
    descs = [P.api.Descriptor.of(p) for p in pairs]
    req = P.api.RateLimitRequest("diff", descs, hits)
    limits = [cfg.get_limit("diff", d) for d in descs]
    return [
        (s.code.name, s.limit_remaining, s.duration_until_reset)
        for s in cache.do_limit(req, limits)
    ]


POOL = [("a", str(i)) for i in range(3)] + [
    ("b", "vb"),
    ("c", "z"),
    ("d", "p"),
    ("d", "q"),
    ("nope", "q"),
]


@pytest.mark.parametrize("local_cache,jitter", [(False, 0), (True, 0), (True, 30)],
                         ids=["plain", "local-cache", "local-cache-jitter"])
def test_port_memory_equals_jax_memory_over_2000_requests(local_cache, jitter):
    """2000 seeded requests of 1-4 descriptors (hits_addend 0-3, the
    clock moving 0-40 s now and then): equal statuses request by
    request, equal stats and equal window counters at the end."""
    mgrs = [P.Manager() for P in BOTH]
    cfgs = [_cfg(P, m) for P, m in zip(BOTH, mgrs)]
    clocks = [P.Clock(1_000_000) for P in BOTH]
    caches = [
        P.Memory(
            clock,
            local_cache=P.LocalCache(1 << 16, clock=clock.unix_now) if local_cache else None,
            expiration_jitter_max_seconds=jitter,
            jitter_rand=random.Random(3),
        )
        for P, clock in zip(BOTH, clocks)
    ]
    rng = random.Random(42)
    overs = 0
    for step in range(2000):
        pairs = [rng.choice(POOL) for _ in range(rng.randint(1, 4))]
        hits = rng.randint(0, 3)
        got = [_do(P, c, cfg, pairs, hits) for P, c, cfg in zip(BOTH, caches, cfgs)]
        assert got[0] == got[1], step
        overs += sum(g[0] == "OVER_LIMIT" for g in got[1])
        if rng.random() < 0.1:
            dt = rng.randint(1, 40)
            for clock in clocks:
                clock.now += dt
    assert overs > 100  # the stream exercises the limits, not just OK
    assert mgrs[0].store.counters() == mgrs[1].store.counters()
    assert caches[0]._counters == caches[1]._counters


def _hammer(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_concurrent_increments_not_lost(P):
    """8 threads x 200 requests on ONE key: the window counter equals
    the exact hit total (an unlocked RMW would drop interleaved
    increments and admit traffic past the limit)."""
    cfg = _cfg(P, P.Manager())
    mem = P.Memory(P.Clock(1_000_000))
    _hammer(8, lambda _i: [_do(P, mem, cfg, [("big", "v")], 1) for _ in range(200)])
    # 1600 concurrent hits + this probe's own.
    assert _do(P, mem, cfg, [("big", "v")], 1)[0][:2] == ("OK", 10_000_000 - (8 * 200 + 1))


@pytest.mark.parametrize("P", BOTH, ids=BOTH_IDS)
def test_gc_does_not_resurrect_under_write(P):
    """The expiry sweep shares the counters lock: after 4 threads churn
    one SECOND window and the window expires, the next request sweeps
    and starts a fresh window with exactly one hit."""
    cfg = _cfg(P, P.Manager())
    clock = P.Clock(1_000_000)
    mem = P.Memory(clock)
    _hammer(4, lambda _i: [_do(P, mem, cfg, [("g", "v")], 1) for _ in range(100)])
    clock.now += 5  # expire the window; the next request sweeps
    assert _do(P, mem, cfg, [("g", "v")], 1)[0][:2] == ("OK", 1000 - 1)
    assert list(mem._counters.values()) == [(1, 1_000_006)]


def test_three_way_differential():
    """Randomized traffic (the twin of tests/test_backends.py's
    differential): the port's memory backend, the port's counter
    backend over a CPU table and the JAX memory backend agree on codes,
    remaining, reset and per-rule stats."""
    mgrs = [Manager(), Manager(), JaxManager()]
    cfgs = [_cfg(PORT, mgrs[0]), _cfg(PORT, mgrs[1]), _cfg(JAX, mgrs[2])]
    clocks = [PinnedTimeSource(1234), PinnedTimeSource(1234), JaxPinned(1234)]
    caches = [
        MemoryRateLimitCache(clocks[0]),
        CudaRateLimitCache(
            CounterEngine(num_slots=256, buckets=(8, 32), device="cpu"),
            time_source=clocks[1],
        ),
        JaxMemory(clocks[2]),
    ]
    packages = (PORT, PORT, JAX)
    rng = random.Random(42)
    for step in range(300):
        pairs = [rng.choice(POOL) for _ in range(rng.randint(1, 4))]
        hits = rng.randint(0, 3)
        got = [_do(P, c, cfg, pairs, hits) for P, c, cfg in zip(packages, caches, cfgs)]
        assert got[0] == got[1] == got[2], step
        if rng.random() < 0.3:
            dt = rng.randint(1, 40)
            for clock in clocks:
                clock.now += dt
    caches[1].flush()
    counters = [m.store.counters() for m in mgrs]
    assert counters[0] == counters[1] == counters[2]
    caches[1].close()
