"""The port's runtime lock sanitizer (ratelimit_tpu_torch.analysis.
sanitizer) against the JAX package's, on the JAX sanitizer's scenarios,
plus what only the port's has: the card's waits, its default scope and
its summary.

Every scenario runs in a fresh interpreter
(tests/torch_lint_fixtures/sanitizer_scenarios.py), once per package:
the sanitizer patches the threading factories process-wide, and
tests/conftest.py may already have installed the JAX package's (whose
default scope also matches the port's paths).  The in-process tests
below swap in a fresh instance and uninstall it afterwards.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from ratelimit_tpu_torch.analysis import sanitizer

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "tests" / "torch_lint_fixtures" / "sanitizer_scenarios.py"
INLINE_YAML = """domain: s
descriptors:
  - key: k
    rate_limit:
      unit: hour
      requests_per_unit: 100
"""

#: scenario -> violation kinds, as tests/test_sanitizer.py asserts them
SHARED = {
    "ab_ba": ["lock-order-cycle"],
    "consistent_order": [],
    "three_lock_cycle": ["lock-order-cycle"],
    "same_creation_site": ["lock-order-cycle"],
    "rlock_reentrancy": [],
    "duplicate_reported_once": ["lock-order-cycle"],
    "sleep_under_lock": ["held-across-blocking-call"],
    "sleep_outside_lock": [],
    "untimed_event_wait_under_lock": ["held-across-blocking-call"],
    "timed_event_wait_under_lock": [],
    "allow_blocking": ["held-across-blocking-call"],
    "condition_wait": [],
    "condition_notify": [],
}


def run(package, scenario):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_SANITIZE")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), package, scenario],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("scenario", sorted(SHARED))
def test_same_violations_as_the_jax_sanitizer(scenario):
    jax = run("ratelimit_tpu", scenario)
    port = run("ratelimit_tpu_torch", scenario)
    assert port["kinds"] == jax["kinds"] == SHARED[scenario]
    # the module stays stdlib: installing it loads no torch
    assert not port["torch_loaded"]


def test_card_wait_under_a_lock_is_reported():
    out = run("ratelimit_tpu_torch", "card_sync_under_lock")
    assert out["torch_loaded"]
    assert out["kinds"] == ["held-across-blocking-call"]
    assert "torch.cuda.synchronize()" in out["details"][0]


def test_stream_and_event_waits_under_a_lock_are_reported():
    out = run("ratelimit_tpu_torch", "card_stream_and_event_under_lock")
    assert out["kinds"] == ["held-across-blocking-call"] * 2
    assert "torch.cuda.Stream.synchronize()" in out["details"][0]
    assert "torch.cuda.Event.synchronize()" in out["details"][1]


def test_sanctioned_card_wait_is_clean():
    assert run("ratelimit_tpu_torch", "card_sync_sanctioned")["kinds"] == []


# -- in-process: a fresh instance, uninstalled afterwards ---------------------


@pytest.fixture
def san(monkeypatch):
    """A fresh, installed sanitizer; one scripts/torch_sanitize.py
    installs is suspended meanwhile."""
    prev = sanitizer.get()
    prev_installed = prev.installed
    if prev_installed:
        prev.uninstall()
    fresh = sanitizer.LockSanitizer()
    monkeypatch.setattr(sanitizer, "_SANITIZER", fresh)
    fresh.install()
    try:
        yield fresh
    finally:
        fresh.uninstall()
        monkeypatch.setattr(sanitizer, "_SANITIZER", prev)
        if prev_installed:
            prev.install()


def _lock_made_in(filename):
    ns = {"threading": threading}
    exec(compile("lock = threading.Lock()", filename, "exec"), ns)
    return ns["lock"]


def test_default_scope_is_the_port_and_its_tests():
    assert sanitizer.LockSanitizer().scope == (
        "ratelimit_tpu_torch",
        "tests/test_torch_",
    )


@pytest.mark.parametrize(
    "filename, tracked",
    [
        ("/x/ratelimit_tpu_torch/backends/engine.py", True),
        ("/x/tests/test_torch_engine.py", True),
        ("/x/ratelimit_tpu/backends/engine.py", False),
        ("/x/tests/test_sanitizer.py", False),
    ],
)
def test_default_scope_leaves_the_jax_package_alone(san, filename, tracked):
    san.scope = sanitizer.LockSanitizer().scope
    lock = _lock_made_in(filename)
    assert isinstance(lock, sanitizer._SanitizedLockBase) is tracked


def test_summary_counts_locks_edges_and_violations(san):
    la = threading.Lock()
    lb = threading.Lock()
    with la:
        with lb:
            time.sleep(0)
    s = san.summary()
    # >=: under scripts/torch_sanitize.py other tests' threads may make
    # and take tracked locks meanwhile
    assert s["locks"] >= 2 and s["lock_sites"] >= 2
    assert la._key in san._sites and lb._key in san._sites
    assert s["order_edges"] >= 1 and lb._key in san._graph[la._key]
    assert s["by_kind"].get("held-across-blocking-call", 0) >= 1
    assert s["violations"] == sum(s["by_kind"].values())


def test_uninstall_restores_the_factories(san):
    assert threading.Lock is not san._orig["Lock"]
    san.uninstall()
    try:
        assert threading.Lock is san._orig["Lock"]
        assert time.sleep is san._orig["sleep"]
        assert threading.Event.wait is san._orig["event_wait"]
    finally:
        san.install()


def test_card_waits_restored_on_uninstall(san):
    torch = pytest.importorskip("torch")
    san.uninstall()
    orig = torch.cuda.synchronize
    orig_stream = torch.cuda.Stream.synchronize
    orig_event = torch.cuda.Event.synchronize
    san.install()  # torch is loaded now: its waits are patched
    try:
        assert torch.cuda.synchronize is not orig
        assert torch.cuda.Event.synchronize is not orig_event
    finally:
        san.uninstall()
    assert torch.cuda.synchronize is orig
    assert torch.cuda.Stream.synchronize is orig_stream
    assert torch.cuda.Event.synchronize is orig_event
    san.install()


def test_inline_readback_wait_holds_no_lock():
    """With no batch window a request serves inline: its wait for the
    readback (on the card an event wait, here a sleep standing in for
    it) ran under the bank's inline lock, which every other request to
    the bank takes; it now runs after the lock is released."""
    out = run("ratelimit_tpu_torch", "inline_readback_wait")
    assert out["kinds"] == [], out["details"]


def test_inline_serving_exact_under_threads():
    """The inline path now waits for its readback outside the bank's
    lock, so several requests may complete on one engine at once: 16
    threads (more than cores) with a short switch interval, the first
    readbacks held until more than STAGING_POOL_CAP are in flight, must
    still count every hit exactly and leave the engine's pool of idle
    stagings at its cap."""
    from ratelimit_tpu_torch import api
    from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
    from ratelimit_tpu_torch.backends.engine import STAGING_POOL_CAP, CounterEngine
    from ratelimit_tpu_torch.config import loader
    from ratelimit_tpu_torch.stats.manager import Manager
    from ratelimit_tpu_torch.utils.time import PinnedTimeSource

    yaml = INLINE_YAML.replace("requests_per_unit: 100", "requests_per_unit: 100000")
    cfg = loader.load_config([loader.ConfigFile("config.s", yaml)], Manager())
    engine = CounterEngine(num_slots=256, buckets=(8, 32), device="cpu")
    fetch = engine._fetch
    count_lock = threading.Lock()
    in_flight = [0, 0]  # now, peak
    enough = threading.Event()

    def slow_fetch(handle):
        # The first readbacks wait until more than the cap are in flight.
        with count_lock:
            in_flight[0] += 1
            in_flight[1] = max(in_flight[1], in_flight[0])
            if in_flight[0] > STAGING_POOL_CAP:
                enough.set()
        enough.wait(timeout=60)
        try:
            return fetch(handle)
        finally:
            with count_lock:
                in_flight[0] -= 1

    engine._fetch = slow_fetch
    cache = CudaRateLimitCache(
        engine,
        time_source=PinnedTimeSource(1234),
        batch_window_us=0,
    )
    req = api.RateLimitRequest("s", [api.Descriptor.of(("k", "hot"))], 0)
    limits = [cfg.get_limit(req.domain, d) for d in req.descriptors]
    threads_n, per_thread = 16, 40
    errors = []

    def worker():
        try:
            for _ in range(per_thread):
                if cache.do_limit(req, limits)[0].code != api.Code.OK:
                    errors.append("refused")
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    [status] = cache.do_limit(req, limits)
    assert status.limit_remaining == 100000 - threads_n * per_thread - 1
    assert in_flight[1] > STAGING_POOL_CAP
    assert len(engine._free_staging) <= STAGING_POOL_CAP
