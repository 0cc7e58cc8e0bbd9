"""The runtime lock sanitizer's scenarios, runnable against either
package's sanitizer in a fresh interpreter:

    python sanitizer_scenarios.py <package> <scenario>

<package> is ``ratelimit_tpu`` or ``ratelimit_tpu_torch``.  The script
installs that package's sanitizer with its scope set to this file, so
only the locks made here are tracked, runs one scenario and prints one
JSON line: the violations' kinds and details.  The scenarios are those
of tests/test_sanitizer.py; the ``card_*`` ones exercise the port's
waits for the card and need torch.
"""

import importlib
import json
import sys
import threading
import time


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def _order(x, y):
    with x:
        with y:
            pass


def ab_ba(san):
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    _in_thread(lambda: _order(lock_a, lock_b))
    assert san.violations() == []  # one order alone is fine
    _in_thread(lambda: _order(lock_b, lock_a))


def consistent_order(san):
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    for _ in range(3):
        _in_thread(lambda: _order(lock_a, lock_b))


def three_lock_cycle(san):
    la = threading.Lock()
    lb = threading.Lock()
    lc = threading.Lock()
    _in_thread(lambda: _order(la, lb))
    _in_thread(lambda: _order(lb, lc))
    assert san.violations() == []
    _in_thread(lambda: _order(lc, la))


def same_creation_site(san):
    def make():
        return threading.Lock()  # one shared creation site

    inst1, inst2 = make(), make()
    other = threading.Lock()
    _in_thread(lambda: _order(other, inst1))
    _in_thread(lambda: _order(inst2, other))


def rlock_reentrancy(san):
    r = threading.RLock()
    lock_b = threading.Lock()

    def worker():
        with r:
            with r:
                with lock_b:
                    pass

    _in_thread(worker)


def duplicate_reported_once(san):
    la = threading.Lock()
    lb = threading.Lock()
    _in_thread(lambda: _order(la, lb))
    for _ in range(3):
        _in_thread(lambda: _order(lb, la))


def sleep_under_lock(san):
    lock = threading.Lock()

    def worker():
        with lock:
            time.sleep(0)

    _in_thread(worker)


def sleep_outside_lock(san):
    lock = threading.Lock()

    def worker():
        with lock:
            pass
        time.sleep(0)

    _in_thread(worker)


def untimed_event_wait_under_lock(san):
    lock = threading.Lock()
    ev = threading.Event()
    ev.set()

    def worker():
        with lock:
            ev.wait()

    _in_thread(worker)


def timed_event_wait_under_lock(san):
    lock = threading.Lock()
    ev = threading.Event()

    def worker():
        with lock:
            ev.wait(timeout=0.001)

    _in_thread(worker)


def allow_blocking(san):
    lock = threading.Lock()
    mod = sys.modules[type(san).__module__]

    def sanctioned():
        with lock:
            with mod.allow_blocking("non-blocking gate: 409s"):
                time.sleep(0)

    _in_thread(sanctioned)
    assert san.violations() == []

    def unsanctioned():
        with lock:
            time.sleep(0)

    _in_thread(unsanctioned)
    try:
        mod.allow_blocking("")
    except ValueError:
        pass
    else:
        raise AssertionError("an empty justification was accepted")


def condition_wait(san):
    cv = threading.Condition()
    mod = sys.modules[type(san).__module__]

    def waiter():
        with cv:
            cv.wait(timeout=0.01)
        assert mod._TLS.held == []

    _in_thread(waiter)


def condition_notify(san):
    cv = threading.Condition()
    ready = []

    def consumer():
        with cv:
            while not ready:
                cv.wait(timeout=1.0)

    t = threading.Thread(target=consumer)
    t.start()
    with cv:
        ready.append(1)
        cv.notify()
    t.join()


def _card_wait(fn):
    try:
        fn()
    except (RuntimeError, AssertionError, TypeError, AttributeError):
        pass  # no card here: the wait is noted before the real call


def card_sync_under_lock(san):
    import torch

    lock = threading.Lock()

    def worker():
        with lock:
            _card_wait(torch.cuda.synchronize)

    _in_thread(worker)


def card_stream_and_event_under_lock(san):
    import torch

    lock = threading.Lock()
    dummy = object()

    def worker():
        with lock:
            _card_wait(lambda: torch.cuda.Stream.synchronize(dummy))
            _card_wait(lambda: torch.cuda.Event.synchronize(dummy))

    _in_thread(worker)


def card_sync_sanctioned(san):
    import torch

    lock = threading.Lock()
    mod = sys.modules[type(san).__module__]

    def worker():
        with lock:
            with mod.allow_blocking("test of the sanctioned card wait"):
                _card_wait(torch.cuda.synchronize)
        _card_wait(torch.cuda.synchronize)  # no lock held: fine

    _in_thread(worker)


INLINE_YAML = """domain: s
descriptors:
  - key: k
    rate_limit:
      unit: hour
      requests_per_unit: 100
"""


def inline_readback_wait(san):
    """The port's inline serving (no batch window): the wait for a
    submission's readback -- on the card an event wait, stood in for
    here by a time.sleep(0) in CounterEngine._fetch -- must hold no lock
    that the bank's other requests take."""
    from ratelimit_tpu_torch import api
    from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache
    from ratelimit_tpu_torch.backends.engine import CounterEngine
    from ratelimit_tpu_torch.config import loader
    from ratelimit_tpu_torch.stats.manager import Manager
    from ratelimit_tpu_torch.utils.time import PinnedTimeSource

    fetch = CounterEngine._fetch

    def waiting_fetch(self, handle):
        time.sleep(0)
        return fetch(self, handle)

    CounterEngine._fetch = waiting_fetch
    cfg = loader.load_config([loader.ConfigFile("config.s", INLINE_YAML)], Manager())
    cache = CudaRateLimitCache(
        CounterEngine(num_slots=256, buckets=(8,), device="cpu"),
        time_source=PinnedTimeSource(1234),
        batch_window_us=0,
    )
    req = api.RateLimitRequest("s", [api.Descriptor.of(("k", "v"))], 0)
    limits = [cfg.get_limit(req.domain, d) for d in req.descriptors]
    codes = [cache.do_limit(req, limits)[0].code for _ in range(3)]
    assert codes == [api.Code.OK] * 3, codes


SCENARIOS = {
    f.__name__: f
    for f in (
        ab_ba,
        consistent_order,
        three_lock_cycle,
        same_creation_site,
        rlock_reentrancy,
        duplicate_reported_once,
        sleep_under_lock,
        sleep_outside_lock,
        untimed_event_wait_under_lock,
        timed_event_wait_under_lock,
        allow_blocking,
        condition_wait,
        condition_notify,
        card_sync_under_lock,
        card_stream_and_event_under_lock,
        card_sync_sanctioned,
        inline_readback_wait,
    )
}

#: Scenarios that track the port's own locks too.
PORT_SCOPE = {"inline_readback_wait"}


def main(package: str, scenario: str) -> None:
    if scenario.startswith("card_"):
        import torch  # noqa: F401  (loaded BEFORE install: the waits get patched)
    mod = importlib.import_module(f"{package}.analysis.sanitizer")
    san = mod.get()
    san.scope = ("sanitizer_scenarios.py",)
    if scenario in PORT_SCOPE:
        san.scope += ("ratelimit_tpu_torch",)
    san.install()
    try:
        SCENARIOS[scenario](san)
    finally:
        san.uninstall()
    print(
        json.dumps(
            {
                "kinds": [v.kind for v in san.violations()],
                "details": [v.detail for v in san.violations()],
                "torch_loaded": "torch" in sys.modules,
            }
        )
    )


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
