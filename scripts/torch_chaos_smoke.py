"""Device-path chaos smoke of the port: scripts/chaos_smoke.py's legs
against ratelimit_tpu_torch, on the CPU or on the card.

    python3 scripts/torch_chaos_smoke.py --device cpu [--out result.json]
    python3 scripts/torch_chaos_smoke.py --device cuda

Two legs over the same workload -- four load threads over a wide
keyspace plus a probe key offered well past its 120/minute limit --
with a hang injected at the engine's launch seam mid-run by the port's
DeviceFaultInjector (ratelimit_tpu_torch/cluster/faults.py), which
parks the dispatcher's collector thread in the launch:

- controlled (KERNEL_DEADLINE_S armed, DEVICE_FAILURE_MODE=host): the
  hung bank is quarantined within about one deadline, request p99 stays
  bounded with no failed request, fallback answers stamp
  FLIGHT_CODE_FALLBACK in the flight ring, and the supervised warm
  restart restores the counters: the probe key admits exactly its limit
  across the whole episode;
- uncontrolled (fault domain off, the dispatch timeout cut from 120 s
  to 2 s): the same hang stalls every request on the bank for the whole
  dispatch timeout and then fails it.

Then the allow / deny matrix -- a bank whose launches raise answers
every /json request 200 under allow and 429 under deny, over a real
HTTP listener -- and the controlled leg's journal read back over the
debug listener's /debug/events: quarantine, fallback, restart in order.
The mirror is reached only through the fault domain's deadline and its
failure mode; nothing wraps a launch to swallow its error.

Prints each check and, with --out, writes the result as JSON there.
Exits non-zero when a check fails.
"""

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ratelimit_tpu_torch.api import Code, Descriptor, RateLimitRequest  # noqa: E402
from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache  # noqa: E402
from ratelimit_tpu_torch.backends.engine import CounterEngine  # noqa: E402
from ratelimit_tpu_torch.cluster.faults import DeviceFaultInjector  # noqa: E402
from ratelimit_tpu_torch.config.loader import ConfigFile, load_config  # noqa: E402
from ratelimit_tpu_torch.observability import (  # noqa: E402
    FLIGHT_CODE_FALLBACK,
    make_flight_recorder,
)
from ratelimit_tpu_torch.observability.events import EventJournal  # noqa: E402
from ratelimit_tpu_torch.server.http_server import (  # noqa: E402
    HttpServer,
    add_debug_routes,
    add_json_handler,
)
from ratelimit_tpu_torch.service import CacheError, RateLimitService  # noqa: E402
from ratelimit_tpu_torch.stats.manager import Manager, StatsStore  # noqa: E402
from ratelimit_tpu_torch.utils.time import PinnedTimeSource  # noqa: E402

YAML = """
domain: chaos
descriptors:
  - key: probe
    rate_limit:
      unit: minute
      requests_per_unit: 120
  - key: load
    rate_limit:
      unit: minute
      requests_per_unit: 1000000
"""

KERNEL_DEADLINE_S = 0.2
UNCONTROLLED_DISPATCH_TIMEOUT_S = 2.0  # stands in for the 120 s default
LOAD_THREADS = 4
LOAD_KEYS = 64


def check(checks, name, ok, detail):
    checks.append({"name": name, "ok": bool(ok), "detail": detail})
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)


def build_cache(inj, device, controlled, mode="host"):
    engine = inj.wrap_engine(
        "lane0", CounterEngine(num_slots=4096, buckets=(8, 64), device=device)
    )
    return CudaRateLimitCache(
        engine,
        time_source=PinnedTimeSource(1_000_000),
        batch_window_us=200,
        dispatch_timeout_s=120.0 if controlled else UNCONTROLLED_DISPATCH_TIMEOUT_S,
        kernel_deadline_s=KERNEL_DEADLINE_S if controlled else 0.0,
        device_failure_mode=mode,
        fault_restart_backoff_s=0.25,
        fault_snapshot_interval_s=1000.0,  # snapshot_now pins the envelope
        fault_interval_s=0.05,
        fault_probe_timeout_s=10.0,
    )


def run_leg(device, controlled, journal=None):
    """One leg: load and probe traffic, a hang injected mid-run, heal,
    then (controlled) the warm restart.  Returns its metrics."""
    inj = DeviceFaultInjector()
    cache = build_cache(inj, device, controlled)
    flight = make_flight_recorder(4096)
    cache.flight = flight
    if journal is not None and cache.fault_domain is not None:
        cache.fault_domain.events = journal
    cfg = load_config([ConfigFile("config.c", YAML)], Manager())
    probe_rule = cfg.get_limit("chaos", Descriptor.of(("probe", "p")))
    load_rule = cfg.get_limit("chaos", Descriptor.of(("load", "x")))

    lat_ms = []
    lat_lock = threading.Lock()
    errors = [0]
    stop = threading.Event()

    def timed(req, rule):
        t0 = time.perf_counter()
        try:
            code = cache.do_limit(req, [rule])[0].code
            flight.record("chaos", int(code), 1, (time.perf_counter() - t0) * 1e3)
        except CacheError:
            errors[0] += 1
            code = None
        with lat_lock:
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        return code

    def loader(tid):
        i = 0
        while not stop.is_set():
            i += 1
            key = f"x{(tid * 7919 + i) % LOAD_KEYS}"
            timed(RateLimitRequest("chaos", [Descriptor.of(("load", key))], 1), load_rule)

    def probe_once():
        return timed(RateLimitRequest("chaos", [Descriptor.of(("probe", "p"))], 1), probe_rule)

    threads = [threading.Thread(target=loader, args=(t,), daemon=True) for t in range(LOAD_THREADS)]
    for t in threads:
        t.start()

    admitted = 0
    for _ in range(60):  # healthy
        admitted += probe_once() is Code.OK
    if controlled:
        cache.fault_domain.snapshot_now()

    # The uncontrolled leg's probes each wait out the whole dispatch
    # timeout in turn (that stall is the finding): fewer of them.
    fault_probes = 60 if controlled else 6
    inj.hang("lane0")
    t_fault = time.monotonic()
    quarantine_latency = None
    fault_codes = []
    for _ in range(fault_probes):
        fault_codes.append(probe_once())
        if controlled and quarantine_latency is None and cache.fault_domain.is_quarantined(0):
            quarantine_latency = time.monotonic() - t_fault
    admitted += sum(c is Code.OK for c in fault_codes)

    inj.heal()
    restarted = False
    if controlled:
        deadline = time.monotonic() + 30
        while cache.fault_domain.is_quarantined(0) and time.monotonic() < deadline:
            time.sleep(0.05)
        restarted = not cache.fault_domain.is_quarantined(0)
    post_errors_before = errors[0]
    for _ in range(120):
        admitted += probe_once() is Code.OK

    stop.set()
    for t in threads:
        t.join(timeout=5)
    with lat_lock:
        lats = np.array(lat_ms)
    fd = cache.fault_domain
    metrics = {
        "leg": "controlled" if controlled else "uncontrolled",
        "offers": 180 + fault_probes,
        "probe_admitted": int(admitted),
        "probe_limit": 120,
        "requests": int(len(lats)),
        "cache_errors": int(errors[0]),
        "post_heal_errors": int(errors[0] - post_errors_before),
        "p50_ms": round(float(np.percentile(lats, 50)), 3),
        "p99_ms": round(float(np.percentile(lats, 99)), 3),
        "max_ms": round(float(lats.max()), 3),
        "quarantine_latency_s": (
            round(quarantine_latency, 3) if quarantine_latency is not None else None
        ),
        "warm_restarted": restarted,
        "flight_fallback_records": sum(1 for r in flight.snapshot_dicts() if r.get("fallback")),
        "faults": dict(fd.stat_faults) if fd is not None else None,
        "fallback_decisions": fd.stat_fallback_decisions if fd is not None else None,
        "restarts": fd.stat_restarts if fd is not None else None,
        "injected": inj.stat_injected,
    }
    cache.close()
    return metrics


class _Runtime:
    """The chaos config as a runtime snapshot, for the service."""

    def snapshot(self):
        class Snap:
            def keys(self):
                return ["config.c"]

            def get(self, key):
                return YAML

        return Snap()

    def add_update_callback(self, fn):
        pass


def _post_json(port):
    body = json.dumps(
        {"domain": "chaos", "descriptors": [{"entries": [{"key": "probe", "value": "p"}]}]}
    ).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/json", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def run_mode_matrix(device):
    """allow | deny static fallback answers of a bank whose launches
    raise, over a real /json listener."""
    out = {}
    for mode, want in (("allow", 200), ("deny", 429)):
        inj = DeviceFaultInjector()
        cache = build_cache(inj, device, controlled=True, mode=mode)
        service = RateLimitService(_Runtime(), cache, Manager(), clock=cache.time_source)
        server = HttpServer("127.0.0.1", 0, name="chaos-api")
        add_json_handler(server, service)
        server.start()
        try:
            first = _post_json(server.bound_port)
            inj.raise_error("lane0")
            answers = [_post_json(server.bound_port) for _ in range(5)]
        finally:
            inj.heal()
            server.stop()
            cache.close()
        out[mode] = {"first": first, "answers": answers, "ok": first == 200 and all(a == want for a in answers)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--out", default="", help="write the result JSON here")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("--device cuda needs a CUDA GPU", file=sys.stderr)
            return 2
    checks = []
    print(f"== controlled leg (fault domain armed, mode=host, {args.device}) ==", flush=True)
    journal = EventJournal(size=256)
    ctl = run_leg(args.device, controlled=True, journal=journal)
    print(json.dumps(ctl, indent=2), flush=True)
    print("== uncontrolled leg (fault domain off) ==", flush=True)
    unc = run_leg(args.device, controlled=False)
    print(json.dumps(unc, indent=2), flush=True)
    matrix = run_mode_matrix(args.device)

    check(
        checks,
        "quarantined_within_one_deadline",
        ctl["quarantine_latency_s"] is not None
        and ctl["quarantine_latency_s"] <= 2 * KERNEL_DEADLINE_S + 0.25,
        f"{ctl['quarantine_latency_s']}s vs deadline {KERNEL_DEADLINE_S}s",
    )
    check(
        checks,
        "controlled_p99_bounded",
        ctl["p99_ms"] <= 1000.0 and ctl["cache_errors"] == 0,
        f"p99 {ctl['p99_ms']}ms, errors {ctl['cache_errors']} (no stall, no failed request)",
    )
    check(
        checks,
        "controlled_probe_exact_limit",
        ctl["probe_admitted"] == ctl["probe_limit"] and ctl["warm_restarted"],
        f"admitted {ctl['probe_admitted']}/{ctl['probe_limit']} across "
        f"snapshot->hang->fallback->restart (restarted={ctl['warm_restarted']})",
    )
    check(
        checks,
        "fallback_stamped_in_flight_ring",
        ctl["flight_fallback_records"] > 0,
        f"{ctl['flight_fallback_records']} FLIGHT_CODE_FALLBACK ({FLIGHT_CODE_FALLBACK}) records",
    )
    check(
        checks,
        "uncontrolled_stalls_and_errors",
        unc["max_ms"] >= UNCONTROLLED_DISPATCH_TIMEOUT_S * 1000 * 0.9 and unc["cache_errors"] > 0,
        f"max {unc['max_ms']}ms (dispatch timeout {UNCONTROLLED_DISPATCH_TIMEOUT_S * 1000:.0f}ms), "
        f"{unc['cache_errors']} failed requests",
    )
    check(
        checks,
        "failure_mode_matrix",
        matrix["allow"]["ok"] and matrix["deny"]["ok"],
        f"/json allow -> {matrix['allow']['answers']}, deny -> {matrix['deny']['answers']}",
    )

    srv = HttpServer("127.0.0.1", 0, name="chaos-debug")
    add_debug_routes(srv, StatsStore(), events=journal)
    srv.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.bound_port}/debug/events", timeout=5
        ) as r:
            served = json.loads(r.read())["events"]
    finally:
        srv.stop()
    types = [e["type"] for e in served]

    def first(etype):
        return types.index(etype) if etype in types else None

    order = [first("bank_quarantine"), first("bank_fallback"), first("bank_restart")]
    check(
        checks,
        "journal_quarantine_fallback_restart_in_order",
        all(i is not None for i in order)
        and order == sorted(order)
        and all(a["ts_mono_ns"] <= b["ts_mono_ns"] for a, b in zip(served, served[1:])),
        f"/debug/events timeline: {types}",
    )

    result = {
        "device": args.device,
        "kernel_deadline_s": KERNEL_DEADLINE_S,
        "uncontrolled_dispatch_timeout_s": UNCONTROLLED_DISPATCH_TIMEOUT_S,
        "controlled": ctl,
        "uncontrolled": unc,
        "failure_mode_matrix": matrix,
        "events": types,
        "checks": checks,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    failed = [c["name"] for c in checks if not c["ok"]]
    if failed:
        print(f"CHAOS SMOKE FAILED: {failed}")
        return 1
    print("chaos smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
