"""Membership churn against the port: benchmarks/membership_churn.py's
two legs with ratelimit_tpu_torch replicas, on the CPU or on the card.

    python3 scripts/torch_membership_churn.py --device cpu --out churn.json
    python3 scripts/torch_membership_churn.py --device cuda --out churn.json

Three in-process replicas (a CudaRateLimitCache over one CounterEngine
on --device and a RateLimitService each, on a pinned clock) behind the
port's ReplicaRouter and RouterHolder with fault-injected transports
(the port's cluster/faults.py); sustained background traffic from a
closed pool of workers over a Zipf key mix (this file's copy of the
replay generator); a fixed-limit target key offered 4x its 120/minute
limit, half before and half after the churn; mid-run one replica is
killed (ejection and in-request failover), then membership swaps to
add a fresh replica, which becomes the target key's owner.

- controlled: the swap runs the handoff coordinator (forwarding window,
  export and import through LocalAdminTransports, the code path the
  proxy drives over HTTP).  The target's counter moves: it admits at
  most limit + slack over all 480 hits;
- uncontrolled: a plain swap.  The moved key's window restarts on the
  new owner and it over-admits.

Writes both legs and the checks as JSON to --out (never into
benchmarks/).  Exits non-zero when a check fails.
"""

import argparse
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache  # noqa: E402
from ratelimit_tpu_torch.backends.engine import CounterEngine  # noqa: E402
from ratelimit_tpu_torch.cluster.faults import FaultInjector  # noqa: E402
from ratelimit_tpu_torch.cluster.handoff import HandoffCoordinator, LocalAdminTransport  # noqa: E402
from ratelimit_tpu_torch.cluster.hashing import owner_id  # noqa: E402
from ratelimit_tpu_torch.cluster.proxy import RouterHolder  # noqa: E402
from ratelimit_tpu_torch.cluster.router import ReplicaRouter  # noqa: E402
from ratelimit_tpu_torch.server.codec import request_from_pb, response_to_pb  # noqa: E402
from ratelimit_tpu_torch.service import RateLimitService  # noqa: E402
from ratelimit_tpu_torch.stats.manager import Manager  # noqa: E402
from ratelimit_tpu_torch.utils.time import PinnedTimeSource  # noqa: E402

from ratelimit_tpu_torch.server import pb  # noqa: F401,E402
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

NOW = 1_700_000_010  # pinned: the minute window never rolls mid-run
LIMIT = 120  # target key: requests/minute
SLACK = 5
BG_WORKERS = 16

OLD_IDS = ["repl-a", "repl-b", "repl-c"]
NEW_IDS = ["repl-a", "repl-b", "repl-d"]
KILLED = "repl-c"
JOINED = "repl-d"


# -- the replay generator (a copy of benchmarks/replay.py's) ------------------


@dataclass
class Event:
    """One offered request: ``dt`` seconds after the previous event."""

    dt: float
    domain: str
    key: str
    hits: int = 1


def _zipf_probs(n_keys: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n_keys + 1, dtype=float)
    p = ranks ** -alpha
    return p / p.sum()


def workload_zipf(
    n: int,
    rate: float,
    domains: Sequence[tuple] = (("paying", 0.3), ("guest", 0.6), ("stray", 0.1)),
    n_keys: int = 64,
    alpha: float = 1.2,
    hot_share: float = 0.15,
    seed: int = 7,
) -> List[Event]:
    """Poisson arrivals at ``rate`` req/s, Zipf(alpha) key popularity,
    a fixed domain mix, and ``hot_share`` of guest and paying traffic on
    the single ``hot`` key."""
    rng = np.random.default_rng(seed)
    names = [d for d, _w in domains]
    w = np.asarray([w for _d, w in domains], dtype=float)
    pw = w / w.sum()
    dts = rng.exponential(1.0 / rate, n)
    doms = rng.choice(len(names), n, p=pw)
    keys = rng.choice(n_keys, n, p=_zipf_probs(n_keys, alpha))
    hot = rng.random(n) < hot_share
    out = []
    for i in range(n):
        d = names[doms[i]]
        k = "hot" if (d in ("guest", "paying") and hot[i]) else f"v{keys[i]}"
        out.append(Event(float(dts[i]), d, k))
    return out


class _Runtime:
    """A runtime loader over fixed files (RateLimitService's seam)."""

    def __init__(self, files):
        self._files = files

    def snapshot(self):
        files = self._files

        class Snap:
            def keys(self):
                return sorted(files)

            def get(self, key):
                return files.get(key, "")

        return Snap()

    def add_update_callback(self, fn):
        pass


# -- the churn ------------------------------------------------------------------


def churn_yaml(target_value: str) -> str:
    return (
        "domain: churn\n"
        "descriptors:\n"
        "  - key: k\n"
        f"    value: {target_value}\n"
        "    rate_limit:\n"
        "      unit: minute\n"
        f"      requests_per_unit: {LIMIT}\n"
        "  - key: k\n"
        "    rate_limit:\n"
        "      unit: hour\n"
        "      requests_per_unit: 100000000\n"
    )


def find_target_value() -> str:
    """A value whose owner survives the kill under the old membership
    and is the joiner under the new one: the key whose counter travels."""
    for i in range(10_000):
        v = f"t{i}"
        stem = f"churn_k_{v}_"
        if owner_id(stem, OLD_IDS) in ("repl-a", "repl-b") and owner_id(stem, NEW_IDS) == JOINED:
            return v
    raise RuntimeError("no target value found")


def build_replica(clock, yaml: str, device: str):
    cache = CudaRateLimitCache(CounterEngine(num_slots=1 << 12, buckets=(8, 32, 128), device=device), clock)
    service = RateLimitService(_Runtime({"config.churn": yaml}), cache, Manager())
    return cache, service


def pb_request(value: str) -> rls_pb2.RateLimitRequest:
    req = rls_pb2.RateLimitRequest(domain="churn")
    e = req.descriptors.add().entries.add()
    e.key, e.value = "k", value
    return req


def service_transport(service):
    def call(req, timeout_s=None):
        return response_to_pb(service.should_rate_limit(request_from_pb(req)))

    return call


def p99_ms(samples) -> float:
    return float(np.percentile(np.asarray(samples), 99) * 1000.0) if samples else 0.0


def run_leg(controlled: bool, device: str, seed: int = 11) -> dict:
    clock = PinnedTimeSource(NOW)
    target = find_target_value()
    yaml = churn_yaml(target)
    caches, services = {}, {}
    for rid in sorted(set(OLD_IDS + NEW_IDS)):
        caches[rid], services[rid] = build_replica(clock, yaml, device)
    faults = FaultInjector()

    def make_router(ids):
        return ReplicaRouter(
            ids,
            [faults.wrap(rid, service_transport(services[rid])) for rid in ids],
            eject_after=3,
            readmit_after_s=30.0,
            failure_policy="local-cache",
            retry_max=1,
            retry_base_s=0.005,
        )

    handoff = None
    if controlled:
        admins = {rid: LocalAdminTransport(caches[rid]) for rid in caches if rid != KILLED}
        handoff = HandoffCoordinator(admins.get).run
    holder = RouterHolder(make_router(OLD_IDS), handoff=handoff)

    events = workload_zipf(20_000, rate=1000.0, domains=(("churn", 1.0),), n_keys=64, seed=seed)
    ev_counter = itertools.count()
    stop_bg = threading.Event()
    bg_done = [0] * BG_WORKERS
    bg_lat: list = []
    bg_lock = threading.Lock()

    def bg_worker(w):
        local = []
        while not stop_bg.is_set():
            ev = events[next(ev_counter) % len(events)]
            t0 = time.perf_counter()
            try:
                holder.should_rate_limit(pb_request(ev.key), timeout_s=5.0)
            except Exception:  # noqa: BLE001 -- background load only
                pass
            local.append(time.perf_counter() - t0)
            bg_done[w] += 1
        with bg_lock:
            bg_lat.extend(local[::7])

    bg_threads = [threading.Thread(target=bg_worker, args=(w,), daemon=True) for w in range(BG_WORKERS)]
    t_run0 = time.perf_counter()
    for t in bg_threads:
        t.start()

    def burst(n, pace_s=0.008):
        admitted, lat = 0, []
        for _ in range(n):
            t0 = time.perf_counter()
            resp = holder.should_rate_limit(pb_request(target), timeout_s=5.0)
            lat.append(time.perf_counter() - t0)
            admitted += resp.overall_code == rls_pb2.RateLimitResponse.OK
            time.sleep(pace_s)
        return admitted, lat

    adm1, lat1 = burst(2 * LIMIT)
    faults.kill(KILLED)
    time.sleep(0.6)
    stats_degraded = holder.stats()
    holder.swap(make_router(NEW_IDS), grace_s=1.0)
    if controlled:
        deadline = time.monotonic() + 10.0
        while holder.last_handoff is None and time.monotonic() < deadline:
            time.sleep(0.01)
        if holder.last_handoff is None:
            raise RuntimeError("handoff never completed")
    adm2, lat2 = burst(2 * LIMIT)

    stop_bg.set()
    for t in bg_threads:
        t.join(timeout=10)
    elapsed = time.perf_counter() - t_run0
    holder.close()
    st = holder.stats()
    out = {
        "controlled": controlled,
        "target_value": target,
        "limit_per_minute": LIMIT,
        "offered_target": 4 * LIMIT,
        "admitted_target": adm1 + adm2,
        "admitted_phase1": adm1,
        "admitted_phase2": adm2,
        "target_p99_ms": round(p99_ms(lat1 + lat2), 3),
        "background_requests": int(sum(bg_done)),
        "background_rps": round(sum(bg_done) / elapsed, 1),
        "background_p99_ms": round(p99_ms(bg_lat), 3),
        "elapsed_s": round(elapsed, 2),
        "degraded_at_kill": {
            k: stats_degraded[k]
            for k in ("ejections", "failovers", "fallback_descriptors", "retries", "live_replicas")
        },
        "router_final": {
            k: st[k]
            for k in ("ejections", "failovers", "fallback_descriptors", "forwarded", "degraded_denials", "retries")
        },
        "handoff": holder.last_handoff,
        "replicas": {},
    }
    for rid in sorted(caches):
        if rid != KILLED:
            snap = caches[rid].handoff_log.snapshot()
            out["replicas"][rid] = {
                k: snap[k] for k in ("exported_keys", "imported_keys", "merged_keys")
            }
        caches[rid].close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--out", required=True, help="write the result JSON here")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("--device cuda needs a CUDA GPU", file=sys.stderr)
            return 2
    print("== membership churn: controlled (handoff) leg ==", flush=True)
    controlled = run_leg(True, args.device)
    print(json.dumps(controlled, indent=2), flush=True)
    print("== membership churn: uncontrolled (no handoff) leg ==", flush=True)
    uncontrolled = run_leg(False, args.device)
    print(json.dumps(uncontrolled, indent=2), flush=True)

    h = controlled["handoff"] or {}
    checks = {
        "controlled_within_bound": controlled["admitted_target"] <= LIMIT + SLACK,
        "uncontrolled_over_admits": uncontrolled["admitted_target"] >= LIMIT + 50,
        "handoff_moved_target": h.get("imported", 0) + h.get("merged", 0) > 0,
        "replica_ejected": controlled["degraded_at_kill"]["ejections"] >= 1,
        "failover_served_killed_replicas_keys": controlled["degraded_at_kill"]["failovers"] >= 1,
        "no_keys_lost_in_transfer": h.get("imported", 0) + h.get("merged", 0) == h.get("moved_keys", -1),
        "target_p99_controlled_ms": controlled["target_p99_ms"] < 250.0,
    }
    result = {
        "benchmark": "torch_membership_churn",
        "scenario": (
            f"kill {KILLED} + join {JOINED} under sustained zipf load; target key offered 4x its "
            f"{LIMIT}/min limit (2x before the churn, 2x after)"
        ),
        "bound": f"admitted <= limit + {SLACK} (controlled leg)",
        "device": args.device,
        "controlled": controlled,
        "uncontrolled": uncontrolled,
        "checks": checks,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"result written to {args.out}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print(f"FAILED checks: {failed}")
        return 1
    print("all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
