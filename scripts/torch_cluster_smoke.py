"""Cluster smoke of the port: scripts/cluster_smoke.py's elastic-tier
happy path against ratelimit_tpu_torch, on the CPU or on the card.

    python3 scripts/torch_cluster_smoke.py --device cpu [--out result.json]
    python3 scripts/torch_cluster_smoke.py --device cuda

Boots three in-process replicas (a CudaRateLimitCache over one
CounterEngine on --device, a RateLimitService and its real debug HTTP
listener with the handoff POSTs open) behind the port proxy's
RouterHolder, then:

1. enforces one limit jointly through the router;
2. kills one replica (the port's FaultInjector): ejection, in-request
   failover, and -- after killing the second too -- the degraded
   CLUSTER_FAILURE_MODE answer (local-cache: a known-over key denied, a
   cold key admitted);
3. heals, then adds the third replica through RouterHolder.swap with
   the handoff coordinator driving the real HTTP admin endpoints
   (POST /debug/cluster/export|import): the moved counter does not
   restart its window, and the joiner's ratelimit.cluster.* handoff
   counters move;
4. kills and heals a replica of the new membership: the shared journal
   holds the episode in order -- replica_eject ... handoff_end ...
   replica_readmit -- and the proxy's GET /fleet.json merges at least
   two live replicas (each one's /metrics liveness and SLO section, and
   the timeline with the proxy's own ``_proxy`` rows).

Prints each check and, with --out, writes the result as JSON there.
Exits non-zero when a check fails.
"""

import argparse
import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ratelimit_tpu_torch.backends.cuda_cache import CudaRateLimitCache  # noqa: E402
from ratelimit_tpu_torch.backends.engine import CounterEngine  # noqa: E402
from ratelimit_tpu_torch.cluster.faults import FaultInjector  # noqa: E402
from ratelimit_tpu_torch.cluster.handoff import HandoffCoordinator, HttpAdminTransport  # noqa: E402
from ratelimit_tpu_torch.cluster.hashing import owner_id  # noqa: E402
from ratelimit_tpu_torch.cluster.proxy import RouterHolder, start_debug_server  # noqa: E402
from ratelimit_tpu_torch.cluster.router import ReplicaRouter  # noqa: E402
from ratelimit_tpu_torch.config.loader import ConfigFile, load_config  # noqa: E402
from ratelimit_tpu_torch.observability.events import EventJournal  # noqa: E402
from ratelimit_tpu_torch.observability.slo import SloEngine  # noqa: E402
from ratelimit_tpu_torch.server.codec import request_from_pb, response_to_pb  # noqa: E402
from ratelimit_tpu_torch.server.http_server import HttpServer, add_debug_routes  # noqa: E402
from ratelimit_tpu_torch.service import RateLimitService  # noqa: E402
from ratelimit_tpu_torch.stats.manager import Manager  # noqa: E402
from ratelimit_tpu_torch.utils.time import PinnedTimeSource  # noqa: E402

from ratelimit_tpu_torch.server import pb  # noqa: F401,E402
from envoy.service.ratelimit.v3 import rls_pb2  # noqa: E402

YAML = (
    "domain: smoke\n"
    "descriptors:\n"
    "  - key: k\n"
    "    rate_limit:\n"
    "      unit: minute\n"
    "      requests_per_unit: 5\n"
)

OK = rls_pb2.RateLimitResponse.OK
OVER = rls_pb2.RateLimitResponse.OVER_LIMIT


class _Runtime:
    """A runtime loader over fixed files (RateLimitService's seam)."""

    def __init__(self, files):
        self.files = files

    def snapshot(self):
        files = self.files

        class Snap:
            def keys(self):
                return list(files)

            def get(self, key):
                return files[key]

        return Snap()

    def add_update_callback(self, fn):
        pass


class Replica:
    def __init__(self, clock, device):
        self.cache = CudaRateLimitCache(
            CounterEngine(num_slots=1 << 10, buckets=(8, 32), device=device), clock
        )
        # The replica's journal: the handoff seams stamp
        # handoff_export / handoff_import here, and /debug/events serves
        # it for the proxy's /fleet.json.
        self.journal = EventJournal(size=64)
        self.cache.events = self.journal
        self.manager = Manager()
        self.service = RateLimitService(_Runtime({"config.smoke": YAML}), self.cache, Manager())
        # A real SLO engine on the serving path, so /fleet.json has a
        # burn section per replica to merge.
        self.slo = SloEngine(self.manager)
        self.service.slo = self.slo
        self.debug = HttpServer("127.0.0.1", 0, name="smoke-debug")
        add_debug_routes(
            self.debug, self.manager.store, self.service, slo=self.slo,
            cluster_handoff_enabled=True, events=self.journal,
        )
        self.debug.start()

    @property
    def admin_url(self):
        return f"http://127.0.0.1:{self.debug.bound_port}"

    def transport(self):
        def call(req, timeout_s=None):
            return response_to_pb(self.service.should_rate_limit(request_from_pb(req)))

        return call

    def stop(self):
        self.debug.stop()
        self.cache.close()


def pb_request(value):
    req = rls_pb2.RateLimitRequest(domain="smoke")
    e = req.descriptors.add().entries.add()
    e.key, e.value = "k", value
    return req


def check(checks, name, ok, detail=""):
    checks.append({"name": name, "ok": bool(ok), "detail": detail})
    print(f"{'ok  ' if ok else 'FAIL'} {name}{': ' + detail if detail else ''}", flush=True)


def run(device, checks) -> dict:
    # The config must load through the port's own loader first: a bad
    # YAML fails here, not as an empty-config OK from every replica.
    load_config([ConfigFile("config.smoke", YAML)], Manager())
    clock = PinnedTimeSource(1_700_000_020)
    ids2 = ["r1", "r2"]
    ids3 = ["r1", "r2", "r3"]
    replicas = {rid: Replica(clock, device) for rid in ids3}
    faults = FaultInjector()
    # The proxy's journal: the router's eject / readmit and the
    # holder's membership and handoff events land here.
    journal = EventJournal(size=256)

    def make_router(ids, readmit_after_s=60.0):
        return ReplicaRouter(
            ids,
            [faults.wrap(rid, replicas[rid].transport()) for rid in ids],
            eject_after=2,
            readmit_after_s=readmit_after_s,
            failure_policy="local-cache",
            retry_max=1,
            retry_base_s=0.001,
            events=journal,
        )

    admins = {rid: HttpAdminTransport(r.admin_url) for rid, r in replicas.items()}
    holder = RouterHolder(make_router(ids2), handoff=HandoffCoordinator(admins.get).run, events=journal)
    debug = start_debug_server(
        holder, "127.0.0.1", 0, admin_urls={rid: r.admin_url for rid, r in replicas.items()}, events=journal
    )
    out = {}
    try:
        # A key that moves to r3 when it joins, owned by a survivor now.
        target = next(f"t{i}" for i in range(10_000) if owner_id(f"smoke_k_t{i}_", ids3) == "r3")
        codes = [holder.should_rate_limit(pb_request(target)).overall_code for _ in range(6)]
        check(checks, "joint_limit", codes == [OK] * 5 + [OVER], f"codes {codes}")

        faults.kill("r2")
        for i in range(10):
            holder.should_rate_limit(pb_request(f"spread{i}"))
        st = holder.stats()
        out["after_kill"] = {k: st[k] for k in ("ejections", "failovers", "live_replicas")}
        check(checks, "killed_replica_ejected", st["ejections"] >= 1, f"ejections {st['ejections']}")
        check(checks, "failover_served_its_keys", st["failovers"] >= 1, f"failovers {st['failovers']}")
        states = {s["id"]: s["state"] for s in st["replica_states"]}
        check(checks, "circuit_states_exposed", states["r1"] == "closed", f"{states}")

        faults.kill("r1")
        for _ in range(4):
            holder.should_rate_limit(pb_request("burn"))
        hot = holder.should_rate_limit(pb_request(target)).overall_code
        cold = holder.should_rate_limit(pb_request("cold-key")).overall_code
        check(checks, "degraded_local_cache", hot == OVER and cold == OK, f"known-over {hot}, cold {cold}")
        st = holder.stats()
        check(
            checks, "degraded_counters",
            st["fallback_descriptors"] >= 2 and st["degraded_denials"] >= 1,
            f"fallback {st['fallback_descriptors']}, denials {st['degraded_denials']}",
        )

        faults.heal()
        holder.swap(make_router(ids3, readmit_after_s=0.5), grace_s=0.5)
        deadline = time.monotonic() + 10.0
        while holder.last_handoff is None and time.monotonic() < deadline:
            time.sleep(0.01)
        summary = holder.last_handoff
        out["handoff"] = summary
        check(checks, "handoff_completed", summary is not None, f"{summary}")
        moved = 0 if summary is None else summary["imported"] + summary["merged"]
        check(checks, "handoff_moved_keys", moved >= 1, f"imported + merged {moved}")
        after = holder.should_rate_limit(pb_request(target)).overall_code
        check(checks, "moved_key_kept_its_window", after == OVER, f"first hit on the new owner {after}")
        snap = replicas["r3"].cache.handoff_log.snapshot()
        check(
            checks, "joiner_handoff_counters",
            snap["imported_keys"] + snap["merged_keys"] >= 1,
            f"imported {snap['imported_keys']}, merged {snap['merged_keys']}",
        )

        r3_key = next(f"r3x{i}" for i in range(10_000) if owner_id(f"smoke_k_r3x{i}_", ids3) == "r3")
        faults.kill("r3")
        for _ in range(4):
            holder.should_rate_limit(pb_request(r3_key))
        faults.heal()
        deadline = time.monotonic() + 10.0
        while (
            not any(e["type"] == "replica_readmit" for e in journal.snapshot())
            and time.monotonic() < deadline
        ):
            time.sleep(0.1)
            holder.should_rate_limit(pb_request(r3_key))
        events = journal.snapshot()
        types = [e["type"] for e in events]
        out["journal"] = types
        order = [
            types.index(t) if t in types else None
            for t in ("replica_eject", "membership_change", "handoff_begin", "handoff_end", "replica_readmit")
        ]
        check(
            checks, "journal_in_order",
            all(i is not None for i in order) and order == sorted(order), f"{types}",
        )
        check(
            checks, "journal_monotone",
            all(a["ts_mono_ns"] <= b["ts_mono_ns"] for a, b in zip(events, events[1:])),
        )

        base = f"http://127.0.0.1:{debug.bound_port}"
        served = json.loads(urllib.request.urlopen(base + "/debug/events", timeout=5).read())
        check(checks, "proxy_debug_events", [e["type"] for e in served["events"]] == types)
        fleet = json.loads(urllib.request.urlopen(base + "/fleet.json", timeout=10).read())
        live = [rid for rid, r in fleet["replicas"].items() if r.get("metrics", {}).get("up")]
        out["fleet_live"] = live
        check(checks, "fleet_two_live_replicas", len(live) >= 2, f"live {live}")
        check(
            checks, "fleet_slo_sections",
            all("domains" in fleet["replicas"][rid]["slo"] for rid in live),
        )
        merged = {e["replica"] for e in fleet["events"]}
        check(
            checks, "fleet_timeline_interleaves",
            "_proxy" in merged and any(rid in merged for rid in ids3), f"{sorted(merged)}",
        )
        out["engine_device"] = str(replicas["r1"].cache.engine.device)
        return out
    finally:
        debug.stop()
        holder.close()
        for r in replicas.values():
            r.stop()


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
    t0 = time.perf_counter()
    result = run(args.device, checks)
    result.update(device=args.device, seconds=time.perf_counter() - t0, checks=checks)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    failed = [c["name"] for c in checks if not c["ok"]]
    if failed:
        print(f"cluster smoke failed: {failed}")
        return 1
    print("cluster smoke: all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
