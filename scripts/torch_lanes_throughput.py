#!/usr/bin/env python3
"""Decisions per second and RPC latency over gRPC against 1, 2 and 4 host
lanes (TPU_NUM_LANES).

    python3 scripts/torch_lanes_throughput.py [--rounds 10] [--seconds 3]
        [--procs 2] [--threads 8] [--lanes 1,2,4] [--device cuda|cpu]

The twin of benchmarks/profile_lanes.py over the wire.  Each leg boots
the port's Runner with TPU_NUM_LANES set and every other setting at its
default (2^20 slots split over the lanes, the algorithm banks, the fault
domain armed), then drives it for `--seconds` with closed-loop clients
in processes of their own (`--procs` processes of `--threads` threads, a
gRPC channel each; one-descriptor requests on a fixed-window rule over
4096 keys, so every lane serves), so the server's interpreter is not
shared with its clients.  Each round runs every lane count once, the
order reversed from round to round.  A leg in which the fault domain
acted fails the run.  Prints one JSON object: every leg's decisions/s,
p50 and p99 RPC ms, per lane count the median and interquartile spread
of each, the rounds in which each lane count beat one lane, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """domain: rl
descriptors:
  - key: lanes
    rate_limit:
      unit: hour
      requests_per_unit: 1000000000
"""
KEYS = 4096

sys.path.insert(0, REPO)


def client_main() -> None:
    """One client process: argv port, seconds, threads; prints JSON with
    the answers and the RPC latencies of the measured window."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    port, seconds, threads, seed = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    OK = rls_pb2.RateLimitResponse.OK
    start = time.perf_counter() + 0.5  # every thread connected and warm
    end = start + seconds
    lat = [[] for _ in range(threads)]
    bad = []

    def worker(t):
        rng = np.random.default_rng(seed * 1000 + t)
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            call = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )
            reqs = []
            for k in rng.permutation(KEYS):
                r = rls_pb2.RateLimitRequest(domain="rl", hits_addend=1)
                e = r.descriptors.add().entries.add()
                e.key, e.value = "lanes", f"k{k}"
                reqs.append(r)
            i = 0
            while True:
                t0 = time.perf_counter()
                if t0 >= end:
                    return
                code = call(reqs[i % KEYS], timeout=30).overall_code
                t1 = time.perf_counter()
                if code != OK:
                    bad.append(code)
                if t0 >= start:
                    lat[t].append(t1 - t0)
                i += 1

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    print(json.dumps({"lat_ms": [x * 1e3 for v in lat for x in v], "bad": len(bad)}))


def leg(device, lanes, seconds, procs, threads, seed) -> dict:
    """Boot a runner of `lanes` lanes, drive it, return the leg's numbers."""
    from ratelimit_tpu_torch.runner import Runner
    from ratelimit_tpu_torch.settings import new_settings

    with tempfile.TemporaryDirectory() as root:
        cfg = os.path.join(root, "ratelimit", "config")
        os.makedirs(cfg)
        with open(os.path.join(cfg, "rl.yaml"), "w") as f:
            f.write(CONFIG)
        env = dict(
            RUNTIME_ROOT=root, RUNTIME_SUBDIRECTORY="ratelimit", HOST="127.0.0.1",
            PORT="0", GRPC_HOST="127.0.0.1", GRPC_PORT="0", DEBUG_HOST="127.0.0.1",
            DEBUG_PORT="0", USE_STATSD="false", TPU_NUM_LANES=str(lanes),
        )
        if device == "cpu":
            env.update(TPU_NUM_SLOTS=str(1 << 14), TPU_ALGORITHM_NUM_SLOTS=str(1 << 12))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            runner = Runner(new_settings(), device=device)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        runner.start()
        try:
            port = runner.grpc_server.bound_port
            clients = [
                subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--client", str(port),
                     str(seconds), str(threads), str(seed * 100 + p)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                )
                for p in range(procs)
            ]
            lat, bad = [], 0
            for c in clients:
                out, err = c.communicate(timeout=seconds + 120)
                if c.returncode != 0:
                    raise RuntimeError(f"a client process exited {c.returncode}: {err[-500:]}")
                got = json.loads(out.strip().splitlines()[-1])
                lat += got["lat_ms"]
                bad += got["bad"]
            fd = runner.cache.fault_domain
            summary = fd.summary() if fd is not None else None
            if bad or (summary and (any(summary["faults"].values()) or summary["fallback_decisions"])):
                raise RuntimeError(f"{lanes} lanes: {bad} refused answers, fault domain {summary}")
            launches = [
                runner.cache._dispatchers[id(e)].completed_launches for e in runner.cache.lanes
            ]
        finally:
            runner.stop()
    p50, p99 = np.percentile(lat, (50, 99))
    return dict(
        lanes=lanes,
        decisions_per_s=len(lat) / seconds,
        p50_ms=float(p50),
        p99_ms=float(p99),
        rpcs=len(lat),
        launches_by_lane=launches,
    )


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--client":
        sys.argv = sys.argv[1:]
        client_main()
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--lanes", default="1,2,4")
    args = ap.parse_args()
    counts = [int(x) for x in args.lanes.split(",")]
    out = {k: getattr(args, k) for k in ("device", "rounds", "seconds", "procs", "threads")}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("CUDA is not available")
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    legs = []
    for r in range(args.rounds):
        for lanes in counts if r % 2 == 0 else counts[::-1]:
            legs.append(dict(round=r, **leg(args.device, lanes, args.seconds, args.procs,
                                            args.threads, r * 10 + lanes)))
    out["legs"] = legs
    for lanes in counts:
        mine = [g for g in legs if g["lanes"] == lanes]
        for metric in ("decisions_per_s", "p50_ms", "p99_ms"):
            q1, med, q3 = np.percentile([g[metric] for g in mine], (25, 50, 75))
            out[f"{lanes}_lanes_{metric}_median"] = float(med)
            out[f"{lanes}_lanes_{metric}_iqr"] = float(q3 - q1)
        one = {g["round"]: g["decisions_per_s"] for g in legs if g["lanes"] == counts[0]}
        out[f"{lanes}_lanes_rounds_above_{counts[0]}"] = sum(
            g["decisions_per_s"] > one[g["round"]] for g in mine
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
