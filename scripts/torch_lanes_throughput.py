#!/usr/bin/env python3
"""Decisions per second and RPC latency over gRPC against 1, 2 and 4 host
lanes (TPU_NUM_LANES), and against the backends (BACKEND_TYPE).

    python3 scripts/torch_lanes_throughput.py [--rounds 10] [--seconds 3]
        [--procs 2] [--threads 8] [--lanes 1,2,4] [--device cuda|cpu]
        [--backend cuda,cuda-write-behind,memory] [--warm-pairs 10]

The twin of benchmarks/profile_lanes.py over the wire.  Each leg boots
the port's Runner with BACKEND_TYPE and TPU_NUM_LANES set and every
other setting at its default (2^20 slots split over the lanes, the
algorithm banks, the fault domain armed -- for ``cuda``; one bank of
2^20 slots for the write-behind backends; no table for ``memory``),
warms its kernel shapes before any client, then drives it for `--seconds` with closed-loop clients in processes of their
own (`--procs` processes of `--threads` threads, a gRPC channel each;
one-descriptor requests on a fixed-window rule over 4096 keys, so every
lane serves), so the server's interpreter is not shared with its
clients.  Each round runs every (backend, lane count) leg once, the
order reversed from round to round.  A leg in which the fault domain
acted, or whose counters after a flush differ from the hits the clients
sent, fails the run.  Prints one JSON object: every leg's decisions/s,
p50 and p99 RPC ms, per leg kind the median and interquartile spread of
each, the rounds in which each kind beat the first, and the card's name
and power limit.

With ``--warm-pairs N`` it instead boots one runner of each backend side
by side and times one in-process client's warm microseconds per request
on each, in N alternating pairs of legs (the backends' order reversed
from pair to pair): the median, interquartile spread and the pairs in
which each backend beat the first.
"""

from __future__ import annotations

import argparse
import contextlib
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
    the RPC latencies of the measured window, the refused answers and
    every request sent (warm ones included)."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    port, seconds, threads, seed = int(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    OK = rls_pb2.RateLimitResponse.OK
    start = time.perf_counter() + 0.5  # every thread connected and warm
    end = start + seconds
    lat = [[] for _ in range(threads)]
    bad = []
    sent = [0] * threads

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
                sent[t] += 1
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
    print(json.dumps({"lat_ms": [x * 1e3 for v in lat for x in v], "bad": len(bad),
                      "sent": sum(sent)}))


def boot(root, device, backend, lanes):
    """A started Runner of `backend` with `lanes` lanes serving CONFIG
    from `root`, every other setting at its default."""
    from ratelimit_tpu_torch.runner import Runner
    from ratelimit_tpu_torch.settings import new_settings

    cfg = os.path.join(root, "ratelimit", "config")
    os.makedirs(cfg)
    with open(os.path.join(cfg, "rl.yaml"), "w") as f:
        f.write(CONFIG)
    env = dict(
        RUNTIME_ROOT=root, RUNTIME_SUBDIRECTORY="ratelimit", HOST="127.0.0.1",
        PORT="0", GRPC_HOST="127.0.0.1", GRPC_PORT="0", DEBUG_HOST="127.0.0.1",
        DEBUG_PORT="0", USE_STATSD="false", TPU_NUM_LANES=str(lanes), BACKEND_TYPE=backend,
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
    if hasattr(runner.cache, "warmup"):
        # Every kernel shape once before any client: a fresh checkout's
        # first launch builds the kernels with nvcc, which would eat the
        # first leg's window.
        runner.cache.warmup()
    return runner


def counted(cache) -> int:
    """Every hit the backend holds, after a flush: the sum of its tables
    (the lanes and the per-second bank), or of memory's window counters."""
    cache.flush()
    if not hasattr(cache, "engines"):
        return sum(count for count, _expiry in cache._counters.values())
    return sum(int(e.export_counts().sum()) for e in cache.engines()[: len(getattr(
        cache, "lanes", [cache.engine]))])


def launches_of(cache) -> list:
    """Completed device launches by bank (lanes, or the write-behind
    bank); none for memory."""
    if hasattr(cache, "_dispatcher"):
        return [cache._dispatcher.completed_launches]
    if hasattr(cache, "lanes"):
        return [cache._dispatchers[id(e)].completed_launches for e in cache.lanes]
    return []


def leg(device, backend, lanes, seconds, procs, threads, seed) -> dict:
    """Boot a runner of `backend` with `lanes` lanes, drive it, return
    the leg's numbers."""
    with tempfile.TemporaryDirectory() as root:
        runner = boot(root, device, backend, lanes)
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
            lat, bad, sent = [], 0, 0
            for c in clients:
                out, err = c.communicate(timeout=seconds + 120)
                if c.returncode != 0:
                    raise RuntimeError(f"a client process exited {c.returncode}: {err[-500:]}")
                got = json.loads(out.strip().splitlines()[-1])
                lat += got["lat_ms"]
                bad += got["bad"]
                sent += got["sent"]
            fd = getattr(runner.cache, "fault_domain", None)
            summary = fd.summary() if fd is not None else None
            if bad or (summary and (any(summary["faults"].values()) or summary["fallback_decisions"])):
                raise RuntimeError(f"{backend}/{lanes}: {bad} refused answers, fault domain {summary}")
            held = counted(runner.cache)
            if held != sent:
                raise RuntimeError(f"{backend}/{lanes}: {sent} hits sent, {held} counted")
            launches = launches_of(runner.cache)
        finally:
            runner.stop()
    if not lat:
        raise RuntimeError(f"{backend}/{lanes}: no RPC inside the measured window")
    p50, p99 = np.percentile(lat, (50, 99))
    return dict(
        backend=backend,
        lanes=lanes,
        decisions_per_s=len(lat) / seconds,
        p50_ms=float(p50),
        p99_ms=float(p99),
        rpcs=len(lat),
        launches_by_lane=launches,
    )


def label(backend, lanes, backends) -> str:
    """A leg kind's name in the summary: "1_lanes" with one backend (the
    keys of earlier runs), "<backend>_1_lanes" with several."""
    return f"{lanes}_lanes" if len(backends) == 1 else f"{backend}_{lanes}_lanes"


def spread(values) -> dict:
    q1, med, q3 = np.percentile(values, (25, 50, 75))
    return dict(median=float(med), iqr=float(q3 - q1))


def warm_pairs(device, backends, pairs, n=400) -> dict:
    """One runner of each backend side by side; per pair, a leg of `n`
    warm one-descriptor requests from one in-process client on each (a
    fresh key every 50), the order reversed from pair to pair."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    with contextlib.ExitStack() as stack:
        calls = {}
        for backend in backends:
            root = stack.enter_context(tempfile.TemporaryDirectory())
            runner = boot(root, device, backend, 1)
            stack.callback(runner.stop)
            channel = stack.enter_context(
                grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}")
            )
            calls[backend] = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )

        def leg_us(call, tag):
            reqs = []
            for i in range(n):
                r = rls_pb2.RateLimitRequest(domain="rl", hits_addend=1)
                e = r.descriptors.add().entries.add()
                e.key, e.value = "lanes", f"{tag}-{i // 50}"
                reqs.append(r)
            for r in reqs[:50]:
                call(r, timeout=30)  # warm
            t0 = time.perf_counter()
            for r in reqs:
                if call(r, timeout=30).overall_code != rls_pb2.RateLimitResponse.OK:
                    raise RuntimeError(f"{tag}: a warm request was refused")
            return (time.perf_counter() - t0) / n * 1e6

        us = {b: [] for b in backends}
        for p in range(pairs):
            for b in backends if p % 2 == 0 else backends[::-1]:
                us[b].append(leg_us(calls[b], f"{b}-{p}"))
    out = {"warm_us": us}
    for b in backends:
        out[f"{b}_warm_us"] = spread(us[b])
        out[f"{b}_pairs_below_{backends[0]}"] = sum(
            x < y for x, y in zip(us[b], us[backends[0]])
        )
    return out


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
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--warm-pairs", type=int, default=0)
    args = ap.parse_args()
    counts = [int(x) for x in args.lanes.split(",")]
    backends = args.backend.split(",")
    out = {k: getattr(args, k) for k in ("device", "rounds", "seconds", "procs", "threads",
                                          "backend")}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("CUDA is not available")
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    if args.warm_pairs:
        out.update(warm_pairs(args.device, backends, args.warm_pairs))
        print(json.dumps(out))
        return
    kinds = [(b, lanes) for b in backends for lanes in counts]
    legs = []
    for r in range(args.rounds):
        for i, (backend, lanes) in enumerate(kinds if r % 2 == 0 else kinds[::-1]):
            legs.append(dict(round=r, **leg(args.device, backend, lanes, args.seconds,
                                            args.procs, args.threads, r * 10 + i)))
    out["legs"] = legs
    first = label(*kinds[0], backends)
    for backend, lanes in kinds:
        name = label(backend, lanes, backends)
        mine = [g for g in legs if (g["backend"], g["lanes"]) == (backend, lanes)]
        for metric in ("decisions_per_s", "p50_ms", "p99_ms"):
            got = spread([g[metric] for g in mine])
            out[f"{name}_{metric}_median"] = got["median"]
            out[f"{name}_{metric}_iqr"] = got["iqr"]
        one = {g["round"]: g["decisions_per_s"] for g in legs
               if (g["backend"], g["lanes"]) == kinds[0]}
        out[f"{name}_rounds_above_{first}"] = sum(
            g["decisions_per_s"] > one[g["round"]] for g in mine
        )
    print(json.dumps(out))



if __name__ == "__main__":
    main()
