#!/usr/bin/env python3
"""Where a served request's time goes in ratelimit_tpu_torch, by layer.

    python3 scripts/torch_served_latency.py [--device cuda|cpu] [--n 400]

Times one closed-loop client, warm, at three depths of the main path,
each on the same one-descriptor requests:

- engine:  CounterEngine.submit_packed + step_complete (slot table,
           K1 by value with its readback in pinned memory, host decide);
- cache:   CudaRateLimitCache.do_limit_resolved through the dispatcher
           threads (adds the collector/completer hand-offs);
- grpc:    a ShouldRateLimit round trip to an in-process runner (adds
           the service, protobuf and gRPC).

It also times K1 alone at the served bucket (8 lanes): CUDA events
around back-to-back wrapper calls (host enqueue included) and, where
torch.profiler sees the kernel, its device time.  Prints one JSON
object with every number, the card's name and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIG = """domain: rl
descriptors:
  - key: foo
    rate_limit:
      unit: hour
      requests_per_unit: 1000000
"""


def _us(fn, n):
    for _ in range(50):
        fn(0)
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n * 1e6


def engine_us(device, n):
    from ratelimit_tpu_torch.backends.dispatcher import Lane, LanePack
    from ratelimit_tpu_torch.backends.engine import CounterEngine

    eng = CounterEngine(device=device)
    packs = [
        LanePack.from_lanes([Lane(f"rl_foo_k{i}_0", 3600, 1_000_000, False, 1)])
        for i in range(64)
    ]

    def step(i):
        p = packs[i % 64]
        eng.step_complete(eng.submit_packed(1, p.key_blob, p.meta))

    return _us(step, n)


def cache_and_grpc_us(device, n, kernel_deadline_s=0.0):
    """(cache, grpc) µs per request through a runner whose fault domain
    is off (KERNEL_DEADLINE_S=0) or armed at `kernel_deadline_s`; an
    armed domain that acted during the run raises, since its answers
    would not be the kernel's."""
    import grpc

    from ratelimit_tpu_torch.api import Descriptor, Entry, RateLimitRequest
    from ratelimit_tpu_torch.runner import Runner
    from ratelimit_tpu_torch.server import pb  # noqa: F401
    from ratelimit_tpu_torch.settings import Settings

    from envoy.service.ratelimit.v3 import rls_pb2

    with tempfile.TemporaryDirectory() as root:
        cfg = os.path.join(root, "ratelimit", "config")
        os.makedirs(cfg)
        with open(os.path.join(cfg, "rl.yaml"), "w") as f:
            f.write(CONFIG)
        runner = Runner(
            Settings(
                host="127.0.0.1",
                port=0,
                grpc_host="127.0.0.1",
                grpc_port=0,
                debug_host="127.0.0.1",
                debug_port=0,
                use_statsd=False,
                runtime_path=root,
                runtime_subdirectory="ratelimit",
                tpu_algorithm_banks="",
                kernel_deadline_s=kernel_deadline_s,
            ),
            device=device,
        )
        runner.start()
        try:
            config = runner.service.get_current_config()
            reqs = [
                RateLimitRequest(
                    domain="rl",
                    descriptors=[Descriptor(entries=(Entry("foo", f"c{i}"),))],
                    hits_addend=1,
                )
                for i in range(64)
            ]
            cache = _us(
                lambda i: runner.cache.do_limit_resolved(reqs[i % 64], config), n
            )
            channel = grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            )
            call = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )
            pbs = []
            for i in range(64):
                r = rls_pb2.RateLimitRequest(domain="rl", hits_addend=1)
                e = r.descriptors.add().entries.add()
                e.key, e.value = "foo", f"g{i}"
                pbs.append(r)
            rpc = _us(lambda i: call(pbs[i % 64], timeout=30), n)
            channel.close()
            fd = runner.cache.fault_domain
            if fd is not None:
                summary = fd.summary()
                if any(summary["faults"].values()) or summary["fallback_decisions"]:
                    raise RuntimeError(f"the fault domain acted during the run: {summary}")
        finally:
            runner.stop()
    return cache, rpc


def k1_us(n_lanes=8):
    import torch

    from ratelimit_tpu_torch.models import fixed_window as fw

    dev = torch.device("cuda", 0)
    counts = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    pk = torch.zeros((4, n_lanes), dtype=torch.int32, device=dev)
    pk[0] = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    pk[1] = 1
    pk[2] = 100
    for _ in range(20):
        fw.fw_unique_step(counts, pk, "uint8")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 2000
    start.record()
    for _ in range(reps):
        fw.fw_unique_step(counts, pk, "uint8")
    end.record()
    end.synchronize()
    events_us = start.elapsed_time(end) / reps * 1e3
    device_us = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                fw.fw_unique_step(counts, pk, "uint8")
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "fw_unique_step" in ev.key and ev.count >= 200:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = ev.cuda_time_total
                if total:
                    device_us = total / ev.count
    except Exception as exc:  # noqa: BLE001 -- profiler support varies
        device_us = f"profiler failed: {exc!r}"
    return events_us, device_us


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=400)
    args = ap.parse_args()
    out = {"device": args.device}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("CUDA is not available")
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        ).stdout.strip()
        out["k1_events_us_8_lanes"], out["k1_device_us_8_lanes"] = k1_us()
    out["engine_us_per_request"] = engine_us(args.device, args.n)
    out["cache_us_per_request"], out["grpc_us_per_request"] = cache_and_grpc_us(
        args.device, args.n
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
