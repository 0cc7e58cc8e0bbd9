#!/usr/bin/env python3
"""What the armed device fault domain costs a served request.

    python3 scripts/torch_fault_cost.py [--pairs 10] [--n 400] [--device cuda|cpu]

Runs the cache and gRPC depths of scripts/torch_served_latency.py (one
closed-loop client, warm, one-descriptor fixed-window requests, a fresh
runner each leg) with KERNEL_DEADLINE_S at 0, which builds no fault
domain, and at 0.25, the default, which arms it: `--pairs` pairs in one
process, the side that goes first alternating from pair to pair.  An
armed leg in which the domain acted (a fault or a fallback answer)
fails the run.  Prints one JSON object: every leg's µs per request at
both depths, per depth the pairs in which the armed side was faster,
each side's median and interquartile spread, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_served_latency import cache_and_grpc_us  # noqa: E402

ARMED_S = 0.25  # the runner's default KERNEL_DEADLINE_S


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--n", type=int, default=400)
    args = ap.parse_args()
    out = {"device": args.device, "pairs": args.pairs, "n": args.n}
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
    legs = []
    faster = {"cache": 0, "grpc": 0}
    for pair in range(args.pairs):
        order = (0.0, ARMED_S) if pair % 2 == 0 else (ARMED_S, 0.0)
        got = {}
        for deadline in order:
            cache, rpc = cache_and_grpc_us(args.device, args.n, deadline)
            got[deadline] = (cache, rpc)
            legs.append(dict(pair=pair, kernel_deadline_s=deadline, cache_us=cache, grpc_us=rpc))
        for depth, i in (("cache", 0), ("grpc", 1)):
            faster[depth] += got[ARMED_S][i] < got[0.0][i]
    out["pairs_armed_faster"] = faster
    out["legs"] = legs
    for depth in ("cache", "grpc"):
        for name, deadline in (("off", 0.0), ("armed", ARMED_S)):
            v = [leg[f"{depth}_us"] for leg in legs if leg["kernel_deadline_s"] == deadline]
            q1, med, q3 = np.percentile(v, (25, 50, 75))
            out[f"{depth}_{name}_median_us"] = float(med)
            out[f"{depth}_{name}_iqr_us"] = float(q3 - q1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
