#!/usr/bin/env python3
"""Phase 8 of chip_smoke.py (the device fault domain), booted again and again.

    python3 scripts/torch_fault_repeat.py [--repo .] [--boots 8]

Builds the kernels of the checkout at `--repo`, then runs that
checkout's `chip_smoke.fault_phase` `--boots` times in one process: each
a fresh runner with BACKEND_TYPE=cuda and every fault-domain default,
a stall episode on the fixed-window bank and one on the GCRA bank.  A
phase that fails prints its reason (chip_smoke's FAIL line) and the
next boot goes on.  Prints one line per boot, then one JSON object:
boots, passes, each boot's seconds, the card's name and power limit.
Exits 1 unless every boot passed.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=".", help="checkout whose chip_smoke.py and port to run")
    ap.add_argument("--boots", type=int, default=8)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    import chip_smoke
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import fixed_window, gcra

    torch.cuda.set_device(0)
    kernels.build_all()
    seconds, passed = [], 0
    for boot in range(args.boots):
        t0 = time.perf_counter()
        try:
            chip_smoke.fault_phase(torch, kernels, fixed_window, gcra)
            passed += 1
            outcome = "pass"
        except SystemExit as e:
            outcome = f"exit {e.code}"
        seconds.append(round(time.perf_counter() - t0, 2))
        print(f"boot {boot}: {outcome} in {seconds[-1]} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    print(json.dumps(dict(repo=repo, boots=args.boots, passed=passed, seconds=seconds, card=smi)))
    sys.exit(0 if passed == args.boots else 1)


if __name__ == "__main__":
    main()
