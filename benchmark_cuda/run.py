#!/usr/bin/env python3
"""Run one benchmark cell once on the card and print its result.

    python3 benchmark_cuda/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (engine, tables, traffic, the first
launch of every shape the cell uses, and in a fresh checkout the kernels'
nvcc build) counts as ``setup_s``; the window then runs for --seconds;
the reference judges what it produced.  The last line of standard output
is one JSON object (correct, attempted, failed, metrics, device, and with
--trace 1 the per-layer metrics and a breakdown; the compared numbers
last, under ``checks``); the same numbers close standard error.
``--control 1`` also judges the reference's control in the program's
place (the benchmark's own runs never ask for it).

Exits non-zero, with no result, without a CUDA card, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path[:0] = [HERE, ROOT]
    import harness

    started = harness.process_start()
    # Build and kernel caches live at fixed paths inside the checkout.
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"

    import torch

    cell = harness.Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        control=bool(args.control), started=started,
    )
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result.get("control", {}).items():
        print(f"control {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
