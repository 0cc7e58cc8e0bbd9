#!/usr/bin/env python3
"""The served chunk of one checkout's CUDA engine, on the card.

    python3 scripts/torch_served_chunk.py [--repo PATH] [--label NAME]

Imports ``ratelimit_tpu_torch`` from the checkout at PATH (default: the
one this script lives in), builds its kernels, and drives its engines'
``_device_submit`` + ``step_complete`` through ``served_chunks`` of this
checkout's ``chip_smoke.py``: one chunk of 1, 8 and 13 distinct lanes on
one table and on 8 banks of 2^20 slots, and on a sliding-window and a
GCRA table of 2^18 slots, SERVED_CHUNKS times under torch.profiler and
as many again without it.  Prints, per engine and
width, the device activities and memcpys per chunk, the device busy
time and the span from the first start to the last end (profiled), and
the host microseconds of submit + complete (unprofiled); then the
card's name and power limit, and one JSON line with every number.

To compare two commits on one card, unpack the other into a gitignored
directory and run the two in turns in one call::

    git archive <commit> | tar -x -C _smoke_checkout/parent
    for r in _smoke_checkout/parent . . _smoke_checkout/parent; do
        python3 scripts/torch_served_chunk.py --repo $r --label $r; done

The other checkout's engines serve in whatever forms it has: one that
predates the algorithm kernels' by-value form serves every algorithm
chunk in the device form.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py as a module, whatever is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose engine runs")
    ap.add_argument("--label", default=None, help="name of the run in the output")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    smoke = _chip_smoke()
    sys.path.insert(0, repo)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.backends import engine as eng
    from ratelimit_tpu_torch.models import gcra
    from ratelimit_tpu_torch.models import sliding_window as sw
    from ratelimit_tpu_torch.parallel import sharded as sh

    if not os.path.abspath(kernels.__file__).startswith(repo + os.sep):
        sys.exit(f"ratelimit_tpu_torch came from {kernels.__file__}, not from {repo}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.build_all(["fixed_window", "sharded", "algorithms"])

    label = args.label or repo
    cells = []
    for (engine, width), st in smoke.served_chunks(torch, sh, eng, sw, gcra, dev).items():
        print(f"{label}: {smoke.served_chunk_line(engine, width, st)}", flush=True)
        cells.append(
            dict(
                engine=engine,
                lanes=width,
                activities=int(np.median(st["activities"])),
                memcpys=int(np.median(st["memcpys"])),
                busy_us=float(np.median(st["busy_us"])),
                span_us=[float(q) for q in np.percentile(st["span_us"], (0, 50, 100))],
                host_us=[float(q) for q in np.percentile(st["host_us"], (0, 50, 100))],
                chunks=len(st["host_us"]),
            )
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"label": label, "card": smi, "cells": cells}))


if __name__ == "__main__":
    main()
