#!/usr/bin/env python3
"""The served chunk of one checkout's CUDA engine, on the card.

    python3 scripts/torch_served_chunk.py [--repo PATH] [--label NAME]
                                          [--wide] [--chunks N]
    python3 scripts/torch_served_chunk.py --pairs 10 --parent PATH [--wide]

Imports ``ratelimit_tpu_torch`` from the checkout at PATH (default: the
one this script lives in), builds its kernels, and drives its engines'
``_device_submit`` + ``step_complete`` through ``served_chunks`` of this
checkout's ``chip_smoke.py``: one chunk of 1, 8, 13, 256, 1024 and 4096
distinct lanes on one table and on 8 banks of 2^20 slots, and on a
sliding-window and a GCRA table of 2^18 slots (``--wide``: the chunks
past 128 lanes alone), SERVED_CHUNKS (or N) times under
torch.profiler and as many again without it.  Prints, per engine and
width, the device activities and memcpys per chunk, the device busy
time and the span from the first start to the last end (profiled), and
the host microseconds of submit + complete (unprofiled); then the
card's name and power limit, and one JSON line with every number.

With ``--pairs K --parent PATH`` it runs K alternating pairs of legs,
each leg a process of its own (PATH's engines, then this checkout's;
the next pair the other way round), and prints for every cell each
side's median host microseconds, this checkout's minus the parent's in
every pair (median, min, max, and in how many pairs this checkout was
lower), and each side's activities, memcpys and busy time.

To compare two commits on one card, unpack the other into a gitignored
directory and run the two in turns in one call::

    git archive <commit> | tar -x -C _smoke_checkout/parent
    for r in _smoke_checkout/parent . . _smoke_checkout/parent; do
        python3 scripts/torch_served_chunk.py --repo $r --label $r; done

The other checkout's engines serve in whatever forms it has: one that
predates the algorithm kernels' by-value or mapped form serves those
algorithm chunks in the device form (upload, kernel, readback copy).
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


def _leg(repo, wide, chunks):
    """One leg in a process of its own: its cells from the last line."""
    cmd = [sys.executable, os.path.abspath(__file__), "--repo", repo, "--label", repo]
    cmd += (["--wide"] if wide else []) + (["--chunks", str(chunks)] if chunks else [])
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if done.returncode:
        sys.exit(f"leg {repo} failed ({done.returncode}):\n{done.stdout[-2000:]}{done.stderr[-2000:]}")
    return {(c["engine"], c["lanes"]): c for c in json.loads(done.stdout.splitlines()[-1])["cells"]}


def pairs(args) -> None:
    """--pairs: alternating legs of the parent and this checkout."""
    parent = os.path.abspath(args.parent)
    legs = {"parent": [], "this": []}
    for i in range(args.pairs):
        order = ("parent", "this") if i % 2 == 0 else ("this", "parent")
        for side in order:
            legs[side].append(_leg(parent if side == "parent" else HERE, args.wide, args.chunks))
        print(f"pair {i + 1} of {args.pairs} done ({' then '.join(order)})", flush=True)
    cells = []
    for key in legs["this"][0]:
        host = {side: [leg[key]["host_us"][1] for leg in legs[side]] for side in legs}
        diffs = [t - p for t, p in zip(host["this"], host["parent"])]
        cell = dict(engine=key[0], lanes=key[1], host_us={s: v for s, v in host.items()},
                    diff_us=dict(median=float(np.median(diffs)), min=min(diffs), max=max(diffs),
                                 lower=sum(d < 0 for d in diffs), pairs=len(diffs)))
        for side in legs:
            cell[side] = {k: float(np.median([leg[key][k] for leg in legs[side]]))
                          for k in ("activities", "memcpys", "busy_us")}
            cell[side]["span_us"] = float(np.median([leg[key]["span_us"][1] for leg in legs[side]]))
        print(f"{key[0]}, {key[1]} lanes: host us (median of each leg's median) parent "
              f"{np.median(host['parent']):.1f}, this {np.median(host['this']):.1f}; this minus "
              f"parent median {cell['diff_us']['median']:+.1f} (min {min(diffs):+.1f}, max "
              f"{max(diffs):+.1f}), this lower in {cell['diff_us']['lower']} of {len(diffs)}; "
              f"activities {cell['parent']['activities']:.0f} -> {cell['this']['activities']:.0f}, "
              f"memcpys {cell['parent']['memcpys']:.0f} -> {cell['this']['memcpys']:.0f}, busy "
              f"{cell['parent']['busy_us']:.2f} -> {cell['this']['busy_us']:.2f} us, span "
              f"{cell['parent']['span_us']:.2f} -> {cell['this']['span_us']:.2f} us", flush=True)
        cells.append(cell)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"parent": parent, "card": smi, "pairs": args.pairs, "cells": cells}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose engine runs")
    ap.add_argument("--label", default=None, help="name of the run in the output")
    ap.add_argument("--wide", action="store_true", help="the cells past 128 lanes alone")
    ap.add_argument("--chunks", type=int, default=None, help="chunks a pass in each cell")
    ap.add_argument("--pairs", type=int, default=0, help="alternating legs against --parent")
    ap.add_argument("--parent", default=None, help="the other checkout of --pairs")
    args = ap.parse_args()
    if args.pairs:
        if not args.parent:
            sys.exit("--pairs needs --parent")
        return pairs(args)
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
    wanted = [cell for cell in smoke.served_cells() if cell[1] in smoke.WIDE_SERVED_WIDTHS]
    run = smoke.served_chunks(torch, sh, eng, sw, gcra, dev, n=args.chunks or smoke.SERVED_CHUNKS,
                              cells=wanted if args.wide else None)
    for (engine, width), st in run.items():
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
