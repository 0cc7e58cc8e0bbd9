#!/usr/bin/env python3
"""Does the size of a by-value parameter struct change a launch's time?

    python3 scripts/torch_lane_batch.py [--lanes 8] [--calls 50]

Every by-value struct (K1/K6's ``LaneBatch``, K4/K5's ``AlgoLanes``,
``csrc/by_value.cuh``) is built at ``kMaxLanes`` records whatever the
chunk's width: 2 KB of records for K1 at 128 lanes where a chunk of 8
lanes needs 128 B.  This script builds two copies of this checkout's
``csrc/`` under ``ratelimit_tpu_torch/_build/lane_batch/`` (listed in
``.gitignore``): one as it is, one with ``kMaxLanes`` patched to
``--lanes``, so that its structs hold exactly the chunk's records.  It
loads each copy's ``fixed_window`` and ``algorithms`` libraries and
times K1, K4 and K5 by value at ``--lanes`` lanes with each, in the
turns small, full, full, small, small, full: per leg the profiler's
device time per call (min / median / max over ``--calls`` calls), and
without the profiler the host microseconds of the launcher call and of
launch + event record + event wait (medians), beside the launch floor
(a one-element torch add).  Then the card's name and power limit, and
one JSON line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SLOTS = 1 << 20
NOW = 1_699_999_200


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(kernels, max_lanes) -> dict:
    """Copy csrc/ (kMaxLanes patched to `max_lanes`, or as it is for
    None), build its fixed_window and algorithms libraries with the
    package's nvcc flags, and return {library: ctypes.CDLL}."""
    label = "as_is" if max_lanes is None else f"kmax{max_lanes}"
    root = os.path.join(kernels.BUILD_DIR, "lane_batch", label)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, root)
    if max_lanes is not None:
        path = os.path.join(root, "by_value.cuh")
        with open(path) as f:
            src = f.read()
        src, n = re.subn(
            r"constexpr int kMaxLanes = \d+;", f"constexpr int kMaxLanes = {max_lanes};", src
        )
        if n != 1:
            sys.exit("by_value.cuh has no kMaxLanes to patch")
        with open(path, "w") as f:
            f.write(src)
    nvcc = kernels.find_nvcc()
    procs = {}
    for lib in ("fixed_window", "algorithms"):
        so = os.path.join(root, f"lib{lib}.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", so, os.path.join(root, kernels.SOURCES[lib])]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for lib, (proc, so) in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {label}/{lib}:\n{out}")
        libs[lib] = ctypes.CDLL(so)
    for fn, (lib, argtypes) in kernels.SIGNATURES.items():
        if lib in libs:
            f = getattr(libs[lib], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=8, help="chunk width, and the small struct's size")
    ap.add_argument("--calls", type=int, default=50, help="calls per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    smoke = _chip_smoke()
    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = args.lanes
    variants = {f"kMaxLanes={n}": build_variant(kernels, n), "as built": build_variant(kernels, None)}

    rng = np.random.default_rng(3)
    slots = rng.choice(NUM_SLOTS, n, replace=False).astype(np.int32)
    words4 = np.stack([slots, rng.integers(1, 9, n), np.full(n, 100), np.zeros(n)]).astype(np.int32)
    words5 = np.concatenate([words4, np.full((1, n), 60, np.int32)])
    w4 = torch.from_numpy(words4).pin_memory()
    w5 = torch.from_numpy(words5).pin_memory()
    counts = torch.zeros(NUM_SLOTS, dtype=torch.int32, device=dev)
    sw_state = torch.zeros((3, NUM_SLOTS), dtype=torch.int32, device=dev)
    gcra_state = torch.zeros((2, NUM_SLOTS), dtype=torch.int32, device=dev)
    out = torch.zeros(2 * n, dtype=torch.int32, pin_memory=True)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def calls(libs):
        fw, algo = libs["fixed_window"], libs["algorithms"]
        return {
            "K1 by value": lambda: fw.rl_fw_unique_step_lanes(
                counts.data_ptr(), NUM_SLOTS, w4.data_ptr(), n, out.data_ptr(), 0, stream),
            "K4 by value": lambda: algo.rl_sw_serve_step_lanes(
                sw_state.data_ptr(), NUM_SLOTS, w5.data_ptr(), n, NOW, out.data_ptr(), stream),
            "K5 by value": lambda: algo.rl_gcra_serve_step_lanes(
                gcra_state.data_ptr(), NUM_SLOTS, w5.data_ptr(), n, NOW, out.data_ptr(), stream),
        }

    def host_us(fn):
        """Median host microseconds of the launcher call alone, and of
        the round trip launch + event record + event wait (what a served
        chunk's host waits for), over `calls` calls each."""
        ev = torch.cuda.Event()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        call, trip = [], []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            rc = fn()
            t1 = time.perf_counter()
            ev.record()
            ev.synchronize()
            trip.append((time.perf_counter() - t0) * 1e6)
            call.append((t1 - t0) * 1e6)
            if rc != 0:
                sys.exit(f"launch failed with CUDA error {rc}")
        return float(np.median(call)), float(np.median(trip))

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = smoke.device_samples(lambda: one.add_(1), iters=args.calls)
    legs = []
    small = f"kMaxLanes={n}"
    for name in (small, "as built", "as built", small, small, "as built"):
        leg = {"variant": name}
        for kernel, fn in calls(variants[name]).items():
            samples = smoke.device_samples(fn, iters=args.calls)
            call_us, trip_us = host_us(fn)
            leg[kernel] = dict(
                device_us=None if samples is None
                else [float(q) * 1e3 for q in np.percentile(samples, (0, 50, 100))],
                host_us=call_us,
                round_trip_us=trip_us,
            )
            dev_txt = smoke.spread_us(samples) if samples else "not measured"
            print(f"{name}: {kernel} at {n} lanes: device {dev_txt} (min / median / max over "
                  f"{args.calls} calls); host launcher call {call_us:.2f} us, launch + event "
                  f"wait {trip_us:.2f} us (medians)", flush=True)
        legs.append(leg)
    print("launch floor (one-element torch add): "
          + (smoke.spread_us(floor) if floor else "not measured"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(json.dumps({
        "card": smi, "lanes": n, "calls": args.calls,
        "floor_us": None if floor is None else [float(q) * 1e3 for q in np.percentile(floor, (0, 50, 100))],
        "legs": legs,
    }))


if __name__ == "__main__":
    main()
