#!/usr/bin/env python3
"""Lanes a thread in the algorithm kernels K4 and K5, on the card.

    python3 scripts/torch_algo_lanes.py [--widths 8,256,1024,4096]
                                        [--threads 32,128]

Builds ``scripts/torch_algo_lanes.cu`` with the port's nvcc flags into
``ratelimit_tpu_torch/_build/`` and compares, for K4 (sliding window)
and K5 (GCRA) on a table of 2^18 slots (the algorithm banks' default),
the shipped rows kernel -- kMappedLanes lanes a thread, 16-byte row
loads, one-warp blocks (``csrc/algorithms.cu``, ``csrc/mapped.cuh``) --
with one lane a thread (``rl_probe_lane``: the same lane functions, its
row loads 4 bytes a thread) in blocks of each ``--threads``, in both
forms: mapped (the int32[5, N] batch and the readback in pinned host
memory, reached through their device aliases) and the device form
(both in device memory).  Inputs are chip_smoke.py's seeded algorithm
tables and batches (ids in [-ns, -1], fresh, saturated and limit-0
lanes, out-of-table pads).

At each width, form and kernel, every variant is first held bit for bit
against the plain version (readback and table), then timed in turns
(shipped, the others, then the same backwards): the profiler's device
time a call (min / median / max of 100) and the CUDA-event time of
back-to-back calls.  Prints the card's name and power limit and one
JSON line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "scripts", "torch_algo_lanes.cu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(kernels):
    """The probe library, built once a digest of its source, the port's
    algorithms.cu and every shared header."""
    h = hashlib.sha256()
    csrc = sorted(f for f in os.listdir(kernels.CSRC_DIR) if f.endswith(".cuh"))
    for path in (SOURCE, os.path.join(kernels.CSRC_DIR, "algorithms.cu"),
                 *(os.path.join(kernels.CSRC_DIR, f) for f in csrc)):
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"libalgo_lanes-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", so, SOURCE]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(done.stdout + done.stderr, flush=True)
        if done.returncode:
            sys.exit(f"nvcc failed ({done.returncode})")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("rl_sw_serve_step", "rl_sw_serve_step_mapped", "rl_gcra_serve_step",
                 "rl_gcra_serve_step_mapped"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i64, vp, i32, i32, vp, vp]
        fn.restype = ctypes.c_int
    lib.rl_probe_lane.argtypes = [i32, vp, i64, vp, i32, i32, vp, vp, i32, i32]
    lib.rl_probe_lane.restype = ctypes.c_int
    return lib


def variant(lib, algo, form, name):
    """The launch of variant `name` ("shipped" or "lane<threads>") of
    `algo` ("sw", "gcra") in `form` ("mapped", "device"), taking (state,
    num_slots, words, n, now, out, stream)."""
    if name == "shipped":
        return getattr(lib, f"rl_{algo}_serve_step" + ("_mapped" if form == "mapped" else ""))
    threads = int(name[len("lane"):])
    return lambda *args: lib.rl_probe_lane(algo == "gcra", *args, form == "mapped", threads)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="8,256,1024,4096")
    ap.add_argument("--threads", default="32,128",
                    help="block sizes of the one-lane-a-thread kernel")
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = _chip_smoke()
    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import gcra
    from ratelimit_tpu_torch.models import sliding_window as sw

    lib = build(kernels)
    plain = {"sw": sw._sw_step_plain, "gcra": gcra._gcra_step_plain}
    readback = {"sw": (2,), "gcra": ()}
    variants = ["shipped"] + [f"lane{t}" for t in args.threads.split(",") if t]
    ns, now = smoke.ALGO_SLOTS, smoke.ALGO_NOW
    stream = torch.cuda.current_stream().cuda_stream
    cells = []
    for algo in ("sw", "gcra"):
        for n in widths:
            rng = np.random.default_rng(n + len(algo))
            pool = rng.choice(ns, 2 * n, replace=False)
            base = smoke._algo_state(torch, rng, algo, ns, pool, dev)
            pk = smoke._algo_packed(torch, rng, n, ns, pool, dev)
            for form in ("mapped", "device"):
                if form == "mapped":
                    words = pk.cpu().pin_memory()
                    out = torch.empty((*readback[algo], n), dtype=torch.int32, pin_memory=True)
                else:
                    words = pk
                    out = torch.empty((*readback[algo], n), dtype=torch.int32, device=dev)
                for name in variants:
                    state, want_state = base.clone(), base.clone()
                    want = plain[algo](want_state, pk, now)
                    rc = variant(lib, algo, form, name)(
                        state.data_ptr(), ns, words.data_ptr(), n, now, out.data_ptr(), stream)
                    torch.cuda.synchronize()
                    if rc or not (torch.equal(out.to(dev), want) and torch.equal(state, want_state)):
                        sys.exit(f"{algo} {form} {name} at {n} lanes: rc {rc} or differs from the "
                                 f"plain version")
                state = base.clone()
                got = {name: dict(samples=[], call_ms=[]) for name in variants}
                for name in variants + variants[::-1]:
                    fn = variant(lib, algo, form, name)

                    def launch(fn=fn):
                        fn(state.data_ptr(), ns, words.data_ptr(), n, now, out.data_ptr(), stream)

                    got[name]["samples"] += smoke.device_samples(launch, iters=50) or []
                    got[name]["call_ms"].append(smoke.time_ms(launch))
                for name in variants:
                    us = np.array(got[name]["samples"]) * 1e3
                    cell = dict(algo=algo, form=form, variant=name, lanes=n,
                                device_us=[float(q) for q in np.percentile(us, (0, 50, 100))]
                                if len(us) else None,
                                call_us=[c * 1e3 for c in got[name]["call_ms"]])
                    print(f"{algo} {form} {name} at {n} lanes: device "
                          + (" / ".join(f"{v:.2f}" for v in cell["device_us"])
                             if cell["device_us"] else "not measured")
                          + " us (min / median / max of 100); call "
                          + ", ".join(f"{v:.2f}" for v in cell["call_us"]) + " us", flush=True)
                    cells.append(cell)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "slots": ns, "cells": cells}))


if __name__ == "__main__":
    main()
