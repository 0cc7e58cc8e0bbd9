#!/usr/bin/env python3
"""How the mapped form of K1 reads its batch from pinned host memory.

    python3 scripts/torch_mapped_load.py [--widths 256,1024,4096]

Builds ``scripts/torch_mapped_load.cu`` with the port's nvcc flags into
``ratelimit_tpu_torch/_build/`` and compares, on one card, two ways for a
launch to read a packed int32[4, N] batch held in pinned host memory
through its device alias (one table of 2^20 slots, the same arithmetic
and readback):

- ``direct``: the shipped kernel (``unique_step_rows_kernel``), each
  thread's four 16-byte loads of the host words issued before any
  gather;
- ``bulk``: a block stages its tile in shared memory with four
  ``cp.async.bulk`` copies completing on one mbarrier;
- with ``--blocks 64,128``, the shipped kernel at those block sizes
  (``rl_probe_direct_block``; the launcher's is kMappedThreads).

With ``--device`` the batch and the readback lie in device memory
instead, and it compares the shipped device form (``rl_probe_device``:
the same kernel on device pointers) with the one-lane-a-thread kernel it
replaced (``rl_probe_device_lane``).

Without ``--device``, first a child process launches ``bulk`` once and checks it against the
plain version: a bulk copy may refuse a host-mapped source, and a fault
there ends only the child.  Then, at each width, both variants are held
bit for bit against the plain version and timed in turns (direct, bulk,
bulk, direct): the profiler's device time a call (min / median / max of
50) and the CUDA-event time of back-to-back calls.  Prints the card's
name and power limit and one JSON line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "scripts", "torch_mapped_load.cu")
NUM_SLOTS = 1 << 20


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    """The probe library, built once a source digest."""
    import hashlib

    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch import kernels

    h = hashlib.sha256()
    for path in (SOURCE, *(os.path.join(kernels.CSRC_DIR, f)
                           for f in ("counter_update.cuh", "mapped.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"libmapped_load-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", so, SOURCE]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print(done.stdout + done.stderr, flush=True)
        if done.returncode:
            sys.exit(f"nvcc failed ({done.returncode})")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("rl_probe_direct", "rl_probe_bulk", "rl_probe_direct_block",
                 "rl_probe_device", "rl_probe_device_lane"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i64, vp, i32, vp, i32, vp] + ([i32] if name.endswith("block") else [])
        fn.restype = ctypes.c_int
    return lib


def variant(lib, name):
    """The C function of variant `name` ("rl_probe_direct",
    "rl_probe_bulk", or "block<threads>"), with the common arguments."""
    if name.startswith("block"):
        threads = int(name[len("block"):])
        return lambda *args: lib.rl_probe_direct_block(*args, threads)
    return getattr(lib, name)


def inputs(torch, smoke, n, dev, seed, on_device=False):
    """A seeded table on the card, an int32[4, n] batch (positive and
    negative ids, padding, saturating lanes) and its copy in pinned
    memory (on the card with `on_device`), and an int32[n] readback
    beside it."""
    rng = np.random.default_rng(seed)
    table = smoke._table(torch, rng, NUM_SLOTS, dev)
    pk = smoke._packed(torch, rng, n, NUM_SLOTS, torch.device("cpu"), np.zeros(0, np.int64),
                       neg=True)
    if on_device:
        return table, pk, pk.to(dev), torch.empty(n, dtype=torch.int32, device=dev)
    return table, pk, pk.pin_memory(), torch.empty(n, dtype=torch.int32, pin_memory=True)


def check(torch, fw, lib, name, n, dev, smoke, on_device=False):
    """Launch `name` once at n lanes; True when the readback and the
    table equal the plain version's."""
    table, pk, words, out = inputs(torch, smoke, n, dev, n, on_device)
    plain = table.clone()
    want = fw._unique_step_plain(plain, pk.to(dev), "")
    rc = variant(lib, name)(table.data_ptr(), NUM_SLOTS, words.data_ptr(), n, out.data_ptr(), 0,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        print(f"{name} at {n} lanes: launch refused, CUDA error {rc}", flush=True)
        return False
    torch.cuda.synchronize()
    ok = torch.equal(out.to(dev), want) and torch.equal(table, plain)
    print(f"{name} at {n} lanes: {'equal to' if ok else 'DIFFERS from'} the plain version",
          flush=True)
    return ok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="256,1024,4096")
    ap.add_argument("--child", default=None, help="launch this variant once and exit")
    ap.add_argument("--blocks", default="",
                    help="block sizes of the shipped mapped kernel to add (not with --device)")
    ap.add_argument("--device", action="store_true",
                    help="batch and readback in device memory: the device forms")
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = _chip_smoke()
    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch.models import fixed_window as fw

    lib = build()
    if args.child:
        sys.exit(0 if all(check(torch, fw, lib, args.child, n, dev, smoke) for n in widths) else 1)
    if args.device:
        variants = ["rl_probe_device", "rl_probe_device_lane"]
    else:
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                "rl_probe_bulk", "--widths", args.widths],
                               capture_output=True, text=True, timeout=300)
        print(child.stdout + child.stderr[-2000:], flush=True)
        variants = ["rl_probe_direct"] + (["rl_probe_bulk"] if child.returncode == 0 else [])
        print(f"bulk copy from the host-mapped source: "
              f"{'works' if child.returncode == 0 else f'fails (child exit {child.returncode})'}",
              flush=True)
        variants += [f"block{b}" for b in args.blocks.split(",") if b]
    cells = []
    for n in widths:
        for name in variants:
            if not check(torch, fw, lib, name, n, dev, smoke, args.device):
                sys.exit(f"{name} differs from the plain version at {n} lanes")
        table, _, words, out = inputs(torch, smoke, n, dev, n, args.device)
        stream = torch.cuda.current_stream().cuda_stream
        got = {name: dict(samples=[], call_ms=[]) for name in variants}
        order = variants + variants[::-1]
        for name in order:
            fn = variant(lib, name)

            def launch(fn=fn):
                fn(table.data_ptr(), NUM_SLOTS, words.data_ptr(), n, out.data_ptr(), 0, stream)

            samples = smoke.device_samples(launch, iters=50)
            got[name]["samples"] += samples or []
            got[name]["call_ms"].append(smoke.time_ms(launch))
        for name in variants:
            us = np.array(got[name]["samples"]) * 1e3
            cell = dict(variant=name, lanes=n,
                        device_us=[float(q) for q in np.percentile(us, (0, 50, 100))]
                        if len(us) else None,
                        call_us=[c * 1e3 for c in got[name]["call_ms"]])
            print(f"{name} at {n} lanes: device "
                  + (" / ".join(f"{v:.2f}" for v in cell["device_us"]) if cell["device_us"]
                     else "not measured")
                  + " us (min / median / max of 100); call "
                  + ", ".join(f"{v:.2f}" for v in cell["call_us"]) + " us", flush=True)
            cells.append(cell)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "memory": "device" if args.device else "pinned host",
                      "bulk_works": "rl_probe_bulk" in variants, "cells": cells}))


if __name__ == "__main__":
    main()
