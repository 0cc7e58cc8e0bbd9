#!/usr/bin/env python3
"""The flagship forward step of two checkouts, in turns, on the card.

    python3 scripts/torch_forward_step.py --parent PATH [--steps N]
    python3 scripts/torch_forward_step.py --repo PATH [--label NAME]
    python3 scripts/torch_forward_step.py --probe

With ``--parent``, runs six legs, each in its own process -- the parent
checkout at PATH (P) and this one (C) in the order P, C, C, P, P, C --
then a probe of the grid barrier, and prints a summary.  With
``--repo``, runs one leg on that checkout: imports its
``ratelimit_tpu_torch``, builds its kernels in its own ``_build/``, and
drives the forward step on the ``__graft_entry__`` batch (2^20 slots,
4096 lanes, seed 0, 10 % fresh) on one table (``forward``) and on 8
banks of the sharded model (``step``).  Per table:

- under torch.profiler (device activities only), N steps between two
  marker kernels: device activities, memsets and memcpys per step, the
  device busy time of a step and its span from the first start to the
  last end;
- without the profiler, N steps each: the host microseconds of the call
  alone (the enqueue; the card runs behind it) and of the call and a
  synchronize.

The barrier probe launches a kernel that does nothing but k grid
barriers (cudaLaunchCooperativeKernel, k in 0, 1, 2, 16) in blocks of
128 threads: one and two blocks an SM (132, 264), the fused general
step's grid for N = 4096 (528) and every co-resident block; a barrier's
cost is the slope of the kernel's device time (torch.profiler) in k.
``--probe`` runs the probe alone.

Every leg prints one JSON line; the last lines are the card's name and
power limit and one JSON line with every number.  To unpack the parent
into a gitignored directory first::

    git archive <commit> | tar -x -C _smoke_checkout/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SLOTS = 1 << 20
BANKS = 8
LANES = 4096
LEGS = ("P", "C", "C", "P", "P", "C")
PROFILE_TRIES = 3

PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void barriers(int syncs, unsigned* sink) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < syncs; ++k) {
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sink[0] = syncs;
  }
}

extern "C" int probe_coresident(int threads, int* blocks) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)barriers,
                                                threads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_barriers(int blocks, int threads, int syncs, void* sink,
                              void* stream) {
  void* args[] = {&syncs, &sink};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)barriers, dim3(blocks), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
"""


def spread(xs):
    """[min, median, max]."""
    return [float(q) for q in np.percentile(xs, (0, 50, 100))]


def graft_batch(torch, fw, dev):
    """__graft_entry__.entry()'s batch on `dev`, rebuilt in numpy."""
    rng = np.random.default_rng(0)
    slots = rng.integers(0, NUM_SLOTS, LANES).astype(np.int32)
    hits = rng.integers(1, 4, LANES).astype(np.uint32)
    limits = rng.integers(1, 1000, LANES).astype(np.uint32)
    fresh = rng.random(LANES) < 0.1
    return fw.DeviceBatch(
        slots=torch.from_numpy(slots).to(dev),
        hits=torch.from_numpy(hits.view(np.int32)).to(dev),
        limits=torch.from_numpy(limits.view(np.int32)).to(dev),
        fresh=torch.from_numpy(fresh).to(dev),
        shadow=torch.zeros(LANES, dtype=torch.bool, device=dev),
    )


def profiled(torch, step, steps, dev):
    """Device activities of `steps` calls of step() between two marker
    kernels (a one-element add): per step the activity count, memsets,
    memcpys, busy us and span us; None and why where the capture does
    not split into the steps."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    marker = torch.zeros(1, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for _ in range(steps):
            step()
        marker.add_(1)
        torch.cuda.synchronize()
    evs = sorted(
        (ev for ev in prof.events() if ev.device_type == cuda),
        key=lambda ev: ev.time_range.start,
    )
    # The step makes memsets, memcpys and the port's kernels only; the
    # marker is PyTorch's elementwise add.
    marks = [i for i, ev in enumerate(evs) if "elementwise" in ev.name]
    if len(marks) != 2:
        return None, f"{len(marks)} markers among {len(evs)} device activities"
    seg = evs[marks[0] + 1 : marks[1]]
    if not seg or len(seg) % steps:
        return None, f"{len(seg)} device activities do not split into {steps} steps"
    k = len(seg) // steps
    parts = [seg[c * k : (c + 1) * k] for c in range(steps)]
    return dict(
        activities=k,
        memsets=sum(ev.name.startswith("Memset") for ev in parts[0]),
        memcpys=sum(ev.name.startswith("Memcpy") for ev in parts[0]),
        names=[ev.name.replace("(anonymous namespace)::", "").split("<")[0] for ev in parts[0]],
        busy_us=spread([sum(ev.time_range.elapsed_us() for ev in p) for p in parts]),
        span_us=spread([p[-1].time_range.end - p[0].time_range.start for p in parts]),
    ), None


def leg(repo: str, label: str, steps: int) -> dict:
    import torch

    sys.path.insert(0, repo)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.parallel import sharded as sh

    if not os.path.abspath(kernels.__file__).startswith(repo + os.sep):
        sys.exit(f"ratelimit_tpu_torch came from {kernels.__file__}, not from {repo}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.build_all()
    batch = graft_batch(torch, fw, dev)
    one = fw.FixedWindowModel(NUM_SLOTS, device=dev)
    banked = sh.ShardedFixedWindowModel(NUM_SLOTS, sh.make_mesh(BANKS, dev))
    tables = {
        "one table": (one, one.init_state(), one.forward),
        f"{BANKS} banks": (banked, banked.init_state(), banked.step),
    }
    cells = []
    for name, (_, counts, forward) in tables.items():
        step = lambda: forward(counts, batch)  # noqa: E731
        for _ in range(20):  # warm: builds, allocator, first launches
            step()
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRIES):
            stats, why = profiled(torch, step, steps, dev)
            if stats is not None:
                break
        else:
            sys.exit(f"{label} {name}: {why}")
        enqueue, synced = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            enqueue.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t0) * 1e6)
        cells.append(
            dict(table=name, steps=steps, host_enqueue_us=spread(enqueue),
                 host_sync_us=spread(synced), **stats)
        )
        print(f"{label}: {name}: {json.dumps(cells[-1])}", flush=True)
    return dict(label=label, repo=repo, cells=cells)


def barrier_probe(torch, out_dir: str, reps: int = 100) -> dict:
    """Device us per launch of the barrier probe (the kernel's own time
    under torch.profiler, mean over `reps` launches), by grid and barrier
    count, and the slope (us per barrier) at each grid: one block an SM,
    two, the fused step's 528 at N = 4096, and every co-resident block."""
    from torch.profiler import ProfilerActivity, profile

    nvcc = os.path.join("/usr/local/cuda/bin", "nvcc")
    src = os.path.join(out_dir, "probe.cu")
    lib_path = os.path.join(out_dir, "libprobe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", lib_path, src],
        check=True,
    )
    lib = ctypes.CDLL(lib_path)
    lib.probe_barriers.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.probe_coresident.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    most = ctypes.c_int()
    if lib.probe_coresident(128, ctypes.byref(most)) != 0:
        sys.exit("probe_coresident failed")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cuda = torch.autograd.DeviceType.CUDA
    result = {}
    for blocks in (132, 264, 528, most.value):
        times = {}
        for syncs in (0, 1, 2, 16):
            def launch():
                rc = lib.probe_barriers(blocks, 128, syncs, sink.data_ptr(), stream)
                if rc != 0:
                    sys.exit(f"probe launch failed with {rc}")

            for _ in range(10):
                launch()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    launch()
                torch.cuda.synchronize()
            us = [ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == cuda and "barriers" in ev.name]
            if not us:
                sys.exit("the profiler saw no probe kernel")
            times[syncs] = float(np.mean(us))
        result[str(blocks)] = dict(
            us_per_launch=times, us_per_barrier=(times[16] - times[0]) / 16
        )
    return result


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout to run as P against this one (C)")
    ap.add_argument("--repo", help="run one leg on this checkout")
    ap.add_argument("--label", default=None, help="name of the leg in the output")
    ap.add_argument("--steps", type=int, default=200, help="steps per pass")
    ap.add_argument("--probe", action="store_true", help="run the barrier probe only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    if args.repo:
        result = leg(os.path.abspath(args.repo), args.label or args.repo, args.steps)
        print(json.dumps(result), flush=True)
        return
    if args.probe:
        with tempfile.TemporaryDirectory() as tmp:
            probe = barrier_probe(torch, tmp)
        smi = card()
        print(smi)
        print(json.dumps({"card": smi, "barrier_probe": probe}))
        return
    if not args.parent:
        sys.exit("give --parent PATH (all legs), --repo PATH (one leg) or --probe")
    repos = {"P": os.path.abspath(args.parent), "C": HERE}
    legs = []
    for i, side in enumerate(LEGS):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--repo", repos[side],
             "--label", f"{side}{i + 1}", "--steps", str(args.steps)],
            capture_output=True, text=True, check=False,
        )
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.exit(f"leg {side}{i + 1} failed:\n{out.stderr[-4000:]}")
        legs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    with tempfile.TemporaryDirectory() as tmp:
        probe = barrier_probe(torch, tmp)
    print(f"barrier probe: {json.dumps(probe)}")
    for table in ("one table", f"{BANKS} banks"):
        for key in ("activities", "memsets", "busy_us", "span_us", "host_enqueue_us", "host_sync_us"):
            row = []
            for lg in legs:
                cell = next(c for c in lg["cells"] if c["table"] == table)
                v = cell[key]
                row.append(f"{lg['label']} {v[1] if isinstance(v, list) else v:.2f}")
            print(f"{table}, {key} (median): " + ", ".join(row))
    smi = card()
    print(smi)
    print(json.dumps({"card": smi, "legs": legs, "barrier_probe": probe}))


if __name__ == "__main__":
    main()
