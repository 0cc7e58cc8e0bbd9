"""Which torch.profiler sessions keep a capture's device activities as
the process ages.  Card only:

    python3 scripts/torch_profiler_window.py [--ages 0,70] [--calls 5]
        [--pads 0,1.0] [--reps 6]

At each age (seconds after the process's first profiler session) it
takes --reps captures in a row of --calls one-element adds, each add
followed by a synchronize as a served request's kernel is, in each of
these ways:

- device / host_device: a session over device activity alone
  (ProfilerActivity.CUDA), or over host and device activity, with `pad`
  seconds of sleep inside it before the first add and after the last,
  for each pad in --pads;
- primed: a device session with no pad, each after an empty session in
  which one add and a synchronize ran.

For each it records the kernels kept a capture and, where all were
kept, the range of each kernel's start in the trace minus the host's
clock just before its add (time.time_ns(); a few µs when the trace's
device clock agrees with the host's).  It prints one JSON line an age,
with the card's name and power limit and the TEARDOWN_CUPTI setting of
the environment."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def capture(torch, activities, calls: int, pad: float = 0.0, prime: bool = False):
    """(kernels kept, [min, max] ms from an add's host time to its
    kernel's start in the trace, or None where some kernel was lost)."""
    from torch.profiler import profile

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    if prime:
        with profile(activities=activities):
            x.add_(1)
            torch.cuda.synchronize()
    host_ns = []
    with profile(activities=activities) as prof:
        time.sleep(pad)
        for _ in range(calls):
            host_ns.append(time.time_ns())
            x.add_(1)
            torch.cuda.synchronize()
        time.sleep(pad)
    cuda = torch.autograd.DeviceType.CUDA
    kept = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda)
    if len(kept) != calls:
        return len(kept), None
    offsets = [(k - h) / 1e6 for k, h in zip(kept, host_ns)]
    return len(kept), [round(min(offsets), 3), round(max(offsets), 3)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ages", default="0,70")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--pads", default="0,1.0")
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe needs a CUDA GPU")
    card = smi()
    print(card, flush=True)
    device = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    capture(torch, both, 1)  # the process's first session
    t0 = time.monotonic()
    for age in (float(a) for a in args.ages.split(",")):
        time.sleep(max(0.0, t0 + age - time.monotonic()))
        row = dict(age_s=round(time.monotonic() - t0, 1), calls=args.calls, card=card,
                   teardown_cupti=os.environ.get("TEARDOWN_CUPTI"))
        ways = {f"{mode} pad {pad}": dict(activities=acts, pad=float(pad))
                for pad in args.pads.split(",") for mode, acts in
                (("device", device), ("host_device", both))}
        ways["primed"] = dict(activities=device, prime=True)
        for name, kw in ways.items():
            runs = [capture(torch, calls=args.calls, **kw) for _ in range(args.reps)]
            row[name] = dict(kept=[k for k, _ in runs], offset_ms=[o for _, o in runs])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
