#!/usr/bin/env python3
"""A supervised restart inside a stall, under load: chip_smoke.py's
phase 13b (8 paced clients on two domains through phase 8's stall on
the fixed-window bank) with the restart's stages and every fault timed.

    python3 scripts/torch_restart_stall.py [--legs inside,after]

Two legs in one process, each a fresh runner:

- ``inside``: the restart as the fault domain made it before it waited
  for the stalled stream to drain (``fault_domain.stream_idle`` patched
  to answer True), so it runs while the stalled kernel still spins;
- ``after``: the fault domain as it is, the restart waiting for the
  stream.

Per leg: the time of the stall, of each fault (bank and kind), of the
restart's begin and end, of the engine factory and of the warmup, of
the stalled kernel's end; the fault counts; the interpreter-lock gaps
over 30 ms (a thread sleeping 0.2 ms at a time, chip_smoke.GilProbe);
and whether phase 13b's checks passed (its FAIL line when not).
Prints the card's name and power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Failed(Exception):
    pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", default="inside,after")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.backends import cuda_cache as cc
    from ratelimit_tpu_torch.backends import fault_domain as fdm

    def fail(msg):
        raise Failed(msg)

    cs.fail = fail
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kernels.build_all()
    torch.cuda.set_device(0)
    cycles = cs.sleep_cycles_per_ms(torch)

    marks = []

    def mark(what):
        marks.append((time.perf_counter(), what))

    def timed(owner, name, label):
        real = getattr(owner, name)

        def wrapper(*a, **kw):
            mark(f"{label(*a)} begin")
            try:
                return real(*a, **kw)
            finally:
                mark(f"{label(*a)} end")

        setattr(owner, name, wrapper)
        return real

    timed(fdm.DeviceFaultDomain, "_try_restart", lambda self, bank, *_: f"restart attempt bank{bank}")
    timed(fdm, "default_engine_factory", lambda bank, *_: f"engine factory bank{bank}")
    timed(cc, "warmup_engine", lambda *_: "warmup")
    record = fdm.DeviceFaultDomain.record_fault

    def record_fault(self, bank, kind, exc, **kw):
        mark(f"fault bank{bank} {kind}")
        return record(self, bank, kind, exc, **kw)

    fdm.DeviceFaultDomain.record_fault = record_fault
    stall = cs.stall_stream

    def stall_stream(torch, engine, ms, cpm):
        mark(f"stall of {ms:.0f} ms enqueued")
        end = stall(torch, engine, ms, cpm)

        def watch():
            end.synchronize()
            mark("stalled kernel over")

        threading.Thread(target=watch, daemon=True).start()
        return end

    cs.stall_stream = stall_stream
    idle = fdm.stream_idle
    ok = True
    for leg in args.legs.split(","):
        fdm.stream_idle = (lambda engine: True) if leg == "inside" else idle
        marks.clear()
        with cs.serving("cuda", env=cs.OVERLOAD_ENV, config=cs.OVERLOAD_CONFIG) as (runner, _req, R):
            with cs.GilProbe() as probe:
                t0 = time.perf_counter()
                try:
                    out = cs.shed_stall_phase(torch, runner, R, cycles)
                    verdict = f"13b passed: checkout admitted {out['checkout_admitted']}, RPC max {out['rpc_max_ms']:.1f} ms"
                except Failed as e:
                    verdict = f"13b FAIL: {e}"[:400]
                    ok = ok and leg == "inside"
            faults = dict(runner.cache.fault_domain.stat_faults)
            stamps = probe.stamps
            gaps = [
                (round(a - t0, 3), round((b - a) * 1e3, 1))
                for a, b in zip(stamps, stamps[1:])
                if b - a > 0.03
            ]
        print(f"leg {leg} ({smi}): {verdict}; faults {faults}", flush=True)
        last = None
        for t, what in marks:
            if what != last:  # one line for a run of equal marks
                print(f"  {t - t0:8.3f} s  {what}")
            last = what
        print(f"  interpreter-lock gaps over 30 ms (s, ms): {gaps}", flush=True)
    fdm.stream_idle = idle
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
