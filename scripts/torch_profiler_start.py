#!/usr/bin/env python3
"""What a process's first torch.profiler session costs the threads
around it.

    python3 scripts/torch_profiler_start.py            # host activity only
    python3 scripts/torch_profiler_start.py --cuda     # with a CUDA context

Starts a ticker thread that wakes every millisecond and notes how long
each wake-up took, then opens and closes the session that
``/debug/xla_trace`` opens (``server/debug_profiling.py:_profile``:
host activity, and CUDA activity when the process holds a CUDA
context) several times in one fresh process.  For each session it
prints the seconds the start and the stop took and the longest gap the
ticker saw during each: a gap is time the interpreter lock was held
away from every other thread, which is what a dispatcher thread waits
out before it can answer within the kernel deadline.  The first session
pays the imports and the kineto (and CUPTI) start-up; that is why the
port starts one empty session when DEBUG_PROFILING opens the captures
(``warm_torch_profiler``).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cuda", action="store_true", help="hold a CUDA context first")
    ap.add_argument("--sessions", type=int, default=3)
    args = ap.parse_args()

    import torch

    from ratelimit_tpu_torch.server.debug_profiling import _profile

    if args.cuda:
        if not torch.cuda.is_available():
            sys.exit("--cuda: torch.cuda.is_available() is false")
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        print(torch.cuda.get_device_name(0))
    gaps = []  # (seconds since the previous wake-up, perf_counter now)
    stop = threading.Event()

    def ticker():
        last = time.perf_counter()
        while not stop.is_set():
            now = time.perf_counter()
            gaps.append((now - last, now))
            last = now
            time.sleep(0.001)

    def longest(t0, t1):
        return max((d for d, n in gaps if t0 <= n <= t1 + 0.05), default=0.0)

    t = threading.Thread(target=ticker, daemon=True)
    t.start()
    time.sleep(0.1)
    for i in range(args.sessions):
        prof = _profile()
        t0 = time.perf_counter()
        prof.__enter__()
        t1 = time.perf_counter()
        time.sleep(0.2)
        t2 = time.perf_counter()
        prof.__exit__(None, None, None)
        t3 = time.perf_counter()
        time.sleep(0.1)
        print(
            f"session {i + 1}: start {t1 - t0:.3f} s (longest gap {longest(t0, t1) * 1e3:.1f} ms), "
            f"stop {t3 - t2:.3f} s (longest gap {longest(t2, t3) * 1e3:.1f} ms)"
        )
    stop.set()
    t.join(timeout=5)


if __name__ == "__main__":
    main()
