"""What a copy of one bank's table waits for while another bank's
stream is stalled, on the card.

    python3 scripts/torch_snapshot_stall.py [--reps 5] [--stall-ms 500]

A kernel spins for --stall-ms on stream X (torch.cuda._sleep, as the
smoke's stall does), and a thread copies a 2^20-slot int32 table on X
to the host, queued behind the kernel (a snapshot landing behind a
stall).  Meanwhile a table on stream Y is copied, --reps times in
alternating order, both ways: to pageable memory (``tensor.cpu()``)
and to pinned memory with a wait on Y alone (``models.fixed_window.
state_to_numpy``); the copy on X is made the same way as the one timed
on Y.  Each way is also timed with nothing stalled, and with the stall
but no copy queued on X.  A copy on Y that waited for X takes about
--stall-ms.  Prints the card's name and power limit and one JSON line
of host milliseconds per copy on Y; exits 2 without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stall-ms", type=float, default=500.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from ratelimit_tpu_torch.models.fixed_window import state_to_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    x, y = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    tables = {s: torch.arange(1 << 20, dtype=torch.int32, device=dev) for s in ("x", "y")}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 20_000_000 / start.elapsed_time(end)
    ways = {
        "pageable": lambda t: t.cpu().numpy(),
        "pinned": state_to_numpy,
    }

    def copy(way, stream, name):
        with torch.cuda.stream(stream):
            return ways[way](tables[name])

    for way in ways:  # warm: the pinned allocator's first blocks
        copy(way, x, "x")
        copy(way, y, "y")
    out = {f"{w}_{c}": [] for w in ways for c in ("idle", "stall", "stall_and_copy_behind")}
    for r in range(args.reps):
        for way in list(ways) if r % 2 == 0 else list(ways)[::-1]:
            t0 = time.perf_counter()
            got = copy(way, y, "y")
            out[f"{way}_idle"].append((time.perf_counter() - t0) * 1e3)
            assert int(got[-1]) == (1 << 20) - 1
            for case in ("stall", "stall_and_copy_behind"):
                with torch.cuda.stream(x):
                    torch.cuda._sleep(int(args.stall_ms * cycles_per_ms))
                behind = None
                if case == "stall_and_copy_behind":
                    behind = threading.Thread(target=copy, args=(way, x, "x"))
                    behind.start()
                    time.sleep(0.02)  # the copy on X is queued behind the kernel
                t0 = time.perf_counter()
                copy(way, y, "y")
                out[f"{way}_{case}"].append((time.perf_counter() - t0) * 1e3)
                if behind is not None:
                    behind.join()
                x.synchronize()
    print(json.dumps({"device": smi, "stall_ms": args.stall_ms, "copy_ms_on_y": {
        k: [round(v, 3) for v in vals] for k, vals in out.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
