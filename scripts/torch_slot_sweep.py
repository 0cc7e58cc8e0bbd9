"""Replay the ``fw_engine_4096`` cell's keys through the port's native
slot table alone -- no engine, no card -- and time the table's expiry
sweeps and the fused assign + dedup around them.

The traffic is the benchmark's own: the configuration's address space
and slot count and the traffic file's lanes and chunk pool, drawn from
``--seed`` by ``benchmark_cuda/keyspace.py`` as the cell's
``drivers/engine_chunks.py`` draws them, each chunk's keys stamped with
its window as that module stamps them.  The clock is simulated: ``--chunks-per-window`` chunks a window
of ``divider_s`` (318 at the cell's ~1.3 M decisions/s), every key
expiring at its window's end, and a sweep (``gc``) at the start of every
``--gc-every``-th window, as the dispatcher's 5-s collector runs it.

Prints one line a sweep (its ms, keys freed, keys left, and the longest
assign until the next sweep: the spike) and a summary line: sweep ms
(median, max), assign µs a chunk (median, p99), spike ms (median, max),
with the checkout's commit and the digest of the table's sources.  It
uses only the CPU.

    python scripts/torch_slot_sweep.py --seed 7 [--windows 26] [--commit <sha>]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark_cuda"))

from keyspace import WINDOW_DIGITS, KeySpace, stamp_window  # noqa: E402

from ratelimit_tpu_torch.backends import native_slot_table  # noqa: E402


def _commit() -> str:
    try:
        out = subprocess.run(
            ["git", "-C", ROOT, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def replay(cfg: dict, seed: int, windows: int, per_window: int, gc_every: int,
           lanes: int, n_pool: int) -> dict:
    """Drive one table through `windows` simulated windows; returns the
    per-sweep rows and every assign's µs."""
    unit = int(cfg["limits"]["divider_s"])
    space = KeySpace(cfg["keys"], cfg["domain"], cfg["descriptor_key"], seed)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 1])
    pool = space.draw(rng, n_pool * lanes).reshape(n_pool, lanes)
    packs = [space.pack(ids, WINDOW_DIGITS) for ids in pool]
    stamped = [None] * n_pool
    table = native_slot_table.NativeSlotTable(int(cfg["settings"]["TPU_NUM_SLOTS"]))
    hits = np.ones(lanes, np.uint32)
    limits = np.full(lanes, int(cfg["limits"]["default"]), np.uint32)
    wall = int(time.time())
    start = wall - wall % unit
    assign_us, sweeps = [], []
    c = 0
    for w in range(windows):
        now = start + w * unit
        if w and w % gc_every == 0:
            t0 = time.perf_counter()
            freed = table.gc(now)
            sweeps.append(dict(ms=(time.perf_counter() - t0) * 1e3, freed=freed,
                               live=len(table), spike_ms=0.0))
        expiries = np.full(lanes, now + unit, np.int64)
        for _ in range(per_window):
            blob, lens, at = packs[c]
            if stamped[c] != now:
                stamp_window(blob, at, now, stamped[c])
                stamped[c] = now
            t0 = time.perf_counter()
            table.assign_dedup_packed(blob, lens, now, expiries, hits, limits)
            us = (time.perf_counter() - t0) * 1e6
            assign_us.append(us)
            if sweeps:
                sweeps[-1]["spike_ms"] = max(sweeps[-1]["spike_ms"], us / 1e3)
            c = (c + 1) % n_pool
    return dict(sweeps=sweeps, assign_us=assign_us)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--config", default=os.path.join(ROOT, "benchmark_cuda/configs/edge_per_ip_fw.json"))
    ap.add_argument("--traffic", default=os.path.join(ROOT, "benchmark_cuda/traffic/engine_4096.json"))
    ap.add_argument("--windows", type=int, default=26, help="simulated windows (26: five sweeps)")
    ap.add_argument("--chunks-per-window", type=int, default=318)
    ap.add_argument("--gc-every", type=int, default=5, help="windows between sweeps")
    ap.add_argument("--lanes", type=int, default=None, help="default: the traffic file's")
    ap.add_argument("--pool-chunks", type=int, default=None, help="default: the traffic file's")
    ap.add_argument("--commit", default=None, help="default: git rev-parse of the checkout")
    args = ap.parse_args(argv)
    if not native_slot_table.available():
        print("the native slot table did not build", file=sys.stderr)
        return 1
    with open(args.config) as f:
        cfg = json.load(f)
    with open(args.traffic) as f:
        tr = json.load(f)
    lanes = args.lanes or int(tr["lanes"])
    n_pool = args.pool_chunks or int(tr["pool_chunks"])
    out = replay(cfg, args.seed, args.windows, args.chunks_per_window, args.gc_every,
                 lanes, n_pool)
    commit = args.commit or _commit()
    digest = (native_slot_table._src_digest() or "unknown")[:12]
    for k, s in enumerate(out["sweeps"]):
        print(f"sweep {k}: {s['ms']:.3f} ms, freed {s['freed']}, live {s['live']}, "
              f"spike {s['spike_ms']:.3f} ms")
    a = sorted(out["assign_us"])
    sweep_ms = [s["ms"] for s in out["sweeps"]]
    spike_ms = [s["spike_ms"] for s in out["sweeps"]]
    summary = dict(
        commit=commit, sources=digest, seed=args.seed, lanes=lanes, pool_chunks=n_pool,
        chunks=len(a), sweeps=len(sweep_ms),
        sweep_ms_median=statistics.median(sweep_ms) if sweep_ms else None,
        sweep_ms_max=max(sweep_ms) if sweep_ms else None,
        freed_median=statistics.median(s["freed"] for s in out["sweeps"]) if sweep_ms else None,
        assign_us_median=statistics.median(a),
        assign_us_p99=a[min(len(a) - 1, int(0.99 * len(a)))],
        spike_ms_median=statistics.median(spike_ms) if spike_ms else None,
        spike_ms_max=max(spike_ms) if spike_ms else None,
    )
    print("SLOT_SWEEP " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
