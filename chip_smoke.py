#!/usr/bin/env python3
"""Smoke run of ratelimit_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each; any failure exits non-zero:

1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from csrc/, one nvcc per source in parallel;
3. kernels: each kernel against its plain PyTorch version on the card,
   same seeded inputs, exact equality (integer arithmetic and IEEE f32
   steps in one fixed order: the tolerance is 0).  K1, K2 and K3's
   standalone decision block for N in {8, 100, 128, 4096} at 2^20 slots
   and once at 2^24 slots, with positive and then with negative slot
   ids; K2 also at the sizes its triangular tiling can get wrong, N in
   {1, 127, 129, 4097, 16384}, and on a batch whose running sum wraps
   u32 inside a segment; the algorithm-bank kernels K4
   (sliding window) and K5 (GCRA) for the same N at 2^18 slots (the
   bank default) and 4096 at 2^24, over several steps with the clock
   advancing through same, adjacent and older windows, with fresh,
   padding, saturated and limit-0 lanes and ids in [-ns, -1]; the
   bank-sharded routed serving step K6 over 8 banks for the same N at
   2^20 slots and 4096 at 2^24, with uniform and all-one-bank routing,
   fresh, padding, saturated, out-of-table and negative ids; the fused
   general step (one cooperative launch: K3 on one table, K7 over 8
   banks of global ids) in each epilogue -- raw afters, u8/u16 readback,
   decision block -- at 2^20 and 2^24 slots for N in SIZES and K2's
   edge sizes, on duplicates with positive and negative ids, one slot
   fresh on its last lane, a u32 wrap inside a segment and -1 beside
   ns - 1; the served step in both
   forms: K1 and K6 by value (lanes in the launch's parameters, readback
   into mapped pinned memory) for N in LANES_SIZES and in the device
   form for N in DEVICE_FORM_SIZES, at 2^20 and 2^24 slots; K4 and K5
   by value for N in LANES_SIZES at 2^18 and 2^24 slots over every
   clock step, against their plain versions and their device forms;
   profiler device times at 4096 (the by-value forms at their served
   width), beside the launch floor (a one-element in-place torch add),
   with min / median / max per call for every kernel, K1, K4, K5 and K6
   in each form at the served widths, and K2 at 16384; then the served
   chunk: engine._device_submit + step_complete at 1, 8 and 13 lanes on
   one table, on 8 banks, on a sliding-window and on a GCRA table,
   SERVED_CHUNKS chunks under torch.profiler -- per chunk the device
   activities (one: the by-value kernel), memcpys (none), device busy
   time and span from the first start to the last end -- and as many
   again without it for the host microseconds; and the host mirror
   (the numpy engine a quarantined bank falls back to) against K1 at
   2^20 slots, K4 and K5 at 2^18 on the same seeded packs: codes and
   remaining equal;
4. forward: the flagship forward step (the __graft_entry__ batch: 2^20
   slots, 4096 lanes, seed 0, 10% fresh) on the card, against the plain
   version and an independent numpy reference: exactly one launch (the
   fused general step, K3 with its decision block), and over 20
   profiled steps one device activity a step, no memset, no memcpy;
5. sharded forward: the same batch through the bank-sharded model (8
   banks on the card) -- one launch of the fused step, K7 with K3's
   decision block, one device activity a step -- against the
   single-table forward step and the sharded plain version, its table
   in global order against the single table;
6. served: the runner in-process with BACKEND_TYPE=cuda and the
   default TPU_ALGORITHM_BANKS (sliding_window,gcra) answering gRPC
   ShouldRateLimit requests -- the 6th hit on a 5/min key is
   OVER_LIMIT on the fixed-window lane (K1), on a sliding-window key
   (K4) and on a GCRA key (K5); a shadowed GCRA key is enforced by
   fixed-window while ratelimit.tpu.shadow.gcra.{agree,diverge}
   moves; a concurrent burst coalesces into multi-lane launches --
   and the warm microseconds per request on a fixed-window and on a
   GCRA key; on the fixed-window, the GCRA and the sliding-window key
   every launch of the one-descriptor requests (and of the burst) takes
   the by-value form (K1, K5, K4), 50 requests make 50 launches and no
   memcpy on the card, and one 200-descriptor request takes the device
   form;
7. sharded served: the runner with BACKEND_TYPE=cuda-sharded, 2^20
   slots over a mesh of 8 banks on the card -- the 6th hit on a 5/min
   key is OVER_LIMIT with remaining [4, 3, 2, 1, 0, 0], 40 keys leave a
   live counter in every bank, a concurrent burst coalesces into
   multi-lane K6 launches -- and the warm microseconds per request;
   K6 in its two forms as K1 in phase 6;
8. fault: the runner with BACKEND_TYPE=cuda and every default but a
   short restart backoff; on the fixed-window bank and then on the GCRA
   bank: 40 hits on a 120/hour rule, a snapshot, a kernel spinning for
   8 kernel deadlines on the bank's own stream, 40 hits during the
   stall (each back within the deadline plus STALL_RPC_MARGIN_S,
   answered by the host mirror: one hang fault, health DEGRADED), the
   supervised restart on a new stream (health SERVING), 100 more hits
   through the kernel again: exactly 120 of the 180 admitted; a third
   episode on the fixed-window bank queues a snapshot just behind the
   stall (the supervisor's, landing there by chance): it gives up at
   the deadline and the hang is seen as ever, while a snapshot of the
   GCRA bank during the stall copies at once;
9. listeners: the runner with BACKEND_TYPE=cuda, every default but the
   config, the ports and DEBUG_PROFILING=1, over its HTTP and debug
   listeners -- the 6th /json hit on a 5/min key is 429 on the
   fixed-window, sliding-window and GCRA keys; /healthcheck answers 200
   OK on both listeners; requests sent with a sampled traceparent
   commit traces with every phase down to kernel.step, shown in
   /debug/tracez, no kernel.step shorter than K1's device time;
   /debug/xla_trace (a torch.profiler capture) during a concurrent
   /json burst names the by-value kernels K1, K4 and K5;
   /debug/profile during another burst prints the top ten functions by
   self samples; warm microseconds per request over /json beside gRPC
   on fresh fixed-window keys, in alternating pairs;
10. topology: the runner with TPU_NUM_LANES=4, TPU_PERSECOND=true and
   TPU_CHECKPOINT_DIR, every other setting at its default (2^20 slots
   split 4 x 2^18, the per-second bank at 2^20, the algorithm banks at
   2^18, the fault domain armed) -- its banks by role, no two live banks
   on one CUDA stream (at boot and after a restart); 8 gRPC clients over
   keys on every lane admit exactly each key's limit, every lane
   launches K1, SECOND-unit keys live only in the per-second bank, no
   fault; phase 8's stall on one lane's stream: that lane quarantined
   and answered by its mirror while the other lanes launch K1 with no
   fallback answer, restarted without forgiving a window; one lane
   filled to 2^18 live keys and every bank's checkpoint file written
   during an 8-client burst (exclusive ms, bytes and keys per bank, RPC
   ms during the snapshot against outside it, no fault); half of a limit
   admitted, stop() (the final checkpoint), a second runner on the same
   files admitting exactly the other half, and a runner of two lanes
   refusing the lane files by role;
11. write-behind and memory: the runner with BACKEND_TYPE=cuda-write-behind
   (one bank at the default 2^20 slots, TPU_WARMUP and TPU_CHECKPOINT_DIR
   set) -- 8 gRPC clients over 64 keys each of a 2/minute rule, every key
   hit 3 times: each key admits exactly 2, its counter on the card is 3
   after flush(), and a MemoryRateLimitCache fed each client's requests
   agrees on every status; a kernel spinning about 1 s on the bank's
   stream while one client keeps hitting a key: every RPC back within 50
   ms, exactly the limit admitted, the dispatcher's intake above 0, and
   after flush() the card holds every hit; 2^18 keys filled through
   do_limit in requests of 512 descriptors (the completer's _reconcile
   timed per 4096 lanes), stop() and a boot on the files (on_restored
   timed, the view whole, keys at their limit OVER_LIMIT on their first
   hit); cuda-sharded-write-behind over 8 banks exact, K6 launched; and
   BACKEND_TYPE=memory answering gRPC and /json exactly with no kernel
   launched;
12. observability: the runner with BACKEND_TYPE=cuda and every default
   (2^20 fixed-window slots, 2^18 per algorithm bank, every plane on)
   but the sampler intervals (TSDB_INTERVAL_S and ANOMALY_INTERVAL_S
   0.5 s), INCIDENT_DIR and DEBUG_PROFILING=1 -- an 8-client gRPC and
   /json burst over fixed-window, sliding-window and GCRA keys, one
   value clearly the hottest: one launch record for each completed
   launch of each bank, all ok, items adding up to the requests and the
   per-algorithm tallies to the keys sent, every complete_ns positive;
   one flight record per RPC with its code; the SLO counts; the hot key
   on top of the sketch at or above its true count; the time series
   moving; no fault -- then phase 8's stall on the fixed-window bank:
   the journal tells bank_quarantine, bank_fallback ... bank_restart in
   seq order, the OUTCOME_FALLBACK records and the flight records with
   the fallback code equal the fallback answers, the stalled launch's
   record is stamped once its event completed, the latency detector
   trips and its incident (in memory and in INCIDENT_DIR) holds the
   flight rows, the journal and the series; during a second burst the
   longest interpreter-lock gap of one incident capture and of one
   time-series sample (bound: half the kernel deadline; no fault); and
   warm microseconds per request with every plane at its default
   against every plane off, two runners side by side, in alternating
   pairs;
13. overload control and the cluster handoff: the runner with
   BACKEND_TYPE=cuda at every default but OVERLOAD_{PROMOTE,SHED,
   BACKPRESSURE}_ENABLED, PROMOTE_TTL_S=1, ANOMALY_INTERVAL_S=0.5,
   BACKPRESSURE_TOKENS=4 and BACKPRESSURE_HOLD_S=1, serving two
   domains (bulk, priority 1; checkout, priority 5) on a pinned clock
   (no minute rolls over inside the 5/minute rules) -- 13a: 4 clients
   on one bulk key until the controller promotes it (live in
   /debug/overload), then 100 hits on it OVER_LIMIT with no K1 launch
   while 100 cold keys launch K1, the entry expiring after the TTL and
   the key launching K1 again, and warm microseconds per request on
   the promoted key against a device key in alternating pairs; 13b: 4
   clients a domain, one request each every 40 ms, through phase 8's
   stall: the journal's backpressure engage before the shed floor's
   raise, then its lower and the release, every floor shed a bulk one
   with flight code 8 and no
   backend work, checkout never shed by the floor and each checkout key
   admitting exactly its limit, the ratelimit.overload families moving
   on /metrics, every RPC within the deadline + 0.5 s, health SERVING;
   13c: runner A (cuda, two lanes) and runner B (cuda-sharded, 8 banks)
   with CLUSTER_HANDOFF_ENABLED, TPU_PERSECOND and one CACHE_KEY_PREFIX
   on a pinned clock: 4096 keys of a minute, a second-unit, a
   sliding-window and a GCRA rule at half their limit on A, the
   HandoffCoordinator over the debug listeners moving membership [A]
   -> [A, B], every key admitting exactly the other half on its owner,
   /debug/cluster and the journals telling it; then one lane of A
   filled to 2^18 live keys, the reference's export_keys and
   import_keys timed on it, and the port's two-leg export and chunked
   import during an 8-client burst on both runners (each exclusive
   leg's ms, RPC ms during against outside, no fault); 13d:
   scripts/torch_chaos_smoke.py --device cuda, every check passing;
14. the cluster's front tier: runners A, B and C with BACKEND_TYPE=cuda
   at the default state size, CLUSTER_HANDOFF_ENABLED and one pinned
   clock in this process, and `python -m ratelimit_tpu_torch.cluster.proxy`
   in a process of its own (which must map no torch or CUDA library)
   over a replicas file [A, B], an admin map of all three debug
   listeners and a debug listener on a free port -- warm microseconds
   per request via the proxy against direct to the owner on keys A
   owns, in alternating pairs; a 120/minute target key that A owns
   under [A, B] and C under [A, C] offered 240 hits through the proxy
   beside 4 background clients, B stopped (ejection and failover), the
   file rewritten to [A, C] (the proxy swaps and its coordinator drives
   POST /debug/cluster/export|import over HTTP), 240 more hits: exactly
   120 admitted; the handoff summary from the proxy's /stats.json, RPC
   ms during the churn against outside it, the longest interpreter-lock
   gap on the replicas' side, each live replica's exclusive legs and
   /debug/cluster with no fault; /fleet.json merging the live replicas
   (liveness, SLO sections, the timeline membership_change ...
   handoff_end); K1 launched on each live replica; exit 0 on SIGTERM.
15. sanitized serving: in a child process (so the patched lock
   factories never touch phases 1-14), the port's runtime lock sanitizer
   (ratelimit_tpu_torch/analysis/sanitizer.py) installed before any port
   module allocates a lock, torch loaded first so its waits for the card
   (torch.cuda.synchronize, Stream.synchronize, Event.synchronize) are
   tracked too; the runner with BACKEND_TYPE=cuda at every default; 8
   gRPC clients and one /json client for 5 s over the fixed-window,
   sliding-window and GCRA keys, one forced periodic snapshot and one
   fault-domain probe half way; the sanitizer's locks, order edges and
   violations, the K1 / K4 / K5 by-value launches, and warm
   microseconds per request on that runner against one booted with the
   sanitizer uninstalled, in alternating pairs.  Any lock-order cycle,
   any unsanctioned blocking call under a lock, a child that does not
   exit 0, or no by-value launch of one of the three fails the smoke.

Phases 6, 7 and 9 run their runners on a clock pinned half way through
a minute (pinned_clock), so no 5/minute progression waits for a new
minute.  Phases 6, 7, 9, 10, 12, 13, 14 and 15 run with the fault domain armed at its defaults
(KERNEL_DEADLINE_S 0.25 s) and must end with no fault, no fallback
answer, no bank quarantined and health SERVING (phase 10 but for its
one stall, and phase 12 for its); every served phase binds its three listeners to free local
ports.  Kernel launch counts are zeroed just before each main-path
phase (4-14; phase 15 counts the by-value launches of its own child)
and read just after: every kernel must have run there, where a launch
of the fused general step counts for each body it runs (K2's tile pass,
the K3 update, K3's decision block, K7).  The last lines
are a JSON summary of the kernels and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, and the non-tensor-core 32-bit rate used for the integer
# compare/add work of these kernels.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SIZES = (8, 100, 128, 4096)
# The serving kernels in each form: by value up to 128 lanes (banks x
# cap), the device form past it.
LANES_SIZES = (1, 8, 13, 16, 100, 128)
DEVICE_FORM_SIZES = (129, 4096)
# The served chunk: lanes per chunk, and chunks per pass.
SERVED_WIDTHS = (1, 8, 13)
SERVED_CHUNKS = 200
# One served request this wide is a chunk past the by-value budget on one
# table (256 padded lanes) and on 8 banks (cap 32 or more): the device
# form serves it.
WIDE_DESCRIPTORS = 200
# torch.profiler now and then drops device activities from a capture: a
# capture whose activities do not split into its calls is taken again.
PROFILE_TRIES = 3
# Of 50 served requests, one launch each, the kernels a capture must
# show: the launch counters are exact, the capture may drop a few.
SEEN_KERNELS = 45
# K2's own edge sizes beside SIZES: one lane, a 128-lane tile and one
# either side, one lane past the largest batch bucket, and 16384.
PREFIX_EDGE_SIZES = (1, 127, 129, 4097, 16384)
# One slot's running sum wraps u32 inside its segment: the true modular
# sum (the Pallas kernel's answer) is WRAP_WANT, where JAX's XLA prefix,
# which takes a segment's base as a min over it, gives [0xFFFFFFF0,
# 0xFFFFFFF0, 0, 1].
WRAP_SLOTS = (1, 2, 2, 2)
WRAP_HITS = (0xFFFFFFF0, 8, 16, 1)
WRAP_WANT = (0xFFFFFFF0, 8, 0x18, 0x19)
BANKS = 8
NUM_SLOTS = 1 << 20
BIG_SLOTS = 1 << 24
ALGO_SLOTS = 1 << 18  # TPU_ALGORITHM_NUM_SLOTS default
U32 = 0xFFFFFFFF
# A clock aligned to every divider (1, 60, 3600 s), so the first step
# has zero elapsed seconds, then steps inside the window, into the
# adjacent one and past it.
ALGO_NOW = 1_699_999_200
ALGO_STEPS = (0, 30, 45, 70, 4000)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    # Also on stderr: a caller that keeps only its end still sees why.
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def u32_max_abs_err(a, b) -> int:
    """Largest |a - b| between two int32-bit (u32) or narrow tensors."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return U32
    if a.numel() == 0:
        return 0
    mask = U32 if a.dtype == torch.int32 else (1 << (8 * a.element_size())) - 1
    da = a.to(torch.int64) & mask
    db = b.to(torch.int64) & mask
    return int((da - db).abs().max().item())


def time_ms(fn, reps: int = 20, inner: int = 50) -> float:
    """CUDA-event median milliseconds per call of fn()."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def device_samples(fn, iters: int = 20):
    """Milliseconds of device (kernel + copy + memset) time of each of
    `iters` calls of fn(), from every CUDA activity torch.profiler
    records; None when no capture of PROFILE_TRIES sees device activity.
    The activities are cut in time order into `iters` equal groups, one
    per call.  The profiler now and then drops activities, or all of
    them: where none was seen or their count does not divide, the
    capture is taken again (up to PROFILE_TRIES times), and after that
    every call gets the mean of the last capture that saw any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted(
            (ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda ev: ev.time_range.start,
        )
        us = [ev.time_range.elapsed_us() for ev in evs]
        if sum(us) <= 0:
            continue
        seen = us
        if len(us) % iters == 0:
            k = len(us) // iters
            return [sum(us[c * k : (c + 1) * k]) / 1e3 for c in range(iters)]
    return None if seen is None else [sum(seen) / iters / 1e3] * iters


def device_ms(fn, iters: int = 20):
    """Mean device milliseconds per call of fn() (device_samples)."""
    samples = device_samples(fn, iters)
    return None if samples is None else float(np.mean(samples))


def spread_us(samples) -> str:
    """'min / median / max us' of per-call device milliseconds."""
    lo, mid, hi = (q * 1e3 for q in np.percentile(samples, (0, 50, 100)))
    return f"{lo:.2f} / {mid:.2f} / {hi:.2f} us"


# -- phase 3: kernels against their plain versions ----------------------


def _table(torch, rng, ns, dev):
    start = rng.integers(0, 1000, ns, dtype=np.uint64).astype(np.uint32)
    hot = rng.choice(ns, min(ns, 512), replace=False)
    start[hot] = U32 - rng.integers(0, 8, len(hot)).astype(np.uint32)
    return torch.from_numpy(start.view(np.int32)).to(dev)


def _negate(rng, slots, live, ns):
    """Give about a third of the first `live` lanes their alias id - ns,
    which addresses the same slot (JAX's index semantics)."""
    slots = np.asarray(slots, np.int64).copy()
    flip = rng.random(live) < 0.35
    slots[:live][flip] -= ns
    return slots


def _packed(torch, rng, n, ns, dev, hot_slots, neg=False):
    pad = n // 4
    g = n - pad
    k = min(len(hot_slots), max(1, g // 8))  # lanes on near-u32-max slots
    rest = rng.choice(ns, 2 * g, replace=False)
    rest = rest[~np.isin(rest, hot_slots[:k])][: g - k]
    slots = np.concatenate(
        [np.asarray(hot_slots[:k], np.int64), rest, np.arange(ns, ns + pad)]
    )
    if neg:
        slots = _negate(rng, slots, g, ns)
    hits = rng.integers(0, 40, n).astype(np.uint32)
    hits[: max(1, g // 16)] = U32 - rng.integers(0, 3, max(1, g // 16)).astype(
        np.uint32
    )
    limits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    limits[g // 2 :] = rng.integers(1, 200, n - g // 2).astype(np.uint32)
    fresh = rng.random(n) < 0.2
    hits[g:], limits[g:], fresh[g:] = 0, 1, False
    pk = np.stack(
        [slots.astype(np.int32), hits.view(np.int32), limits.view(np.int32), fresh]
    ).astype(np.int32)
    return torch.from_numpy(pk).to(dev)


def _dup_lanes(torch, rng, n, ns, dev, distinct, neg=False):
    slots = rng.choice(ns, distinct, replace=False)[rng.integers(0, distinct, n)]
    slots[-max(1, n // 10) :] = ns + np.arange(max(1, n // 10))  # pads
    if neg:
        slots = _negate(rng, slots, n - max(1, n // 10), ns)
    hits = rng.integers(1, 4, n).astype(np.uint32)
    hits[: max(1, n // 20)] = U32 - rng.integers(0, 9, max(1, n // 20)).astype(
        np.uint32
    )
    fresh = rng.random(n) < 0.1
    return (
        torch.from_numpy(slots.astype(np.int32)).to(dev),
        torch.from_numpy(hits.view(np.int32)).to(dev),
        torch.from_numpy(fresh).to(dev),
    )


def check_kernels(torch, fw, prefix_cuda, prefix_plain, dev):
    """Every kernel vs its plain version; returns max |err| by kernel."""
    rng = np.random.default_rng(2024)
    err = {fw.K1: 0, prefix_cuda.KERNEL: 0, fw.K3_DECIDE: 0}

    def note(name, a, b, what):
        e = u32_max_abs_err(a, b)
        err[name] = max(err[name], e)
        if e != 0:
            fail(f"{name} disagrees with its plain version ({what}): max|err|={e}")

    cases = ((NUM_SLOTS, SIZES), (BIG_SLOTS, (4096,)))
    for neg, (ns, sizes) in itertools.product((False, True), cases):
        base = _table(torch, rng, ns, dev)
        hot = torch.nonzero((base.to(torch.int64) & U32) > U32 - 16).flatten()
        hot = hot.cpu().numpy()
        for n in sizes:
            for dt in ("", "uint8", "uint16"):
                pk = _packed(torch, rng, n, ns, dev, hot, neg)
                ck, cp = base.clone(), base.clone()
                out_k = fw.fw_unique_step(ck, pk, dt)
                out_p = fw._unique_step_plain(cp, pk, dt)
                what = f"n={n} ns={ns} dtype={dt!r} negative ids={neg}"
                note(fw.K1, out_k, out_p, "afters " + what)
                note(fw.K1, ck, cp, "table " + what)
            for distinct in (1, max(1, n // 8), n):
                slots, hits, fresh = _dup_lanes(torch, rng, n, ns, dev, distinct, neg)
                note(
                    prefix_cuda.KERNEL,
                    prefix_cuda.per_slot_inclusive_prefix_cuda(slots, hits),
                    prefix_plain(slots, hits),
                    f"n={n} distinct={distinct} negative ids={neg}",
                )
            if neg:
                continue  # the decision block takes no slot ids
            afters = torch.from_numpy(
                rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
            ).to(dev)
            hits = torch.from_numpy(
                rng.integers(0, 1 << 20, n).astype(np.uint32).view(np.int32)
            ).to(dev)
            limits = torch.from_numpy(
                rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
            ).to(dev)
            shadow = torch.from_numpy(rng.random(n) < 0.5).to(dev)
            for ratio in (0.8, 0.5):
                dk = fw.fw_decision_block(afters, hits, limits, shadow, ratio)
                dp = fw._decision_block_plain(afters, hits, limits, shadow, ratio)
                for f in dk._fields:
                    note(fw.K3_DECIDE, getattr(dk, f), getattr(dp, f), f"{f} n={n}")
    torch.cuda.synchronize()
    return err


def check_prefix(torch, prefix_cuda, prefix_plain, dev):
    """K2 against its plain version at the sizes its triangular tiling
    can get wrong (one lane, a tile and one either side, one lane past
    the largest bucket, 16384), with positive and negative ids, and on
    WRAP_*; returns max |err|."""
    rng = np.random.default_rng(2027)
    err = 0

    def note(a, b, what):
        nonlocal err
        e = u32_max_abs_err(a, b)
        err = max(err, e)
        if e != 0:
            fail(f"{prefix_cuda.KERNEL} disagrees ({what}): max|err|={e}")

    for neg, n in itertools.product((False, True), PREFIX_EDGE_SIZES):
        for distinct in (1, max(1, n // 8), n):
            slots, hits, _ = _dup_lanes(torch, rng, n, NUM_SLOTS, dev, distinct, neg)
            note(
                prefix_cuda.per_slot_inclusive_prefix_cuda(slots, hits),
                prefix_plain(slots, hits),
                f"n={n} distinct={distinct} negative ids={neg}",
            )
    slots = torch.tensor(WRAP_SLOTS, dtype=torch.int32, device=dev)
    hits = torch.from_numpy(np.array(WRAP_HITS, np.uint32).view(np.int32)).to(dev)
    want = torch.from_numpy(np.array(WRAP_WANT, np.uint32).view(np.int32)).to(dev)
    got = prefix_cuda.per_slot_inclusive_prefix_cuda(slots, hits)
    note(got, prefix_plain(slots, hits), "u32 wrap inside a segment, vs plain")
    note(got, want, "u32 wrap inside a segment, vs the running sum")
    torch.cuda.synchronize()
    return err


def _algo_state(torch, rng, algo, ns, pool, dev):
    """An algorithm bank's table: zero except the `pool` slots, whose
    state sits in the current, the adjacent and older windows (sliding
    window) or whose TAT lies around the clock (GCRA), some of it
    saturated at u32 max."""
    k = len(pool)
    if algo == "sw":
        state = np.zeros((3, ns), np.uint32)
        back = rng.choice([0, 60, 3600, 7200, 120], k).astype(np.uint32)
        state[0, pool] = ALGO_NOW - back
        state[1, pool] = rng.integers(0, 60, k)
        state[2, pool] = rng.integers(0, 60, k)
        sat = rng.random(k) < 0.15
        state[1, pool[sat]] = U32
        state[2, pool[rng.random(k) < 0.15]] = U32
    else:
        state = np.zeros((2, ns), np.uint32)
        state[0, pool] = ALGO_NOW + rng.integers(-200, 200, k)
        state[1, pool] = rng.integers(0, 1 << 32, k, dtype=np.uint64)
    return torch.from_numpy(state.view(np.int32)).to(dev)


def _algo_packed(torch, rng, n, ns, pool, dev):
    """int32[5, n] as the engine builds it: unique slots drawn from
    `pool` (so steps revisit slots), about a third as their alias id -
    ns, then distinct out-of-table pads (hits 0, limit 1, divider 1)."""
    pad = n // 4
    g = n - pad
    slots = _negate(
        rng, np.concatenate([rng.choice(pool, g, replace=False), ns + np.arange(pad)]), g, ns
    )
    hits = rng.integers(1, 40, n).astype(np.uint32)
    hits[: max(1, g // 16)] = U32 - rng.integers(0, 3, max(1, g // 16)).astype(np.uint32)
    limits = rng.integers(1, 200, n).astype(np.uint32)
    limits[rng.random(n) < 0.1] = 0
    limits[rng.random(n) < 0.1] = rng.integers(1 << 20, 1 << 32, dtype=np.uint64)
    fresh = rng.random(n) < 0.15
    divider = rng.choice([1, 60, 3600], n).astype(np.uint32)
    hits[g:], limits[g:], fresh[g:], divider[g:] = 0, 1, False, 1
    pk = np.stack(
        [slots.astype(np.int32), hits.view(np.int32), limits.view(np.int32),
         fresh.astype(np.int32), divider.view(np.int32)]
    )
    return torch.from_numpy(pk).to(dev)


def check_algorithms(torch, sw, gcra, kernels, dev):
    """K4 and K5 against their plain versions, several steps each with
    the clock advancing (ALGO_STEPS): the device form for N in SIZES at
    2^18 slots and 4096 at 2^24; the by-value form (host words, readback
    into mapped pinned memory) for N in LANES_SIZES at 2^18 and 2^24
    slots, also against the device form on a cloned state.  A pageable
    readback raises KernelError, one on the card ValueError, and the
    next launch still runs.  Returns max |err| by kernel."""
    rng = np.random.default_rng(2025)
    steps = {sw.K4: (sw.sw_serve_step, sw._sw_step_plain, "sw"),
             gcra.K5: (gcra.gcra_serve_step, gcra._gcra_step_plain, "gcra")}
    err = {name: 0 for name in (sw.K4, gcra.K5, sw.K4_LANES, gcra.K5_LANES)}

    def note(name, a, b, what):
        # On a's device: a state (up to 200 MB) never leaves the card.
        e = u32_max_abs_err(a, b.to(a.device))
        err[name] = max(err[name], e)
        if e != 0:
            fail(f"{name} disagrees ({what}): max|err|={e}")

    for name, (kernel, plain, algo) in steps.items():
        for ns, sizes in ((ALGO_SLOTS, SIZES), (BIG_SLOTS, (4096,))):
            for n in sizes:
                pool = rng.choice(ns, 2 * n, replace=False)
                sk = _algo_state(torch, rng, algo, ns, pool, dev)
                sp = sk.clone()
                for dt in ALGO_STEPS:
                    now = ALGO_NOW + dt
                    pk = _algo_packed(torch, rng, n, ns, pool, dev)
                    what = f"n={n} ns={ns} now=+{dt}, vs its plain version"
                    note(name, kernel(sk, pk, now), plain(sp, pk, now), "out " + what)
                    note(name, sk, sp, "state " + what)

    by_value = {
        sw.K4_LANES: (sw.sw_serve_step_lanes, sw.sw_serve_step, sw._sw_step_plain, "sw", (2,)),
        gcra.K5_LANES: (
            gcra.gcra_serve_step_lanes, gcra.gcra_serve_step, gcra._gcra_step_plain, "gcra", ()
        ),
    }
    for name, (lanes, device, plain, algo, rows) in by_value.items():
        for ns in (ALGO_SLOTS, BIG_SLOTS):
            pool = rng.choice(ns, 2 * max(LANES_SIZES), replace=False)
            base = _algo_state(torch, rng, algo, ns, pool, dev)
            for n in LANES_SIZES:
                sl, sd, sp = base.clone(), base.clone(), base.clone()
                for dt in ALGO_STEPS:
                    now = ALGO_NOW + dt
                    pk = _algo_packed(torch, rng, n, ns, pool, dev)
                    out = torch.empty((*rows, n), dtype=torch.int32, pin_memory=True)
                    lanes(sl, _pinned(torch, pk), now, out)
                    want_device = device(sd, pk, now)
                    want = plain(sp, pk, now)
                    torch.cuda.synchronize()
                    what = f"n={n} ns={ns} now=+{dt}"
                    note(name, out, want, "out vs its plain version " + what)
                    note(name, sl, sp, "state vs its plain version " + what)
                    note(name, out, want_device, "out vs its device form " + what)
                    note(name, sl, sd, "state vs its device form " + what)

        # No fallback: a pageable readback has no device alias and raises;
        # one on the card is refused before the launch.
        state = torch.zeros(({"sw": 3, "gcra": 2}[algo], 64), dtype=torch.int32, device=dev)
        words = torch.zeros((5, 8), dtype=torch.int32)
        words[0] = 64 + torch.arange(8)  # distinct pads past the table
        words[4] = 1
        try:
            lanes(state, words, ALGO_NOW, torch.zeros((*rows, 8), dtype=torch.int32))
            fail(f"{name}: a pageable readback buffer did not raise KernelError")
        except kernels.KernelError:
            pass
        try:
            lanes(state, words, ALGO_NOW, torch.zeros((*rows, 8), dtype=torch.int32, device=dev))
            fail(f"{name}: a readback buffer on the card did not raise ValueError")
        except ValueError:
            pass
        out = torch.full((*rows, 8), 7, dtype=torch.int32, pin_memory=True)
        lanes(state, words, ALGO_NOW, out)
        torch.cuda.synchronize()
        if (out == 7).all():
            fail(f"{name}: the launch after a refused readback buffer did not run")
    torch.cuda.synchronize()
    return err


def _banked_table(torch, rng, ns, dev):
    """A (BANKS, ns / BANKS) table like _table's, and the GLOBAL ids of
    its near-u32-max slots (bank b position l holds slot l * BANKS + b)."""
    spb = ns // BANKS
    table = _table(torch, rng, ns, dev).view(BANKS, spb)
    flat = torch.nonzero((table.flatten().to(torch.int64) & U32) > U32 - 16).flatten()
    flat = flat.cpu().numpy()
    return table, (flat % spb) * BANKS + flat // spb


def _routed(torch, rng, n, ns, dev, hot, skew):
    """int32[BANKS, 4, cap] as the sharded engine routes n lanes: 3/4
    live distinct slots (some near u32 max, with large hits), spread
    over the banks (uniform) or all in bank 0 (skew), as LOCAL ids --
    about a third as their alias id - spb -- then padding ids spb + i up
    to the bucketed cap; returns (packed, live lane count)."""
    spb = ns // BANKS
    g = n - n // 4
    if skew:
        hot = hot[hot % BANKS == 0]
    k = min(len(hot), max(1, g // 8))
    pool = rng.choice(spb, 2 * g, replace=False) * BANKS if skew else rng.choice(ns, 2 * g, replace=False)
    rest = pool[~np.isin(pool, hot[:k])][: g - k]
    slots = np.concatenate([np.asarray(hot[:k], np.int64), rest])
    bank = slots % BANKS
    local = slots // BANKS
    local[rng.random(g) < 0.35] -= spb
    order = np.argsort(bank, kind="stable")
    bank, local = bank[order], local[order]
    per_bank = np.bincount(bank, minlength=BANKS)
    pos = np.arange(g) - np.concatenate([[0], np.cumsum(per_bank)])[bank]
    cap = max(8, 1 << int(per_bank.max() - 1).bit_length())
    hits = rng.integers(0, 40, g).astype(np.uint32)
    hits[order < k] = U32 - rng.integers(0, 3, int((order < k).sum())).astype(np.uint32)
    pk = np.zeros((BANKS, 4, cap), np.int32)
    pk[:, 0] = spb + np.arange(cap)
    pk[:, 2] = 1
    pk[bank, 0, pos] = local
    pk[bank, 1, pos] = hits.view(np.int32)
    pk[bank, 2, pos] = rng.integers(1, 200, g).astype(np.int32)
    pk[bank, 3, pos] = rng.random(g) < 0.2
    return torch.from_numpy(pk).to(dev), g


def check_sharded(torch, sh, dev):
    """K6 against its plain version over BANKS banks (K7 is in
    check_general_step); returns max |err| by kernel."""
    rng = np.random.default_rng(2026)
    err = {sh.K6: 0}

    def note(name, a, b, what):
        e = u32_max_abs_err(a, b)
        err[name] = max(err[name], e)
        if e != 0:
            fail(f"{name} disagrees with its plain version ({what}): max|err|={e}")

    for ns, sizes in ((NUM_SLOTS, SIZES), (BIG_SLOTS, (4096,))):
        base, hot = _banked_table(torch, rng, ns, dev)
        for n in sizes:
            for skew, dt in itertools.product((False, True), ("", "uint8", "uint16")):
                pk, _ = _routed(torch, rng, n, ns, dev, hot, skew)
                ck, cp = base.clone(), base.clone()
                what = f"n={n} ns={ns} skew={skew} dtype={dt!r}"
                note(sh.K6, sh.sharded_routed_step(ck, pk, dt), sh._routed_step_plain(cp, pk, dt),
                     "afters " + what)
                note(sh.K6, ck, cp, "table " + what)
    torch.cuda.synchronize()
    return err


def _general_batches(torch, rng, n, ns, hot, dev):
    """(what, slots, hits, fresh) on `dev` for the fused general step at
    n lanes: duplicates over 1, n/8 and n distinct slots with positive
    and with negative ids (_dup_lanes: pads past the table, hits near
    u32 max); every lane on one near-u32-max slot, fresh only on the
    last; WRAP_HITS on one slot among duplicates (its running sum wraps
    u32 inside the segment); ids -1 and ns - 1 beside each other (one
    table: one counter, two prefixes; banks: -1 is out of the table)."""
    for distinct, neg in itertools.product((1, max(1, n // 8), n), (False, True)):
        yield (f"d={distinct} negative ids={neg}",
               *_dup_lanes(torch, rng, n, ns, dev, distinct, neg))

    def lanes(slots, hits, fresh):
        return (
            torch.from_numpy(np.asarray(slots, np.int64).astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(hits, np.uint64).astype(np.uint32).view(np.int32)).to(dev),
            torch.from_numpy(np.asarray(fresh, bool)).to(dev),
        )

    small = rng.integers(1, 4, n)
    last = np.arange(n) == n - 1
    yield ("one slot, fresh on its last lane", *lanes(np.full(n, hot[0]), small, last))
    slots = rng.choice(ns, max(1, n // 8), replace=False)[rng.integers(0, max(1, n // 8), n)]
    wrap = np.arange(n) % max(1, n // len(WRAP_HITS)) == 0
    slots[wrap] = hot[1]
    hits = small.astype(np.uint64)
    hits[np.nonzero(wrap)[0]] = np.resize(WRAP_HITS, int(wrap.sum()))
    yield ("u32 wrap inside a segment", *lanes(slots, hits, rng.random(n) < 0.1))
    yield ("-1 beside ns - 1",
           *lanes(rng.choice([-1, ns - 1, int(hot[2])], n), small, rng.random(n) < 0.1))


def check_general_step(torch, fw, sh, dev):
    """The fused general step (one cooperative launch: K3 on one table,
    K7 on BANKS banks) against its plain versions in every epilogue --
    the raw afters, the narrow u8 / u16 readback and the decision block
    -- at 2^20 and 2^24 slots, for N in SIZES + PREFIX_EDGE_SIZES, on
    _general_batches; limits small and near u32 max (the readback cap
    wraps), shadow on about a third of the lanes.  Returns max |err| by
    kernel."""
    rng = np.random.default_rng(2029)
    err = {fw.K3_UPDATE: 0, fw.K3_STEP: 0, sh.K7: 0, sh.K7_STEP: 0}

    def note(name, a, b, what):
        e = u32_max_abs_err(a, b)
        err[name] = max(err[name], e)
        if e != 0:
            fail(f"{name} disagrees with its plain version ({what}): max|err|={e}")

    tables = {
        "one table": (fw.fw_general_update, fw._update_plain, fw.fw_general_step,
                      fw.K3_UPDATE, fw.K3_STEP),
        f"{BANKS} banks": (sh.sharded_general_update, sh._general_update_plain,
                           sh.sharded_general_step, sh.K7, sh.K7_STEP),
    }
    for ns in (NUM_SLOTS, BIG_SLOTS):
        one = _table(torch, rng, ns, dev)
        hot = torch.nonzero((one.to(torch.int64) & U32) > U32 - 16).flatten().cpu().numpy()
        bases = {"one table": (one, hot), f"{BANKS} banks": _banked_table(torch, rng, ns, dev)}
        for (label, (update, plain, step, k_update, k_step)), n in itertools.product(
            tables.items(), SIZES + PREFIX_EDGE_SIZES
        ):
            base, hot = bases[label]
            limits = rng.integers(1, 300, n).astype(np.uint32)
            limits[rng.random(n) < 0.2] = U32 - rng.integers(0, 4, 1).astype(np.uint32)
            limits = torch.from_numpy(limits.view(np.int32)).to(dev)
            shadow = torch.from_numpy(rng.random(n) < 0.3).to(dev)
            for what, slots, hits, fresh in _general_batches(torch, rng, n, ns, hot, dev):
                what = f"{label} n={n} ns={ns} {what}"
                for dt in ("", "uint8", "uint16"):
                    ck, cp = base.clone(), base.clone()
                    note(k_update, update(ck, slots, hits, fresh, limits, dt),
                         plain(cp, slots, hits, fresh, limits, dt), f"out {dt!r} {what}")
                    note(k_update, ck, cp, f"table {dt!r} {what}")
                ck, cp = base.clone(), base.clone()
                got = step(ck, slots, hits, fresh, limits, shadow, 0.8)
                want = fw._decision_block_plain(
                    plain(cp, slots, hits, fresh, None, ""), hits, limits, shadow, 0.8
                )
                for f in got._fields:
                    note(k_step, getattr(got, f), getattr(want, f), f"decide {f} {what}")
                note(k_step, ck, cp, f"decide table {what}")
    torch.cuda.synchronize()
    return err


def _pinned(torch, t):
    """A pinned host copy of tensor `t`."""
    return t.cpu().pin_memory()


def check_served_forms(torch, fw, sh, kernels, dev):
    """K1 and K6 in both forms, bit for bit against their plain versions:
    the by-value form (host words; readback into mapped pinned memory)
    for N in LANES_SIZES, the device form for N in
    DEVICE_FORM_SIZES, at 2^20 and 2^24 slots, three readback types, with
    fresh, padding, saturated, negative and out-of-table lanes; K6 over
    BANKS banks with uniform and all-one-bank routing, by value wherever
    the routed shape fits.  Also: a slice of pinned memory has its device
    alias at the same offset, and an unpinned `out` raises KernelError
    (the next launch still succeeds), and a readback on the card raises
    ValueError.  Returns (max |err| by kernel, the number of K6 by-value
    cases)."""
    rng = np.random.default_rng(2028)
    err = {fw.K1: 0, fw.K1_LANES: 0, sh.K6: 0, sh.K6_LANES: 0}
    k6_lanes_cases = 0

    def note(name, a, b, what):
        # On a's device: a table (up to 64 MB) never leaves the card.
        e = u32_max_abs_err(a, b.to(a.device))
        err[name] = max(err[name], e)
        if e != 0:
            fail(f"{name} disagrees with its plain version ({what}): max|err|={e}")

    def by_value(kernel, name, counts, pk, dt, plain_out, plain_table, what):
        words = _pinned(torch, pk)
        shape = tuple(pk.shape[:-2]) + (pk.shape[-1],)
        out = torch.empty(shape, dtype=fw.OUT_DTYPES[dt], pin_memory=True)
        ck = counts.clone()
        kernel(ck, words, out, dt)
        torch.cuda.synchronize()
        note(name, out, plain_out, "out " + what)
        note(name, ck, plain_table, "table " + what)

    for ns in (NUM_SLOTS, BIG_SLOTS):
        base = _table(torch, rng, ns, dev)
        hot = torch.nonzero((base.to(torch.int64) & U32) > U32 - 16).flatten().cpu().numpy()
        for n, dt in itertools.product(LANES_SIZES + DEVICE_FORM_SIZES, ("", "uint8", "uint16")):
            pk = _packed(torch, rng, n, ns, dev, hot, neg=True)
            if n >= 4:
                pk[0, n // 2] = -ns - 1 - n  # out of the table below -ns
            cp = base.clone()
            want = fw._unique_step_plain(cp, pk, dt)
            what = f"n={n} ns={ns} dtype={dt!r}"
            if fw.lanes_by_value(1, n):
                by_value(fw.fw_unique_step_lanes, fw.K1_LANES, base, pk, dt, want, cp, what)
            else:
                ck = base.clone()
                note(fw.K1, fw.fw_unique_step(ck, pk, dt), want, "afters " + what)
                note(fw.K1, ck, cp, "table " + what)
        bt, bhot = _banked_table(torch, rng, ns, dev)
        for n, skew, dt in itertools.product(
            LANES_SIZES + DEVICE_FORM_SIZES, (False, True), ("", "uint8", "uint16")
        ):
            pk, _ = _routed(torch, rng, n, ns, dev, bhot, skew)
            cp = bt.clone()
            want = sh._routed_step_plain(cp, pk, dt)
            what = f"n={n} cap={pk.shape[2]} ns={ns} skew={skew} dtype={dt!r}"
            if fw.lanes_by_value(BANKS, pk.shape[2]):
                k6_lanes_cases += 1
                by_value(sh.sharded_routed_step_lanes, sh.K6_LANES, bt, pk, dt, want, cp, what)
            ck = bt.clone()
            note(sh.K6, sh.sharded_routed_step(ck, pk, dt), want, "afters " + what)
            note(sh.K6, ck, cp, "table " + what)

    # The readback's device alias: a pinned slice keeps its offset.
    buf = torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True)
    base_alias = kernels.mapped_alias(buf.data_ptr())
    for off in (0, 1, 13, 4096):
        if kernels.mapped_alias(buf[off:].data_ptr()) != base_alias + off:
            fail(f"pinned slice at offset {off} has no device alias at the same offset")
    # No fallback: pageable `out` has no device alias, and raises.
    counts = torch.zeros(64, dtype=torch.int32, device=dev)
    words = torch.zeros((4, 8), dtype=torch.int32)
    try:
        fw.fw_unique_step_lanes(counts, words, torch.zeros(8, dtype=torch.int32))
        fail("a pageable readback buffer did not raise KernelError")
    except kernels.KernelError:
        pass
    try:
        fw.fw_unique_step_lanes(counts, words, torch.zeros(8, dtype=torch.int32, device=dev))
        fail("a readback buffer on the card did not raise ValueError")
    except ValueError:
        pass
    out = torch.full((8,), 7, dtype=torch.int32, pin_memory=True)
    fw.fw_unique_step_lanes(counts, words, out)
    torch.cuda.synchronize()
    if out.any():
        fail("the launch after a refused readback buffer did not run")
    return err, k6_lanes_cases


def bound(nbytes, ops):
    """(ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the 32-bit peak."""
    b_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def prefix_ops(n: int) -> int:
    """The least work of the per-slot prefix: a sort of the lanes by slot
    and a segmented sum, n log2 n compares and n adds (not the N^2/2
    compare-adds of K2's tiled pass)."""
    return n * (n - 1).bit_length() + n


def general_step_work(n: int, distinct: int):
    """(bytes, operations) of the general step with its decision block:
    slot, hits, fresh, limit and shadow in (14 B a lane), the gather and
    scatter of each distinct slot, the nine fields out (33 B a lane); the
    prefix at its least work, the update's and the decisions' arithmetic."""
    return 14 * n + 8 * distinct + 33 * n, prefix_ops(n) + 4 * n + 30 * n


def time_kernels(torch, fw, prefix_cuda, prefix_plain, sw, gcra, sh, dev):
    """Median ms of each kernel and its plain version at 4096 lanes and
    2^20 slots (K4, K5: 2^18, the bank default; the by-value forms of K1,
    K4, K5 and K6 at the widths they serve, 8 lanes and 8 banks x cap
    8), plus the bound of each (larger of bytes over HBM rate and
    operations over the 32-bit peak), from this run's inputs.  Also
    returns, as `extra`: the launch floor (a one-element in-place torch
    add, which the port never calls), the per-call device times of every
    kernel over 50 calls (for their spread), K1, K4, K5 and K6 at the
    served widths in the other form and by value at 128 lanes, each with
    its bound, and K2 at 16384 lanes."""
    rng = np.random.default_rng(7)
    n, ns = 4096, NUM_SLOTS
    table = _table(torch, rng, ns, dev)
    pk = _packed(torch, rng, n, ns, dev, np.zeros(0, np.int64))
    slots, hits, fresh = _dup_lanes(torch, rng, n, ns, dev, n // 2)
    live = slots[(slots >= 0) & (slots < ns)]
    distinct = int(torch.unique(live).numel())
    n_live_k1 = int(((pk[0] >= 0) & (pk[0] < ns)).sum().item())
    afters = fw.fw_general_update(table.clone(), slots, hits, fresh)
    limits = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32)).to(dev)
    shadow = torch.zeros(n, dtype=torch.bool, device=dev)
    t1, t2 = table.clone(), table.clone()
    rows = {}
    calls = {}
    samples = {}

    def row(name, k, p, nbytes, ops):
        call_ms, plain_call_ms = time_ms(k), time_ms(p, reps=5, inner=5)
        # 50 calls, kept for the kernel's spread.
        per_call = device_samples(k, iters=50)
        if per_call is not None:
            samples[name] = per_call
        dev_ms = None if per_call is None else float(np.mean(per_call))
        plain_dev_ms = device_ms(p, iters=5)
        bound_ms, bound_by = bound(nbytes, ops)
        rows[name] = dict(
            # Device time from the profiler; the CUDA-event time of
            # back-to-back calls (host enqueue included) where the
            # profiler saw nothing.
            ms=dev_ms if dev_ms is not None else call_ms,
            plain_ms=plain_dev_ms if plain_dev_ms is not None else plain_call_ms,
            bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None,
        )
        calls[name] = (call_ms, plain_call_ms)

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = device_samples(lambda: one.add_(1), iters=50)
    row(
        fw.K1,
        lambda: fw.fw_unique_step(t1, pk, ""),
        lambda: fw._unique_step_plain(t2, pk, ""),
        16 * n + 8 * n_live_k1 + 4 * n,  # packed in, gather+scatter, afters out
        8 * n,
    )
    # K1 at the served width, 8 lanes: the by-value form (its row) and,
    # for the spread only, the device form and the by-value form at 128.
    pk8 = _packed(torch, rng, 8, ns, dev, np.zeros(0, np.int64))
    words8, out8 = _pinned(torch, pk8), torch.empty(8, dtype=torch.int32, pin_memory=True)
    pk128 = pk[:, :128].contiguous()
    words128 = _pinned(torch, pk128)
    out128 = torch.empty(128, dtype=torch.int32, pin_memory=True)

    def k1_bytes(p):
        """Lanes in, gather + scatter of the live ones, afters out."""
        n_live = int(((p[0] >= 0) & (p[0] < ns)).sum().item())
        return 16 * p.shape[1] + 8 * n_live + 4 * p.shape[1]

    row(
        fw.K1_LANES,
        lambda: fw.fw_unique_step_lanes(t1, words8, out8, ""),
        lambda: fw._unique_step_plain(t2, pk8, ""),
        k1_bytes(pk8),
        8 * 8,
    )
    # The serving kernels at the served widths, for their spread: name ->
    # (per-call device ms over 50 calls, bound at that width).
    served = {
        f"{fw.K1} (device form) at 8 lanes": (
            device_samples(lambda: fw.fw_unique_step(t1, pk8, ""), iters=50),
            bound(k1_bytes(pk8), 8 * 8),
        ),
        f"{fw.K1_LANES} at 128 lanes": (
            device_samples(lambda: fw.fw_unique_step_lanes(t1, words128, out128, ""), iters=50),
            bound(k1_bytes(pk128), 8 * 128),
        ),
    }
    row(
        prefix_cuda.KERNEL,
        lambda: prefix_cuda.per_slot_inclusive_prefix_cuda(slots, hits),
        lambda: prefix_plain(slots, hits),
        8 * n + 4 * n,
        prefix_ops(n),
    )
    big = 16384
    bslots, bhits, _ = _dup_lanes(torch, rng, big, ns, dev, big // 2)
    big_samples = device_samples(
        lambda: prefix_cuda.per_slot_inclusive_prefix_cuda(bslots, bhits), iters=50
    )
    prefix_big = dict(
        n=big,
        samples=big_samples,
        plain_ms=device_ms(lambda: prefix_plain(bslots, bhits), iters=5),
        bound=bound(8 * big + 4 * big, prefix_ops(big)),
    )
    row(
        fw.K3_UPDATE,
        lambda: fw.fw_general_update(t1, slots, hits, fresh),
        lambda: fw._update_plain(t2, slots, hits, fresh),
        9 * n + 8 * distinct + 4 * n,
        prefix_ops(n) + 4 * n,
    )
    row(
        fw.K3_DECIDE,
        lambda: fw.fw_decision_block(afters, hits, limits, shadow, 0.8),
        lambda: fw._decision_block_plain(afters, hits, limits, shadow, 0.8),
        13 * n + 33 * n,
        30 * n,
    )
    row(
        fw.K3_STEP,
        lambda: fw.fw_general_step(t1, slots, hits, fresh, limits, shadow, 0.8),
        lambda: fw._decision_block_plain(
            fw._update_plain(t2, slots, hits, fresh), hits, limits, shadow, 0.8
        ),
        *general_step_work(n, distinct),
    )

    ans = ALGO_SLOTS
    pool = rng.choice(ans, 2 * n, replace=False)

    def sw_bound(p):
        """K4: packed rows slot, hits, fresh, divider (never the limit
        row) in, gather and scatter of the live lanes, readback out;
        ~20 integer and f32 operations a lane (csrc/algorithms.cu)."""
        w = p.shape[1]
        live = int(((p[0] >= -ans) & (p[0] < ans)).sum().item())
        return 16 * w + 12 * live + 12 * live + 8 * w, 20 * w

    def gcra_bound(p):
        """K5: five rows in, the gather of the live lanes that are not
        fresh, the scatter of the live ones, budgets out; ~40
        operations a lane."""
        w = p.shape[1]
        in_table = (p[0] >= -ans) & (p[0] < ans)
        live = int(in_table.sum().item())
        kept = int((in_table & (p[3] == 0)).sum().item())
        return 20 * w + 8 * kept + 8 * live + 4 * w, 40 * w

    apk = _algo_packed(torch, rng, n, ans, pool, dev)
    s1 = _algo_state(torch, rng, "sw", ans, pool, dev)
    s2 = s1.clone()
    row(
        sw.K4,
        lambda: sw.sw_serve_step(s1, apk, ALGO_NOW),
        lambda: sw._sw_step_plain(s2, apk, ALGO_NOW),
        *sw_bound(apk),
    )
    g1 = _algo_state(torch, rng, "gcra", ans, pool, dev)
    g2 = g1.clone()
    row(
        gcra.K5,
        lambda: gcra.gcra_serve_step(g1, apk, ALGO_NOW),
        lambda: gcra._gcra_step_plain(g2, apk, ALGO_NOW),
        *gcra_bound(apk),
    )
    # K4 and K5 at the served widths: by value at 8 lanes (their rows)
    # and 128, the device form at 8.
    apk8, apk128 = (_algo_packed(torch, rng, w, ans, pool, dev) for w in (8, 128))
    awords8, awords128 = _pinned(torch, apk8), _pinned(torch, apk128)
    sw_out = {w: torch.empty((2, w), dtype=torch.int32, pin_memory=True) for w in (8, 128)}
    g_out = {w: torch.empty(w, dtype=torch.int32, pin_memory=True) for w in (8, 128)}
    row(
        sw.K4_LANES,
        lambda: sw.sw_serve_step_lanes(s1, awords8, ALGO_NOW, sw_out[8]),
        lambda: sw._sw_step_plain(s2, apk8, ALGO_NOW),
        *sw_bound(apk8),
    )
    row(
        gcra.K5_LANES,
        lambda: gcra.gcra_serve_step_lanes(g1, awords8, ALGO_NOW, g_out[8]),
        lambda: gcra._gcra_step_plain(g2, apk8, ALGO_NOW),
        *gcra_bound(apk8),
    )
    served[f"{sw.K4} (device form) at 8 lanes"] = (
        device_samples(lambda: sw.sw_serve_step(s1, apk8, ALGO_NOW), iters=50),
        bound(*sw_bound(apk8)),
    )
    served[f"{sw.K4_LANES} at 128 lanes"] = (
        device_samples(
            lambda: sw.sw_serve_step_lanes(s1, awords128, ALGO_NOW, sw_out[128]), iters=50
        ),
        bound(*sw_bound(apk128)),
    )
    served[f"{gcra.K5} (device form) at 8 lanes"] = (
        device_samples(lambda: gcra.gcra_serve_step(g1, apk8, ALGO_NOW), iters=50),
        bound(*gcra_bound(apk8)),
    )
    served[f"{gcra.K5_LANES} at 128 lanes"] = (
        device_samples(
            lambda: gcra.gcra_serve_step_lanes(g1, awords128, ALGO_NOW, g_out[128]), iters=50
        ),
        bound(*gcra_bound(apk128)),
    )

    # The sharded kernels over BANKS banks of a 2^20-slot table: K6 on
    # uniformly routed lanes, K7 on the same duplicate lanes as K3.
    bt, hot = _banked_table(torch, rng, ns, dev)
    rpk, r_live = _routed(torch, rng, n, ns, dev, hot, skew=False)
    routed = rpk.shape[0] * rpk.shape[2]  # BANKS x cap, padding included
    b1, b2 = bt.clone(), bt.clone()
    row(
        sh.K6,
        lambda: sh.sharded_routed_step(b1, rpk, ""),
        lambda: sh._routed_step_plain(b2, rpk, ""),
        # packed in and afters out for every routed lane, padding
        # included; gather + scatter for the live ones
        16 * routed + 8 * r_live + 4 * routed,
        8 * routed,
    )
    # K6 at the served width, 8 banks x cap 8: the by-value form's row,
    # and the device form for the spread.
    rpk8, r_live8 = _routed(torch, rng, 8, ns, dev, hot, skew=False)
    rwords8 = _pinned(torch, rpk8)
    rout8 = torch.empty(tuple(rpk8.shape[::2]), dtype=torch.int32, pin_memory=True)
    routed8 = rpk8.shape[0] * rpk8.shape[2]
    row(
        sh.K6_LANES,
        lambda: sh.sharded_routed_step_lanes(b1, rwords8, rout8, ""),
        lambda: sh._routed_step_plain(b2, rpk8, ""),
        16 * routed8 + 8 * r_live8 + 4 * routed8,
        8 * routed8,
    )
    served[f"{sh.K6} (device form) at {BANKS} banks x cap {rpk8.shape[2]}"] = (
        device_samples(lambda: sh.sharded_routed_step(b1, rpk8, ""), iters=50),
        bound(16 * routed8 + 8 * r_live8 + 4 * routed8, 8 * routed8),
    )
    row(
        sh.K7,
        lambda: sh.sharded_general_update(b1, slots, hits, fresh),
        lambda: sh._general_update_plain(b2, slots, hits, fresh, None, ""),
        9 * n + 8 * distinct + 4 * n,  # the same work as K3's update
        prefix_ops(n) + 4 * n,
    )
    row(
        sh.K7_STEP,
        lambda: sh.sharded_general_step(b1, slots, hits, fresh, limits, shadow, 0.8),
        lambda: fw._decision_block_plain(
            sh._general_update_plain(b2, slots, hits, fresh, None, ""), hits, limits, shadow, 0.8
        ),
        *general_step_work(n, distinct),
    )
    return rows, calls, dict(floor=floor, samples=samples, served=served, prefix_big=prefix_big)


# -- the served chunk ------------------------------------------------------


def served_chunks(torch, sh, eng, sw, gcra, dev, n=SERVED_CHUNKS):
    """Drive engine._device_submit + step_complete for one chunk of 1, 8
    and 13 distinct in-table lanes (hits 0, so every chunk answers the
    same: all OK, and on the fixed-window engines afters 0), on one table
    and on BANKS banks of 2^20 slots, and on a sliding-window and a GCRA
    table of 2^18 slots (dividers of 60 s in the dedup, the clock at
    ALGO_NOW), `n` chunks each in two passes.  The first runs under
    torch.profiler (device activities only); a marker kernel on the
    engine stream brackets it, so its activities split into chunks.  The
    second runs without the profiler and times the host microseconds of
    submit + complete: the profiler adds a callback to every CUDA runtime
    call, so a profiled host time would count it too.  Takes the port's
    modules `sh` (parallel.sharded), `eng` (backends.engine), `sw`
    (models.sliding_window) and `gcra` (models.gcra) as arguments, so
    that scripts/torch_served_chunk.py can drive another checkout's
    engines with it.  Returns {(engine, lanes): dict(activities,
    memcpys, busy_us, span_us, host_us)}, each a list with one entry per
    chunk."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    marker = torch.zeros(1, dtype=torch.int32, device=dev)

    def is_marker(ev):
        # A chunk makes memcpys and K1 / K6 (unique_step_kernel,
        # unique_step_lanes_kernel) or K4 / K5 (sw_serve_step*,
        # gcra_serve_step*) only; the marker is an add.
        return not (
            "unique_step" in ev.name or "serve_step" in ev.name or ev.name.startswith("Memcpy")
        )

    engines = {
        "one table": eng.CounterEngine(num_slots=NUM_SLOTS, device=dev, native_table=False),
        f"{BANKS} banks": sh.ShardedCounterEngine(
            sh.make_mesh(BANKS, dev), num_slots=NUM_SLOTS, native_table=False
        ),
        "sliding window": eng.CounterEngine(
            device=dev, model=sw.SlidingWindowModel(ALGO_SLOTS, device=dev)
        ),
        "GCRA": eng.CounterEngine(device=dev, model=gcra.GcraModel(ALGO_SLOTS, device=dev)),
    }
    results = {}
    for (label, engine), width in itertools.product(engines.items(), SERVED_WIDTHS):
        # Distinct slots 7 apart: spread over the banks, all in the table.
        slots = (np.arange(width, dtype=np.int32) * 7 + 11).astype(np.int32)
        hits = np.zeros(width, np.uint32)
        limits = np.full(width, 250, np.uint32)
        shadow = np.zeros(width, bool)
        generic = engine._generic
        now = ALGO_NOW if generic else 0
        dividers = np.full(width, 60, np.uint32) if generic else None
        dedup = eng._dedup_chunk(slots, hits, limits, np.zeros(width, bool), dividers)

        def chunk():
            handle, reassemble = engine._device_submit(dedup, now)
            d = engine.step_complete(
                (hits, limits, shadow, [(handle, 0, width, dedup, reassemble)], now)
            )
            if (d.codes != 1).any() or (not generic and d.afters.any()):
                fail(f"served chunk answered wrong ({label}, {width} lanes)")

        def mark():
            with engine._on_stream():
                marker.add_(1)
            engine._stream.synchronize()

        def measure():
            """One profiled pass: its stats, or (None, why) where the
            capture does not split into chunks."""
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mark()
                for _ in range(n):
                    chunk()
                mark()
                torch.cuda.synchronize()
            evs = sorted(
                (ev for ev in prof.events() if ev.device_type == cuda),
                key=lambda ev: ev.time_range.start,
            )
            marks = [i for i, ev in enumerate(evs) if is_marker(ev)]
            if len(marks) != 2:
                return None, f"{len(marks)} markers among {len(evs)} device activities"
            seg = evs[marks[0] + 1 : marks[1]]
            if len(seg) % n:
                return None, f"{len(seg)} device activities do not split into {n} chunks"
            k = len(seg) // n
            st = dict(activities=[], memcpys=[], busy_us=[], span_us=[])
            for c in range(n):
                part = seg[c * k : (c + 1) * k]
                st["activities"].append(k)
                st["memcpys"].append(sum(ev.name.startswith("Memcpy") for ev in part))
                st["busy_us"].append(sum(ev.time_range.elapsed_us() for ev in part))
                st["span_us"].append(part[-1].time_range.end - part[0].time_range.start)
            return st, None

        for _ in range(3):  # warm: builds, staging buffers, first launches
            chunk()
        for _ in range(PROFILE_TRIES):  # again where the profiler dropped some
            stats, why = measure()
            if stats is not None:
                break
        else:
            fail(f"served chunk ({label}, {width} lanes): {why}")
        host_us = []
        for _ in range(n):
            t0 = time.perf_counter()
            chunk()
            host_us.append((time.perf_counter() - t0) * 1e6)
        stats["host_us"] = host_us
        results[(label, width)] = stats
    return results


def served_chunk_line(label, width, st) -> str:
    """One served_chunks result as a line of text."""
    return (
        f"served chunk, {label}, {width} lanes: "
        f"{int(np.median(st['activities']))} device activities "
        f"({int(np.median(st['memcpys']))} memcpy), device busy "
        f"{np.median(st['busy_us']):.2f} us, span "
        f"{spread_us(np.divide(st['span_us'], 1e3))} (profiled); host submit+complete "
        f"{spread_us(np.divide(st['host_us'], 1e3))} (unprofiled; min / median / max "
        f"over {len(st['host_us'])} chunks each)"
    )


# -- phase 4: the flagship forward step ---------------------------------


def graft_batch():
    """__graft_entry__.entry()'s batch, rebuilt in numpy."""
    rng = np.random.default_rng(0)
    n = 4096
    return dict(
        slots=rng.integers(0, NUM_SLOTS, n).astype(np.int32),
        hits=rng.integers(1, 4, n).astype(np.uint32),
        limits=rng.integers(1, 1000, n).astype(np.uint32),
        fresh=rng.random(n) < 0.1,
        shadow=np.zeros(n, dtype=bool),
    )


def graft_device_batch(torch, fw, dev):
    """graft_batch() and the same batch as a DeviceBatch on `dev`."""
    raw = graft_batch()
    return raw, fw.DeviceBatch(
        slots=torch.from_numpy(raw["slots"]).to(dev),
        hits=torch.from_numpy(raw["hits"].view(np.int32)).to(dev),
        limits=torch.from_numpy(raw["limits"].view(np.int32)).to(dev),
        fresh=torch.from_numpy(raw["fresh"]).to(dev),
        shadow=torch.from_numpy(raw["shadow"]).to(dev),
    )


# Forward steps per profiler capture.
STEP_CAPTURE = 20


def step_activities(torch, step, iters=STEP_CAPTURE):
    """Device activities of `iters` calls of step() under torch.profiler
    (device activities only): dict(activities, memsets, memcpys per
    call, names, busy_us per call).  A capture whose activities do not
    split into its calls is taken again (up to PROFILE_TRIES times)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        if evs and len(evs) % iters == 0:
            break
    return dict(
        activities=len(evs) / iters,
        memsets=sum(ev.name.startswith("Memset") for ev in evs) / iters,
        memcpys=sum(ev.name.startswith("Memcpy") for ev in evs) / iters,
        names=sorted({ev.name.replace("(anonymous namespace)::", "").split("<")[0] for ev in evs}),
        busy_us=sum(ev.time_range.elapsed_us() for ev in evs) / iters,
    )


def one_launch(what, launches, kernel, acts):
    """Fail unless a step launched `kernel` once and nothing else, and
    its profiler capture shows one device activity a step, no memset
    and no memcpy."""
    if launches != {kernel: 1}:
        fail(f"{what} launched {launches}, not one {kernel}")
    if (acts["activities"], acts["memsets"], acts["memcpys"]) != (1, 0, 0):
        fail(f"{what}: {acts} over {STEP_CAPTURE} steps, not one device activity a step")


def forward_phase(torch, fw, kernels, dev):
    raw, batch = graft_device_batch(torch, fw, dev)
    model = fw.FixedWindowModel(NUM_SLOTS, device=dev)
    counts = model.init_state()
    torch.cuda.synchronize()
    kernels.launches.clear()
    counts, dec = model.forward(counts, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)

    plain_counts = torch.zeros(NUM_SLOTS, dtype=torch.int32, device=dev)
    plain_afters = fw._update_plain(plain_counts, batch.slots, batch.hits, batch.fresh)
    plain = fw._decision_block_plain(
        plain_afters, batch.hits, batch.limits, batch.shadow, model.near_ratio
    )
    for f in dec._fields:
        if u32_max_abs_err(getattr(dec, f), getattr(plain, f)) != 0:
            fail(f"forward step field {f} disagrees with the plain version")
    if u32_max_abs_err(counts, plain_counts) != 0:
        fail("forward step table disagrees with the plain version")

    # Independent reference: from an empty table each lane's after is
    # its slot's running sum of hits in batch order.
    run: dict = {}
    want_after = np.empty(len(raw["slots"]), dtype=np.int64)
    for i, (s, h) in enumerate(zip(raw["slots"].tolist(), raw["hits"].tolist())):
        run[s] = run.get(s, 0) + h
        want_after[i] = run[s]
    got_after = dec.afters.cpu().numpy().view(np.uint32)
    got_codes = dec.codes.cpu().numpy()
    want_codes = np.where(want_after > raw["limits"], 2, 1)
    if not (np.array_equal(got_after, want_after) and np.array_equal(got_codes, want_codes)):
        fail("forward step disagrees with the numpy reference")
    step = lambda: model.forward(counts, batch)  # noqa: E731
    acts = step_activities(torch, step)
    one_launch("forward step", launches, fw.K3_STEP, acts)
    ms = (time_ms(step, reps=10, inner=20), device_ms(step))
    return launches, ms, int((got_codes == 2).sum()), acts


# -- phase 5: the sharded forward step -----------------------------------


def sharded_forward_phase(torch, fw, sh, kernels, dev):
    """The graft batch through the bank-sharded model (K7 with K3's
    decision block, one fused launch).  Its ids are all in the table,
    where the sharded and the single-table steps agree exactly."""
    _, batch = graft_device_batch(torch, fw, dev)
    model = sh.ShardedFixedWindowModel(NUM_SLOTS, sh.make_mesh(BANKS, dev))
    counts = model.init_state()
    torch.cuda.synchronize()
    kernels.launches.clear()
    counts, dec = model.step(counts, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)

    one = fw.FixedWindowModel(NUM_SLOTS, device=dev)
    one_counts, one_dec = one.forward(one.init_state(), batch)
    plain_counts = model.init_state()
    plain_afters = sh._general_update_plain(
        plain_counts, batch.slots, batch.hits, batch.fresh, None, ""
    )
    plain = fw._decision_block_plain(
        plain_afters, batch.hits, batch.limits, batch.shadow, model.near_ratio
    )
    for f in dec._fields:
        if u32_max_abs_err(getattr(dec, f), getattr(one_dec, f)) != 0:
            fail(f"sharded forward field {f} disagrees with the single-table forward step")
        if u32_max_abs_err(getattr(dec, f), getattr(plain, f)) != 0:
            fail(f"sharded forward field {f} disagrees with the sharded plain version")
    if u32_max_abs_err(counts.t().reshape(-1), one_counts) != 0:
        fail("sharded table in global order disagrees with the single table")
    if u32_max_abs_err(counts, plain_counts) != 0:
        fail("sharded table disagrees with the sharded plain version")
    step = lambda: model.step(counts, batch)  # noqa: E731
    acts = step_activities(torch, step)
    one_launch("sharded forward step", launches, sh.K7_STEP, acts)
    return launches, (time_ms(step, reps=10, inner=20), device_ms(step)), acts


# -- phases 6 and 7: the served paths -------------------------------------


CONFIG = """domain: rl
descriptors:
  - key: foo
    rate_limit:
      unit: minute
      requests_per_unit: 5
  - key: burst
    rate_limit:
      unit: hour
      requests_per_unit: 5
  - key: slide
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: sliding_window
  - key: tb
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: gcra
  - key: shady
    rate_limit:
      unit: minute
      requests_per_unit: 5
      algorithm: gcra
      shadow: true
  - key: probe
    rate_limit:
      unit: hour
      requests_per_unit: 120
  - key: probe_tb
    rate_limit:
      unit: hour
      requests_per_unit: 120
      algorithm: gcra
  - key: topo
    rate_limit:
      unit: hour
      requests_per_unit: 10
  - key: half
    rate_limit:
      unit: hour
      requests_per_unit: 20
  - key: persec
    rate_limit:
      unit: second
      requests_per_unit: 1000000
  - key: wb
    rate_limit:
      unit: minute
      requests_per_unit: 2
  - key: wbstall
    rate_limit:
      unit: hour
      requests_per_unit: 150
  - key: wbfill
    rate_limit:
      unit: hour
      requests_per_unit: 1
  - key: obs_fw
    rate_limit:
      unit: hour
      requests_per_unit: 1000000
  - key: obs_sw
    rate_limit:
      unit: minute
      requests_per_unit: 1000000
      algorithm: sliding_window
  - key: obs_tb
    rate_limit:
      unit: hour
      requests_per_unit: 1000000
      algorithm: gcra
"""

#: Settings that would move the fault domain off its defaults; every
#: served phase starts from none of them.
FAULT_ENV = (
    "KERNEL_DEADLINE_S",
    "DEVICE_FAILURE_MODE",
    "DEVICE_RESTART_BACKOFF_S",
    "DEVICE_WATCHDOG_INTERVAL_S",
    "TPU_CHECKPOINT_INTERVAL_S",
)
#: Settings of the bank topology (phase 10); every other served phase
#: starts from none of them: one lane, no per-second bank, no files.
TOPOLOGY_ENV = ("TPU_NUM_LANES", "TPU_PERSECOND", "TPU_CHECKPOINT_DIR")
#: Settings of the observability planes (phase 12); every served phase
#: starts from none of them, so every plane is at its default.
PLANES_ENV = (
    "FLIGHT_RECORDER_SIZE",
    "EVENT_JOURNAL_SIZE",
    "LAUNCH_RECORDER_SIZE",
    "TSDB_INTERVAL_S",
    "ANOMALY_INTERVAL_S",
    "HOTKEYS_TOP_K",
    "INCIDENT_DIR",
)
#: Settings of phase 13 (overload control, the cluster handoff); every
#: other served phase starts from none of them.
PHASE13_ENV = (
    "OVERLOAD_SHED_ENABLED",
    "OVERLOAD_PROMOTE_ENABLED",
    "OVERLOAD_BACKPRESSURE_ENABLED",
    "PROMOTE_TTL_S",
    "BACKPRESSURE_TOKENS",
    "BACKPRESSURE_HOLD_S",
    "CLUSTER_HANDOFF_ENABLED",
    "CACHE_KEY_PREFIX",
)
#: The runner's kernel deadline at its default (settings.py).
DEFAULT_DEADLINE_S = 0.25

SHADOW_COUNTERS = ("ratelimit.tpu.shadow.gcra.agree", "ratelimit.tpu.shadow.gcra.diverge")


@contextlib.contextmanager
def serving(backend: str, env=None, config=None, **runner_kwargs):
    """The runner in-process with BACKEND_TYPE=`backend` serving CONFIG
    (or `config`, {file name: YAML}) (TPU_NUM_SLOTS, TPU_ALGORITHM_BANKS
    and every fault-domain setting at its default -- KERNEL_DEADLINE_S
    0.25 s -- but those in `env`); yields (runner, request(key, value,
    hits=0, domain="rl") over one gRPC channel, the response class)."""
    import grpc

    with tempfile.TemporaryDirectory() as root:
        cfg = os.path.join(root, "ratelimit", "config")
        os.makedirs(cfg)
        for name, text in (config or {"rl.yaml": CONFIG}).items():
            with open(os.path.join(cfg, name), "w") as f:
                f.write(text)
        for name in ("TPU_ALGORITHM_BANKS", "TPU_NUM_SLOTS", "DEBUG_PROFILING", "TPU_WARMUP",
                     *FAULT_ENV, *TOPOLOGY_ENV, *PLANES_ENV, *PHASE13_ENV):
            os.environ.pop(name, None)
        os.environ.update(env or {})
        # The three listeners on free local ports: the HTTP and debug
        # defaults (0.0.0.0:8080, :6070) may be taken on the machine.
        os.environ.update(
            BACKEND_TYPE=backend,
            RUNTIME_ROOT=root,
            RUNTIME_SUBDIRECTORY="ratelimit",
            HOST="127.0.0.1",
            PORT="0",
            GRPC_HOST="127.0.0.1",
            GRPC_PORT="0",
            DEBUG_HOST="127.0.0.1",
            DEBUG_PORT="0",
            USE_STATSD="false",
        )
        from ratelimit_tpu_torch.runner import Runner
        from ratelimit_tpu_torch.server import pb  # noqa: F401

        from envoy.service.ratelimit.v3 import rls_pb2

        runner = Runner(**runner_kwargs)
        runner.start()
        try:
            with grpc.insecure_channel(
                f"127.0.0.1:{runner.grpc_server.bound_port}"
            ) as channel:
                call = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                    request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )

                def request(key, value, hits=0, domain="rl"):
                    """One request: a descriptor per value (a list of
                    values makes a multi-descriptor request)."""
                    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
                    for v in [value] if isinstance(value, str) else value:
                        e = req.descriptors.add().entries.add()
                        e.key, e.value = key, v
                    return call(req, timeout=60)

                yield runner, request, rls_pb2.RateLimitResponse
        finally:
            runner.stop()


def fault_free(runner, what):
    """The served phase ran with the fault domain armed at its defaults
    and it never acted: no fault of any kind, no fallback or
    caller-deadline answer, no bank quarantined, health SERVING.  A
    kernel that failed or stalled on the main path fails the smoke here
    instead of being absorbed by the host mirror.  Returns the counts."""
    fd = runner.cache.fault_domain
    if fd is None or fd.kernel_deadline_s != DEFAULT_DEADLINE_S or fd.failure_mode != "host":
        fail(f"{what}: the fault domain is not armed at its defaults: {fd}")
    s = fd.summary()
    counts = dict(
        faults=s["faults"],
        fallback_decisions=s["fallback_decisions"],
        deadline_answers=runner.cache.stat_deadline_answers,
        quarantined_banks=s["quarantined_banks"],
        health="SERVING"
        if runner.health.healthy and not runner.health.degraded
        else "DEGRADED" if runner.health.healthy else "NOT_SERVING",
    )
    if (
        any(s["faults"].values())
        or s["fallback_decisions"]
        or counts["deadline_answers"]
        or s["quarantined_banks"]
        or counts["health"] != "SERVING"
    ):
        fail(f"{what}: the fault domain acted on the main path: {counts}; {s}")
    return counts


def pinned_clock():
    """A clock pinned half way through the current minute: a runner on it
    never sees a 5/minute window roll over, so a phase never waits for a
    new minute."""
    from ratelimit_tpu_torch.utils.time import PinnedTimeSource

    return PinnedTimeSource(int(time.time()) // 60 * 60 + 30)


def six_hits(request, key, value):
    """Six hits on a 5/min key (of a runner on pinned_clock(), so inside
    one minute window): the responses."""
    return [request(key, value) for _ in range(6)]


def burst(runner, request, OK) -> int:
    """512 keys of the 5/hour rule, two hits each from 32 concurrent
    clients; returns the widest launch the dispatcher coalesced."""
    keys = [f"k{i}" for i in range(512)]
    errors = []

    def worker(chunk):
        try:
            for k in chunk:
                if request("burst", k).overall_code != OK:
                    errors.append(k)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(repr(exc))

    for _ in range(2):
        threads = [threading.Thread(target=worker, args=(keys[i::32],)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads) or errors:
            fail(f"burst failed: {errors[:3]}")
    for k in keys[:16]:
        st = request("burst", k).statuses[0]
        if st.code != OK or st.limit_remaining != 2:
            fail(f"burst key {k} counted wrong: {st}")
    lanes = runner.cache.dispatcher.max_launch_lanes
    if lanes <= 1:
        fail("the burst never coalesced into a multi-lane launch")
    return lanes


def warm_us(request, key, n=400) -> float:
    """Warm closed-loop microseconds per request, one client."""
    for i in range(50):
        request(key, f"warm{i % 10}")
    t0 = time.perf_counter()
    for i in range(n):
        request(key, f"lat{i % 50}")
    return (time.perf_counter() - t0) / n * 1e6


def served_activity(torch, kernels, by_value, request, key, n=50):
    """(kernels, memcpys) on the card over n warm requests on `key`,
    from torch.profiler (device activities only), and the by-value
    launches the wrappers counted over them.  Every request names a new
    value, so none is answered from the host's over-limit cache."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(10):
        request(key, f"act-warm{i}")
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):  # again where the profiler dropped some
        before = kernels.launches.get(by_value, 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                request(key, f"act{t}-{i}")
            torch.cuda.synchronize()
        launched = kernels.launches.get(by_value, 0) - before
        names = [
            ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
        ]
        memcpys = sum(name.startswith("Memcpy") for name in names)
        if len(names) - memcpys >= n:
            break
    return len(names) - memcpys, memcpys, launched


def _since(kernels, before, names):
    return {name: kernels.launches.get(name, 0) - before.get(name, 0) for name in names}


def served_forms(kernels, device_form, by_value, before, torch, request, key, wide_key, what):
    """Every launch of `key`'s kernel in the served requests since
    `before` (one-descriptor requests and a burst of them, all chunks of
    at most 128 lanes) must take the by-value form, and a served request
    on `key` must make no memcpy; then one request of WIDE_DESCRIPTORS
    descriptors on `wide_key` (a 5/unit rule of the same kernel; a
    chunk past the by-value budget) must take the device form.  Returns
    (launches by form of the narrow requests, kernels and memcpys over
    50 requests, launches by form of the wide request)."""
    acts = served_activity(torch, kernels, by_value, request, key)
    narrow = _since(kernels, before, (device_form, by_value))
    if narrow[device_form] != 0 or narrow[by_value] < 1:
        fail(f"{what}: launches by form of the narrow requests {narrow}")
    # The launch counts are exact; the profiler, which now and then drops
    # an activity, must see nearly every kernel and no memcpy.
    if acts[2] != 50 or acts[1] != 0 or acts[0] < SEEN_KERNELS:
        fail(
            f"{what}: 50 requests made {acts[2]} by-value launches; the profiler "
            f"saw {acts[0]} kernels and {acts[1]} memcpys on the card"
        )
    before = dict(kernels.launches)
    values = [f"wide{i}" for i in range(WIDE_DESCRIPTORS)]
    statuses = request(wide_key, values).statuses
    if len(statuses) != WIDE_DESCRIPTORS or any(st.limit_remaining != 4 for st in statuses):
        fail(f"{what}: a {WIDE_DESCRIPTORS}-descriptor request counted wrong")
    wide = _since(kernels, before, (device_form, by_value))
    if wide[device_form] < 1:
        fail(f"{what}: the {WIDE_DESCRIPTORS}-descriptor request took no device form: {wide}")
    return narrow, acts, wide


def served_phase(torch, kernels, fw, sw, gcra):
    kernels.launches.clear()
    with serving("cuda", time_source=pinned_clock()) as (runner, request, R):
        OK, OVER = R.OK, R.OVER_LIMIT
        started = dict(kernels.launches)
        if sorted(runner.cache.algorithm_banks) != ["gcra", "sliding_window"]:
            fail(f"default banks not built: {sorted(runner.cache.algorithm_banks)}")
        store = runner.stats_manager.store
        shadow_before = [store.counter_fn_values()[c] for c in SHADOW_COUNTERS]
        # Fixed window (K1), sliding window (K4), GCRA (K5) and a
        # shadowed GCRA rule that fixed-window enforces: on each 5/min
        # key the 6th hit is OVER_LIMIT.
        for key in ("foo", "slide", "tb", "shady"):
            codes = [r.overall_code for r in six_hits(request, key, "x")]
            if codes != [OK] * 5 + [OVER]:
                fail(f"5/min progression wrong on {key}: {codes}")
        shadow_after = [store.counter_fn_values()[c] for c in SHADOW_COUNTERS]
        shadow_moved = [b - a for a, b in zip(shadow_before, shadow_after)]
        if sum(shadow_moved) < 1:
            fail(f"shadow gcra counters did not move: {shadow_after}")
        lanes = burst(runner, request, OK)
        us_per_req = warm_us(request, "foo")
        us_per_algo_req = warm_us(request, "tb")
        forms = {
            key: served_forms(
                kernels, device_form, by_value, started, torch, request, key, wide_key,
                f"served ({key})",
            )
            for key, wide_key, device_form, by_value in (
                ("foo", "burst", fw.K1, fw.K1_LANES),
                ("tb", "tb", gcra.K5, gcra.K5_LANES),
                ("slide", "slide", sw.K4, sw.K4_LANES),
            )
        }
        faults = fault_free(runner, "served")
    launches = dict(kernels.launches)
    for name in (fw.K1, fw.K1_LANES, sw.K4, sw.K4_LANES, gcra.K5, gcra.K5_LANES):
        if launches.get(name, 0) < 1:
            fail(f"served path did not launch {name}: {launches}")
    return launches, lanes, us_per_req, us_per_algo_req, shadow_moved, forms, faults


def sharded_served_phase(torch, kernels, sh, dev):
    """BACKEND_TYPE=cuda-sharded: 2^20 slots over BANKS banks on the card."""
    kernels.launches.clear()
    mesh = sh.make_mesh(BANKS, dev)
    with serving("cuda-sharded", device=dev, mesh=mesh, time_source=pinned_clock()) as (
        runner, request, R
    ):
        OK, OVER = R.OK, R.OVER_LIMIT
        started = dict(kernels.launches)
        engine = runner.cache.engine
        if not isinstance(engine, sh.ShardedCounterEngine) or (
            engine.model.num_banks, engine.model.num_slots
        ) != (BANKS, NUM_SLOTS):
            fail(f"cuda-sharded did not build {BANKS} banks of 2^20 slots: {engine}")
        answers = six_hits(request, "foo", "sharded")
        codes = [a.overall_code for a in answers]
        remaining = [a.statuses[0].limit_remaining for a in answers]
        if codes != [OK] * 5 + [OVER] or remaining != [4, 3, 2, 1, 0, 0]:
            fail(f"5/min progression wrong over {BANKS} banks: {codes} {remaining}")
        for i in range(40):
            if request("burst", f"spread{i}").statuses[0].limit_remaining != 4:
                fail(f"spread key {i} counted wrong")
        runner.cache.flush()
        live = np.nonzero(engine.export_counts())[0]
        banks_used = int(np.unique(live % BANKS).size)
        if banks_used != BANKS:
            fail(f"40 keys left live counters in {banks_used} of {BANKS} banks")
        lanes = burst(runner, request, OK)
        us_per_req = warm_us(request, "foo")
        forms = served_forms(
            kernels, sh.K6, sh.K6_LANES, started, torch, request, "foo", "burst",
            "sharded served",
        )
        faults = fault_free(runner, "sharded served")
    launches = dict(kernels.launches)
    for name in (sh.K6, sh.K6_LANES):
        if launches.get(name, 0) < 1:
            fail(f"sharded served path did not launch {name}: {launches}")
    return launches, lanes, us_per_req, forms, faults


# -- the host mirror against the kernels ----------------------------------

MIRROR_WIDTHS = (1, 13, 100, 128, 1000, 4096)


def _mirror_pack(rng, algo, width, now, algo_id):
    """A seeded pack of `width` lanes over width // 2 + 1 keys (so
    duplicates), as the cache builds it: fixed window with shadow lanes,
    hits and limits near u32 max beside small ones; the algorithm banks
    with 60 s windows and GCRA limits up to u32 max."""
    from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE

    generic = algo != "fixed_window"
    keys = [f"m{int(k)}".encode() for k in rng.integers(0, width // 2 + 1, width)]
    meta = np.zeros(width, LANE_DTYPE)
    meta["expiry"] = now - now % 60 + 60
    meta["len"] = [len(k) for k in keys]
    if generic:
        meta["hits"] = rng.integers(1, 4, width)
        meta["limits"] = rng.choice([1, 2, 5, 10, 30, 60, 1000, 0xFFFFFFFF], width)
        meta["divider"] = 60
        meta["algo"] = algo_id
    else:
        meta["hits"] = rng.choice([1, 2, 3, 0x7FFFFFFF], width)
        meta["limits"] = rng.choice([3, 10, 25, 0xFFFFFFF0, 0xFFFFFFFF], width)
        meta["shadow"] = rng.integers(0, 2, width)
    return b"".join(keys), meta


def check_mirror(torch, dev):
    """The host mirror (backends/host_engine.py, numpy) against the
    kernels it stands in for: the same seeded packs go through a
    HostEngine and a CounterEngine on the card -- fixed window (K1) at
    2^20 slots, sliding window (K4) and GCRA (K5) at 2^18 -- over
    MIRROR_WIDTHS lanes (by value up to 128 padded lanes, the device
    form beyond), the clock stepping through ALGO_STEPS.  Codes and
    remaining must be equal; returns the max |difference| by kernel."""
    from ratelimit_tpu_torch.backends.engine import CounterEngine
    from ratelimit_tpu_torch.backends.host_engine import HostEngine
    from ratelimit_tpu_torch.models.registry import get_algorithm

    rng = np.random.default_rng(17)
    errs = {}
    for algo, ns in (
        ("fixed_window", NUM_SLOTS),
        ("sliding_window", ALGO_SLOTS),
        ("gcra", ALGO_SLOTS),
    ):
        spec = get_algorithm(algo)
        engine = CounterEngine(device=dev, model=spec.make_model(ns, 0.8, device=dev))
        mirror = HostEngine(num_slots=ns, algorithm=algo)
        err = over = 0
        for step in ALGO_STEPS:
            now = ALGO_NOW + step
            for width in MIRROR_WIDTHS:
                blob, meta = _mirror_pack(rng, algo, width, now, spec.algo_id)
                got = engine.step_complete(engine.submit_packed(now, blob, meta.copy()))
                want = mirror.step_complete(mirror.submit_packed(now, blob, meta.copy()))
                over += int(np.count_nonzero(want.codes == 2))  # OVER_LIMIT
                for field in ("codes", "limit_remaining"):
                    diff = np.abs(
                        getattr(got, field).astype(np.int64) - getattr(want, field).astype(np.int64)
                    )
                    err = max(err, int(diff.max(initial=0)))
        errs[algo] = err
        if err or not over:
            fail(
                f"the host mirror disagrees with the {algo} kernel on the card: max|err| "
                f"{err}, {over} OVER_LIMIT answers"
            )
    return errs


# -- phase 8: the fault domain on the card ---------------------------------

#: The stall: a spinning kernel on the bank's own stream for about this
#: many kernel deadlines.
STALL_DEADLINES = 8
#: Restart backoff of the fault phase (the default is 2 s).
FAULT_BACKOFF_S = "1.0"
#: An RPC during the stall must return within the deadline plus this
#: margin: the first one waits out the deadline, then builds the bank's
#: host mirror (2^20 slots) and seeds it from the snapshot.
STALL_RPC_MARGIN_S = 0.5
PROBE_LIMIT = 120  # the probe rules' requests per hour


def sleep_cycles_per_ms(torch) -> float:
    """GPU clock cycles torch.cuda._sleep spins per millisecond, timed
    with CUDA events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)  # warm
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def stall_episode(torch, kernels, runner, request, OK, bank, key, by_value, cycles_per_ms,
                  value=None, during=None, behind=None):
    """One episode on `bank`: 40 hits on a fresh `key` value (a 120/hour
    rule; `value` names one that lands on `bank`), a snapshot, a kernel
    spinning for STALL_DEADLINES deadlines on the bank's own stream, 40
    hits during the stall (answered by the host mirror), `during(stall
    end event)` if given, the supervised restart, 100 more hits.
    Exactly 120 of the 180 must be admitted.  With `behind`, another
    bank, a snapshot of `bank` is queued just behind the stall (the
    supervisor's periodic one, landing there by chance): it must give
    up at the deadline and the hang be seen as ever, while a snapshot
    of `behind` during the stall copies at once.  Returns the
    episode's numbers."""
    fd = runner.cache.fault_domain
    rec = fd._records[bank]
    engine = fd.engine_at(bank)
    old_d = runner.cache._dispatchers[id(engine)]
    value = value or f"ep{bank}-{time.time_ns()}"
    t_first = time.monotonic()
    codes = [request(key, value).overall_code for _ in range(40)]
    taken = fd.snapshot_now(bank)
    if taken != 1:
        fail(f"bank {bank}: snapshot_now took {taken} snapshots, want 1")
    faults0 = dict(fd.stat_faults)
    fallback0 = fd.stat_fallback_decisions
    restarts0 = rec.restarts
    stall_ms = STALL_DEADLINES * fd.kernel_deadline_s * 1e3
    stall_end = torch.cuda.Event()
    with torch.cuda.stream(engine._stream):
        torch.cuda._sleep(int(stall_ms * cycles_per_ms))
        stall_end.record()
    t_stall = time.monotonic()
    snapshots = snapshot_behind(fd, bank, behind, old_d) if behind is not None else None
    rpc_ms = []
    degraded = None
    quarantined_at = None
    for i in range(40):
        t0 = time.perf_counter()
        codes.append(request(key, value).overall_code)
        rpc_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            degraded = runner.health.degraded
            quarantined_at = rec.quarantined_at
    fallback = fd.stat_fallback_decisions - fallback0
    faults = {k: v - faults0[k] for k, v in fd.stat_faults.items()}
    extra = during(stall_end) if during is not None else None
    t_over = None  # when the stall was first seen over
    t_give_up = time.monotonic() + 60
    while rec.restarts == restarts0 and time.monotonic() < t_give_up:
        if t_over is None and stall_end.query():
            t_over = time.monotonic()
        time.sleep(0.002)
    t_restart = time.monotonic()
    if rec.restarts != restarts0 + 1:
        fail(f"bank {bank}: no restart within 60 s: {fd.summary()}")
    stall_end.synchronize()
    if t_over is None:
        t_over = time.monotonic()
    new_engine = fd.engine_at(bank)
    health = (runner.health.healthy, runner.health.degraded)
    before = kernels.launches.get(by_value, 0)
    codes += [request(key, value).overall_code for _ in range(100)]
    after_swap = kernels.launches.get(by_value, 0) - before
    episode_s = time.monotonic() - t_first
    old_d._thread.join(timeout=10)
    old_d._completer.join(timeout=10)
    admitted = sum(c == OK for c in codes)
    out = dict(
        stall_ms=stall_ms,
        quarantine_ms=(quarantined_at - t_stall) * 1e3 if quarantined_at else None,
        rpc_max_ms=max(rpc_ms),
        rpc_p99_ms=float(np.percentile(rpc_ms, 99)),
        fallback=fallback,
        faults=faults,
        restart_s=t_restart - t_stall,
        stall_s=t_over - t_stall,
        restart_during_stall=t_restart < t_over,
        own_stream=new_engine._stream.cuda_stream != engine._stream.cuda_stream,
        launches_after_swap=after_swap,
        admitted=admitted,
        offered=len(codes),
        episode_s=episode_s,
        old_threads_ended=not (old_d._thread.is_alive() or old_d._completer.is_alive()),
        during=extra,
        snapshots=snapshots,
    )
    bound_ms = (fd.kernel_deadline_s + STALL_RPC_MARGIN_S) * 1e3
    if codes[:80] != [OK] * 80:
        fail(f"bank {bank}: a hit before or during the stall was refused: {out}")
    if out["rpc_max_ms"] > bound_ms:
        fail(f"bank {bank}: an RPC during the stall took {out['rpc_max_ms']:.1f} ms > {bound_ms:.0f} ms")
    if faults != {"hang": 1, "exception": 0, "device_lost": 0} or fallback != 40:
        fail(f"bank {bank}: want one hang fault and 40 fallback answers: {out}")
    if not degraded or quarantined_at is None:
        fail(f"bank {bank}: not quarantined / DEGRADED during the stall: {out}")
    if health != (True, False):
        fail(f"bank {bank}: health after the restart is {health}, not SERVING")
    if not out["own_stream"] or after_swap < 100:
        fail(f"bank {bank}: the restarted engine did not serve on its own stream: {out}")
    if episode_s >= 30:
        # A 120/hour GCRA rule refills one cell per 30 s: past that the
        # exact count is not defined.
        fail(f"bank {bank}: the episode took {episode_s:.1f} s (>= 30 s)")
    if admitted != PROBE_LIMIT:
        fail(f"bank {bank}: admitted {admitted} of {len(codes)}, want {PROBE_LIMIT}")
    if not out["old_threads_ended"]:
        fail(f"bank {bank}: the killed dispatcher's threads outlived the stall")
    if snapshots is not None:
        snapshots["thread"].join(timeout=10)
        snapshots.pop("thread")
        if snapshots.get("taken") != 0 or snapshots["gave_up_s"] >= 1.0:
            fail(f"bank {bank}: the snapshot behind the stall did not give up at the deadline: {snapshots}")
        if snapshots["other_taken"] != 1 or snapshots["other_ms"] >= fd.kernel_deadline_s * 1e3:
            fail(f"bank {behind}: its snapshot during the stall waited: {snapshots}")
    return out


def snapshot_behind(fd, bank, other, d) -> dict:
    """A snapshot of `bank` queued behind its stalled stream, in a thread
    (as the supervisor's would be), then one of `other` timed here."""
    out = {}

    def behind():
        t0 = time.monotonic()
        out["taken"] = fd.snapshot_now(bank)
        out["gave_up_s"] = time.monotonic() - t0

    out["thread"] = threading.Thread(target=behind)
    out["thread"].start()
    give_up = time.monotonic() + 2
    while d._launch_busy_since is None and time.monotonic() < give_up:
        time.sleep(0.0005)  # until the copy runs, stamped, behind the stall
    t0 = time.perf_counter()
    out["other_taken"] = fd.snapshot_now(other)
    out["other_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def fault_phase(torch, kernels, fw, gcra):
    """The runner with BACKEND_TYPE=cuda and every default but a
    restart backoff of FAULT_BACKOFF_S: a stall episode on the
    fixed-window bank (K1), one on the GCRA bank (K5), and one more on
    the fixed-window bank with a snapshot queued behind the stall.  The
    other banks must stay closed."""
    kernels.launches.clear()
    cycles_per_ms = sleep_cycles_per_ms(torch)
    if time.time() % 3600 > 3600 - 60:
        # The fixed-window probe rule counts per hour: no rollover inside.
        time.sleep(3601 - time.time() % 3600)
    with serving("cuda", env={"DEVICE_RESTART_BACKOFF_S": FAULT_BACKOFF_S}) as (
        runner,
        request,
        R,
    ):
        fd = runner.cache.fault_domain
        if fd is None or fd.kernel_deadline_s != DEFAULT_DEADLINE_S:
            fail(f"fault phase: the fault domain is not armed at its defaults: {fd}")
        episodes = {
            "fixed window": stall_episode(
                torch, kernels, runner, request, R.OK, bank_of(runner, "lane0of1"), "probe",
                fw.K1_LANES, cycles_per_ms,
            ),
            "GCRA": stall_episode(
                torch, kernels, runner, request, R.OK, bank_of(runner, "algo_gcra"),
                "probe_tb", gcra.K5_LANES, cycles_per_ms,
            ),
            "fixed window, a snapshot behind the stall": stall_episode(
                torch, kernels, runner, request, R.OK, bank_of(runner, "lane0of1"), "probe",
                fw.K1_LANES, cycles_per_ms, behind=bank_of(runner, "algo_gcra"),
            ),
        }
        summary = fd.summary()
        if summary["faults"] != {"hang": 3, "exception": 0, "device_lost": 0} or summary[
            "quarantined_banks"
        ]:
            fail(f"fault phase: faults beyond the two stalls: {summary}")
    return dict(kernels.launches), episodes, cycles_per_ms


def episode_line(name, e) -> str:
    return (
        f"fault ({name}): a {e['stall_ms']:.0f} ms stall on the bank's stream; quarantined "
        f"{e['quarantine_ms']:.1f} ms after it; 40 RPCs during it max {e['rpc_max_ms']:.1f} ms, "
        f"p99 {e['rpc_p99_ms']:.1f} ms (bound {(DEFAULT_DEADLINE_S + STALL_RPC_MARGIN_S) * 1e3:.0f} "
        f"ms), {e['fallback']} answered by the host mirror, faults {e['faults']}, DEGRADED; "
        f"restarted {e['restart_s']:.2f} s after the stall began (stall over at "
        f"{e['stall_s']:.2f} s; restart during the stall: {e['restart_during_stall']}) on its "
        f"own stream, SERVING, {e['launches_after_swap']} by-value launches after the swap; "
        f"admitted {e['admitted']}/{e['offered']} in {e['episode_s']:.1f} s; the killed "
        f"dispatcher's threads ended: {e['old_threads_ended']}"
        + (
            ""
            if e["snapshots"] is None
            else f"; the snapshot queued behind the stall gave up after {e['snapshots']['gave_up_s']:.3f} s "
            f"(took {e['snapshots']['taken']}), another bank's during it took "
            f"{e['snapshots']['other_ms']:.1f} ms"
        )
    )


# -- phase 9: the HTTP and debug listeners ----------------------------------

#: Alternating pairs of /json and gRPC legs, and requests per leg.
LISTENER_PAIRS = 10
LISTENER_LEG = 100
#: Client threads of the /json burst under each capture.
BURST_CLIENTS = 8
#: The line the burst's client process prints once every client has had
#: an answer.
BURST_RUNNING = "burst running"
#: Requests sent with a sampled traceparent.
TRACED = 20
#: The spans a traced request's tree must hold.
TRACE_PHASES = (
    "http.json",
    "decode",
    "service.should_rate_limit",
    "backend.do_limit",
    "backend.dispatch",
    "kernel.step",
    "serialize",
)
#: Functions (name and file) a sampled thread sits in while it waits: a
#: lock or event, a socket read or accept, the listeners' select and
#: grpcio's serving loop, a CUDA event wait.  The host profile's top ten
#: are printed with and without them.
IDLE_FRAMES = (
    "wait (threading.py",
    "readinto (socket.py",
    "accept (socket.py",
    "select (selectors.py",
    "_serve (_server.py",
    "synchronize (streams.py",
)
#: The by-value kernels (K1, K4, K5) by their names in a CUDA trace.
BY_VALUE_KERNELS = (
    "unique_step_lanes_kernel",
    "sw_serve_step_lanes_kernel",
    "gcra_serve_step_lanes_kernel",
)


class JsonClient:
    """One keep-alive HTTP/1.1 connection posting to the runner's /json."""

    def __init__(self, port):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def post(self, key, value, headers=None):
        """(status, body, traceparent header or None) of one request."""
        body = json.dumps(
            {"domain": "rl", "descriptors": [{"entries": [{"key": key, "value": value}]}]}
        ).encode()
        self.conn.request("POST", "/json", body, {"Content-Type": "application/json", **(headers or {})})
        resp = self.conn.getresponse()
        return resp.status, resp.read(), resp.getheader("traceparent")

    def close(self):
        self.conn.close()


def http_get(port, path):
    """(status, body) of one GET on 127.0.0.1:`port`."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def burst_main() -> None:
    """The body of json_burst's client process: argv port, tag, seconds,
    clients.  Prints BURST_RUNNING once every client has had an answer,
    then keeps the burst up for `seconds` and prints {"counts": {status:
    n}, "errors": [...]} as JSON."""
    port, tag, seconds, clients = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
    stop = threading.Event()
    lock = threading.Lock()
    counts = {}
    errors = []
    answered = threading.Semaphore(0)

    def worker(w):
        client = JsonClient(int(port))
        try:
            i = 0
            while not stop.is_set():
                status = client.post(("foo", "slide", "tb")[i % 3], f"{tag}{w}-{i}")[0]
                with lock:
                    counts[status] = counts.get(status, 0) + 1
                if i == 0:
                    answered.release()
                i += 1
        except Exception as exc:  # noqa: BLE001 -- reported to the parent
            errors.append(repr(exc))
            answered.release()
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(clients)]
    for t in threads:
        t.start()
    for _ in threads:
        answered.acquire(timeout=60)
    print(BURST_RUNNING, flush=True)
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    print(json.dumps({"counts": counts, "errors": errors[:3]}))


@contextlib.contextmanager
def json_burst(port, tag, seconds):
    """BURST_CLIENTS client threads, one keep-alive connection each,
    posting /json on fresh values of the fixed-window, sliding-window and
    GCRA keys (one kernel launch each) for `seconds`, from a process of
    their own, so that a profile of this one sees the server and not its
    clients.  The block runs once every client has had its first answer:
    a capture taken in it sees the burst, however long the process took
    to start.  Yields a dict that holds the answers by status once the
    block has ended."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.burst_main()",
         str(port), tag, str(seconds), str(BURST_CLIENTS)],
        cwd=REPO,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    counts = {}
    try:
        if proc.stdout.readline().strip() != BURST_RUNNING:
            proc.kill()
            fail(f"/json burst {tag}: the clients never ran: {proc.communicate()[1][-500:]}")
        yield counts
    finally:
        try:
            out, err = proc.communicate(timeout=seconds + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    if proc.returncode != 0:
        fail(f"/json burst {tag}: the client process exited {proc.returncode}: {err[-500:]}")
    result = json.loads(out.strip().splitlines()[-1])
    counts.update({int(k): v for k, v in result["counts"].items()})
    if result["errors"] or set(counts) != {200}:
        fail(f"/json burst {tag}: answers {counts}, errors {result['errors']}")


def listeners_phase(torch, kernels, fw, sw, gcra, k1_ms):
    """The runner with BACKEND_TYPE=cuda, every default but the config,
    the ports and DEBUG_PROFILING=1: /json, /healthcheck on both
    listeners, traced requests in /debug/tracez, a torch.profiler capture
    and the host profile during a /json burst, /json against gRPC warm,
    and no fault of the armed domain through all of it.  `k1_ms` is K1
    by value's device time, which a kernel.step span must not undercut."""
    from ratelimit_tpu_torch.observability import TRACER

    kernels.launches.clear()
    out = {}
    with serving("cuda", env={"DEBUG_PROFILING": "1"}, time_source=pinned_clock()) as (
        runner, request, R
    ):
        api, dbg = runner.http_server.bound_port, runner.debug_server.bound_port
        client = JsonClient(api)
        try:
            for key in ("foo", "slide", "tb"):
                statuses = [client.post(key, "http")[0] for _ in range(6)]
                if statuses != [200] * 5 + [429]:
                    fail(f"listeners: /json progression on {key}: {statuses}")
            for port in (api, dbg):
                if http_get(port, "/healthcheck") != (200, b"OK"):
                    fail(f"listeners: /healthcheck on :{port} is not 200 OK")
            spans = []
            for i in range(TRACED):
                tid = f"{i + 1:032x}"
                status, _, echo = client.post(
                    "foo", f"traced{i}", {"traceparent": f"00-{tid}-{'ab' * 8}-01"}
                )
                if status != 200 or echo is None or echo.split("-")[1] != tid:
                    fail(f"listeners: traced /json answered {status}, traceparent {echo}")
                trace = [t for t in TRACER.recent() if t.trace_id == tid]
                names = {s["name"]: s for s in trace[-1].spans} if trace else {}
                if set(TRACE_PHASES) - set(names):
                    fail(f"listeners: trace {tid} lacks {set(TRACE_PHASES) - set(names)}")
                spans.append(names["kernel.step"]["duration_ms"])
            tracez = http_get(dbg, "/debug/tracez")[1].decode()
            if tid not in tracez or "kernel.step" not in tracez:
                fail("listeners: /debug/tracez does not show the traced request")
            if min(spans) < k1_ms:
                fail(f"listeners: a kernel.step span ({min(spans)} ms) is shorter than K1 ({k1_ms} ms)")
            out["kernel_step_ms"] = spans
            with json_burst(api, "xt", 2.0) as burst:
                status, body = http_get(dbg, "/debug/xla_trace?seconds=1")
            if status != 200:
                fail(f"listeners: /debug/xla_trace answered {status}: {body[:200]!r}")
            trace_dir = body.decode().splitlines()[0].split("trace written to ")[1]
            path = os.path.join(trace_dir, "trace.json")
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            names = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
            seen = {k: sum(k in n for n in names) for k in BY_VALUE_KERNELS}
            if not all(seen.values()):
                fail(f"listeners: the torch.profiler trace names {seen} of the by-value kernels")
            out["xla_trace"] = dict(
                kernels=seen, events=len(events), bytes=os.path.getsize(path), burst=dict(burst)
            )
            with json_burst(api, "pr", 3.0) as burst:
                status, body = http_get(dbg, "/debug/profile?seconds=2")
            if status != 200:
                fail(f"listeners: /debug/profile answered {status}")
            lines = body.decode().splitlines()
            busy = [l for l in lines[2:] if not l.split(None, 3)[3].startswith(IDLE_FRAMES)]
            out["profile"] = dict(head=lines[0], top=lines[2:12], busy=busy[:10], burst=dict(burst))
            for i in range(50):
                client.post("foo", f"warm{i}")
                request("foo", f"warm{i}")
            legs = {"json": [], "grpc": []}
            for p in range(LISTENER_PAIRS):
                for leg in ("json", "grpc") if p % 2 == 0 else ("grpc", "json"):
                    t0 = time.perf_counter()
                    for i in range(LISTENER_LEG):
                        value = f"{leg}{p}-{i}"
                        if leg == "json":
                            ok = client.post("foo", value)[0] == 200
                        else:
                            ok = request("foo", value).overall_code == R.OK
                        if not ok:
                            fail(f"listeners: a warm {leg} request was not OK")
                    legs[leg].append((time.perf_counter() - t0) / LISTENER_LEG * 1e6)
            out["warm_us"] = legs
            for port in (api, dbg):
                if http_get(port, "/healthcheck") != (200, b"OK"):
                    fail(f"listeners: /healthcheck on :{port} after the captures is not 200 OK")
        finally:
            client.close()
        out["faults"] = fault_free(runner, "listeners")
    launches = dict(kernels.launches)
    for name in (fw.K1_LANES, sw.K4_LANES, gcra.K5_LANES):
        if launches.get(name, 0) < 1:
            fail(f"the listeners phase did not launch {name}: {launches}")
    return launches, out


def listeners_lines(out, k1_ms):
    """The phase's report, a line each."""
    spans = np.asarray(out["kernel_step_ms"]) * 1e3
    json_us, grpc_us = (np.asarray(out["warm_us"][k]) for k in ("json", "grpc"))
    faster = int(np.sum(json_us < grpc_us))
    yield (
        f"listeners: 6th /json hit 429 on fixed-window, sliding-window and GCRA keys; "
        f"/healthcheck 200 OK on both listeners; {TRACED} traced /json requests: "
        f"kernel.step min / median / max {spans.min():.1f} / {np.median(spans):.1f} / "
        f"{spans.max():.1f} us beside K1 by value {k1_ms * 1e3:.2f} us (profiler, 8 lanes)"
    )
    x = out["xla_trace"]
    yield (
        f"listeners: /debug/xla_trace?seconds=1 during a {BURST_CLIENTS}-client /json burst "
        f"from another process "
        f"({x['burst']}): {x['events']} events, {x['bytes']} bytes, by-value kernels {x['kernels']}"
    )
    pr = out["profile"]
    yield f"listeners: /debug/profile?seconds=2 during a burst ({pr['burst']}): {pr['head']}"
    for line in pr["top"]:
        yield f"  {line}"
    yield f"listeners: the same profile's top ten without the waits {IDLE_FRAMES}:"
    for line in pr["busy"]:
        yield f"  {line}"
    yield (
        f"listeners: warm us per request, {LISTENER_PAIRS} alternating pairs of "
        f"{LISTENER_LEG} on fresh fixed-window keys: /json median {np.median(json_us):.1f} "
        f"(IQR {np.subtract(*np.percentile(json_us, (75, 25))):.1f}), gRPC median "
        f"{np.median(grpc_us):.1f} (IQR {np.subtract(*np.percentile(grpc_us, (75, 25))):.1f}); "
        f"/json faster in {faster} of {LISTENER_PAIRS}; legs json {np.round(json_us, 1).tolist()} "
        f"grpc {np.round(grpc_us, 1).tolist()}; fault domain armed at "
        f"KERNEL_DEADLINE_S={DEFAULT_DEADLINE_S}: {out['faults']}"
    )


# -- phase 10: the bank topology --------------------------------------------

TOPOLOGY_LANES = 4
TOPOLOGY_ROLES = [f"lane{i}of{TOPOLOGY_LANES}" for i in range(TOPOLOGY_LANES)] + [
    "per_second",
    "algo_gcra",
    "algo_sliding_window",
]
TOPOLOGY_CLIENTS = 8
TOPO_LIMIT = 10  # the topo rule's requests per hour
TOPO_KEYS_PER_LANE = 8
TOPO_ROUNDS = 3
HALF_LIMIT = 20  # the half rule's requests per hour
HALF_KEYS_PER_LANE = 4
#: The filled lane holds this many live keys: its whole table (2^20
#: slots split over four lanes).
FULL_LANE_KEYS = 1 << 18
#: Fill keys expire this long after the fill, before any key of an hour
#: rule can (the phase starts at least PHASE10_HOUR_MARGIN_S before the
#: hour's end), so a key that a full lane takes in evicts a fill key.
FILL_TTL_S = 90
PHASE10_HOUR_MARGIN_S = 150
SNAPSHOT_BURST_S = 3.0


def bank_of(runner, role) -> int:
    """The bank index of `role` in the runner's topology: banks are
    addressed by role (checkpoint.bank_roles), since lanes and the
    per-second bank shift the algorithm banks' indices."""
    from ratelimit_tpu_torch.backends.checkpoint import bank_roles

    roles = bank_roles(runner.cache)
    if role not in roles:
        fail(f"no bank {role} in {roles}")
    return roles.index(role)


def lane_value(key, lane, n_lanes, tag) -> str:
    """A value of `key` whose cache key lands on `lane`: crc32 of the
    key's stem, as the cache routes it."""
    from ratelimit_tpu_torch.api import Descriptor
    from ratelimit_tpu_torch.limiter.cache_key import build_stem

    for i in itertools.count():
        v = f"{tag}{i}"
        stem = build_stem("", "rl", Descriptor.of((key, v)).entries).encode()
        if zlib.crc32(stem) % n_lanes == lane:
            return v


def live_streams(runner, what) -> dict:
    """Every live bank's CUDA stream handle by role; fails unless no two
    banks share one."""
    from ratelimit_tpu_torch.backends.checkpoint import bank_roles

    cache = runner.cache
    handles = {
        role: e._stream.cuda_stream for role, e in zip(bank_roles(cache), cache.engines())
    }
    if len(set(handles.values())) != len(handles):
        fail(f"{what}: two live banks share a CUDA stream: {handles}")
    return handles


def streams_past_the_pool(torch, runner) -> dict:
    """Claim more streams beside the live banks than torch's pool holds:
    each claim must be distinct from every live bank's stream and from
    the others, the claims past the pool are streams made for them
    (engine._create_stream), and work runs on those.  All go back."""
    from ratelimit_tpu_torch.backends import engine as engine_mod

    class Holder:
        pass

    dev = runner.cache.engine.device
    live = set(live_streams(runner, "past the pool").values())
    holders = [Holder() for _ in range(engine_mod.STREAM_POOL_SIZE + 2)]
    try:
        for h in holders:
            h._stream = engine_mod.claim_stream(dev, h)
        claimed = [h._stream for h in holders]
        handles = [c.cuda_stream for c in claimed]
        if len(set(handles)) != len(handles) or live & set(handles):
            fail(f"past the pool: a claim shares a stream: {handles} against {live}")
        own = {x.cuda_stream for x in engine_mod._OWN_STREAMS.get(dev.index, [])}
        made = [c for c in claimed if c.cuda_stream in own]
        if len(made) < 2:
            fail(f"past the pool: {len(made)} streams of its own, want at least 2")
        for stream in made:
            with torch.cuda.stream(stream):
                got = (torch.arange(8, device=dev) * 2).sum()
            stream.synchronize()
            if int(got) != 56:
                fail(f"past the pool: work on a stream of its own gave {int(got)}")
    finally:
        for h in holders:
            engine_mod.release_stream(h)
    return {"claimed": len(handles), "made": len(made)}


def bank_keys(runner, bank) -> list:
    """The live keys of `bank`, read on its dispatcher thread."""
    cache = runner.cache
    engine = cache.engines()[bank]
    out = []
    cache.run_exclusive(engine, lambda: out.extend(k for k, _s, _e in engine.slot_table.entries()))
    return out


def grpc_clients(runner, n, work):
    """`n` client threads with a gRPC channel each, running
    work(i, call) where call(key, value, domain="rl") returns (code,
    t0, t1), or (the response, t0, t1) with response=True; returns the
    works' results by client.  Any error fails the phase."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    port = runner.grpc_server.bound_port
    results = [None] * n
    errors = []

    def client(i):
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                stub = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                    request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )

                def call(key, value, response=False, domain="rl"):
                    req = rls_pb2.RateLimitRequest(domain=domain)
                    e = req.descriptors.add().entries.add()
                    e.key, e.value = key, value
                    t0 = time.perf_counter()
                    resp = stub(req, timeout=60)
                    return resp if response else resp.overall_code, t0, time.perf_counter()

                results[i] = work(i, call)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        fail(f"gRPC clients failed: {errors[:3]}")
    return results


def topology_counting(runner, OK, fw, kernels):
    """TOPOLOGY_CLIENTS clients, each TOPO_ROUNDS times over
    TOPO_KEYS_PER_LANE keys of a 10/hour rule on every lane, and a
    SECOND-unit key of their own: every key admits exactly its limit,
    every lane launches K1 (its own dispatcher's launches move), the
    SECOND-unit keys live only in the per-second bank, and the domain
    never acts."""
    n = TOPOLOGY_LANES
    values = [
        lane_value("topo", lane, n, f"c{lane}-{j}-")
        for lane in range(n)
        for j in range(TOPO_KEYS_PER_LANE)
    ]
    cache = runner.cache
    disp = [cache._dispatchers[id(e)] for e in cache.engines()]
    before = [d.completed_launches for d in disp]
    k1_before = kernels.launches.get(fw.K1_LANES, 0)

    def work(i, call):
        admitted = {v: 0 for v in values}
        per_second = []
        for _ in range(TOPO_ROUNDS):
            for j, v in enumerate(values):
                admitted[v] += call("topo", v)[0] == OK
                if j % 8 == i % 8:
                    per_second.append(call("persec", f"s{i}")[0])
        return admitted, per_second

    t0 = time.perf_counter()
    results = grpc_clients(runner, TOPOLOGY_CLIENTS, work)
    seconds = time.perf_counter() - t0
    totals = {v: sum(r[0][v] for r in results) for v in values}
    if any(t != TOPO_LIMIT for t in totals.values()):
        fail(f"topology: admitted {sorted(set(totals.values()))} per key, want {TOPO_LIMIT}")
    per_second = [c for r in results for c in r[1]]
    if any(c != OK for c in per_second):
        fail("topology: a SECOND-unit request was refused")
    moved = [d.completed_launches - b for d, b in zip(disp, before)]
    ps = bank_of(runner, "per_second")
    if any(m < 1 for m in moved[:n]) or moved[ps] < 1:
        fail(f"topology: launches by bank {moved}: a lane or the per-second bank never launched")
    ps_keys = bank_keys(runner, ps)
    lane_keys = [bank_keys(runner, lane) for lane in range(n)]
    if not ps_keys or any(not k.startswith("rl_persec_") for k in ps_keys):
        fail(f"topology: the per-second bank holds {ps_keys[:4]}")
    if any(k.startswith("rl_persec_") for keys in lane_keys for k in keys):
        fail("topology: a SECOND-unit key landed on a lane")
    faults = fault_free(runner, "topology")
    rpcs = TOPOLOGY_CLIENTS * TOPO_ROUNDS * len(values) + len(per_second)
    return dict(
        keys=len(values),
        rpcs=rpcs,
        seconds=seconds,
        per_s=rpcs / seconds,
        launches_by_bank=dict(zip(TOPOLOGY_ROLES, moved)),
        k1_lanes=kernels.launches.get(fw.K1_LANES, 0) - k1_before,
        per_second_keys=len(ps_keys),
        lane_keys=[len(k) for k in lane_keys],
        faults=faults,
    )


def topology_stall(torch, kernels, runner, request, OK, fw, cycles_per_ms):
    """Phase 8's stall on lane 2's stream: that lane is quarantined and
    answered by its mirror while the other lanes keep launching K1 with
    no fallback answer; it restarts without forgiving a window, on a
    stream no live bank holds."""
    n = TOPOLOGY_LANES
    stalled = 2
    cache = runner.cache
    fd = cache.fault_domain
    others = [lane for lane in range(n) if lane != stalled]
    other_values = {lane: lane_value("topo", lane, n, f"o{lane}-") for lane in others}

    def during(stall_end):
        disp = {lane: cache._dispatchers[id(fd.engine_at(lane))] for lane in others}
        before = {lane: d.completed_launches for lane, d in disp.items()}
        fallback = {lane: fd._records[lane].fallback_decisions for lane in others}
        k1 = kernels.launches.get(fw.K1_LANES, 0)
        codes = [request("topo", other_values[lane]).overall_code for lane in others for _ in range(5)]
        out = dict(
            stall_over=stall_end.query(),
            codes_ok=all(c == OK for c in codes),
            launches={lane: disp[lane].completed_launches - before[lane] for lane in others},
            fallback={lane: fd._records[lane].fallback_decisions - fallback[lane] for lane in others},
            k1_lanes=kernels.launches.get(fw.K1_LANES, 0) - k1,
            quarantined=[fd.is_quarantined(b) for b in range(len(fd._records))],
        )
        if out["stall_over"]:
            fail(f"topology stall: the stall ended before the other lanes were driven: {out}")
        if (
            not out["codes_ok"]
            or any(v < 5 for v in out["launches"].values())
            or any(out["fallback"].values())
            or out["k1_lanes"] < 15
            or out["quarantined"] != [lane == stalled for lane in range(len(fd._records))]
        ):
            fail(f"topology stall: the other lanes did not serve on the card: {out}")
        return out

    before = live_streams(runner, "before the restart")
    value = lane_value("probe", stalled, n, "stall-")
    episode = stall_episode(
        torch, kernels, runner, request, OK, stalled, "probe", fw.K1_LANES, cycles_per_ms,
        value=value, during=during,
    )
    after = live_streams(runner, "after the restart")
    if after[TOPOLOGY_ROLES[stalled]] in before.values():
        fail("topology stall: the restarted lane drew a stream a live bank held")
    episode["streams_before"] = before
    episode["streams_after"] = after
    return episode


def fill_lane(runner, kernels, bank, n=FULL_LANE_KEYS) -> tuple:
    """Fill `bank` to `n` live keys through its engine, on its
    dispatcher thread, in chunks of the widest batch.  Returns the
    seconds and the fill's launches by kernel: a harness loop beside
    the served entry points, which the `kernels` line does not count."""
    from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE

    cache = runner.cache
    engine = cache.engines()[bank]
    now = int(time.time())
    chunk = engine.max_batch

    def fill():
        for lo in range(0, n, chunk):
            keys = [f"rl_fill_{i}_".encode() for i in range(lo, min(n, lo + chunk))]
            meta = np.zeros(len(keys), LANE_DTYPE)
            meta["expiry"] = now + FILL_TTL_S
            meta["hits"] = 1
            meta["limits"] = 1000
            meta["len"] = [len(k) for k in keys]
            engine.step_complete(engine.submit_packed(now, b"".join(keys), meta))

    before = dict(kernels.launches)
    t0 = time.perf_counter()
    cache.run_exclusive(engine, fill)
    seconds = time.perf_counter() - t0
    launched = {k: v - before.get(k, 0) for k, v in kernels.launches.items()}
    return seconds, {k: v for k, v in launched.items() if v}


def topology_snapshot(runner, kernels, OK):
    """Fill lane 0 to FULL_LANE_KEYS live keys, then write every bank's
    checkpoint file during a TOPOLOGY_CLIENTS-client gRPC burst over all
    lanes: the snapshot's exclusive ms, bytes and keys per bank, and the
    RPC times during the snapshot against those outside it.  The armed
    domain must not act.  Also timed, on the full lane's dispatcher
    thread: the reference's way, decoding every key there
    (slot_table.entries())."""
    cache = runner.cache
    fd = cache.fault_domain
    full = bank_of(runner, TOPOLOGY_ROLES[0])
    fill_s, fill_launches = fill_lane(runner, kernels, full)
    live = cache.engines()[full].stat_live_keys
    if live < FULL_LANE_KEYS:
        fail(f"topology snapshot: the filled lane holds {live} live keys")
    engine = cache.engines()[full]
    decode = {}

    def reference_decode():
        t0 = time.perf_counter()
        decode["keys"] = len(engine.slot_table.entries())
        decode["ms"] = (time.perf_counter() - t0) * 1e3

    cache.run_exclusive(engine, reference_decode)
    faults0 = dict(fd.stat_faults)
    fallback0 = fd.stat_fallback_decisions
    stop = threading.Event()
    window = {}

    def work(i, call):
        times = []
        j = 0
        while not stop.is_set():
            code, t0, t1 = call("burst", f"snap{i}-{j}")
            times.append((t0, t1, code))
            j += 1
        return times

    def snapshot():
        time.sleep(SNAPSHOT_BURST_S / 3)
        window["t0"] = time.perf_counter()
        runner.checkpointer.checkpoint()
        window["t1"] = time.perf_counter()
        time.sleep(SNAPSHOT_BURST_S / 3)
        stop.set()

    taker = threading.Thread(target=snapshot)
    taker.start()
    results = grpc_clients(runner, TOPOLOGY_CLIENTS, work)
    taker.join()
    times = [t for r in results for t in r]
    if any(c != OK for _t0, _t1, c in times):
        fail("topology snapshot: an RPC of the burst was refused")
    inside = [(t1 - t0) * 1e3 for t0, t1, _c in times if t1 > window["t0"] and t0 < window["t1"]]
    outside = [(t1 - t0) * 1e3 for t0, t1, _c in times if t1 <= window["t0"] or t0 >= window["t1"]]
    faults = {k: v - faults0[k] for k, v in fd.stat_faults.items()}
    out = dict(
        fill_s=fill_s,
        fill_launches=fill_launches,
        live_keys=live,
        reference_decode_ms=decode["ms"],
        banks=runner.checkpointer.last,
        snapshot_ms=(window["t1"] - window["t0"]) * 1e3,
        rpcs=len(times),
        inside=(len(inside), float(np.median(inside)) if inside else None, max(inside, default=None)),
        outside=(len(outside), float(np.median(outside)) if outside else None, max(outside, default=None)),
        faults=faults,
        fallback=fd.stat_fallback_decisions - fallback0,
        quarantined=fd.quarantined_count(),
    )
    if any(faults.values()) or out["fallback"] or out["quarantined"]:
        fail(f"topology snapshot: the fault domain acted during the snapshot: {out}")
    if len(out["banks"]) != len(TOPOLOGY_ROLES) or any("skipped" in b for b in out["banks"]):
        fail(f"topology snapshot: not every bank was written: {out['banks']}")
    return out


def topology_phase(torch, kernels, fw, cycles_per_ms):
    """TPU_NUM_LANES=4, TPU_PERSECOND=true and TPU_CHECKPOINT_DIR, every
    other setting at its default: the banks and their streams, exact
    counting under 8 clients, a stalled lane, a snapshot of a full lane
    under a burst, and a restart on the same files that forgives no
    window -- then a runner of two lanes that refuses the lane files."""
    kernels.launches.clear()
    if time.time() % 3600 > 3600 - PHASE10_HOUR_MARGIN_S:
        # The hour rules count per hour: no rollover inside the phase.
        time.sleep(3601 - time.time() % 3600)
    out = {}
    with tempfile.TemporaryDirectory() as ckpt:
        env = {"TPU_NUM_LANES": str(TOPOLOGY_LANES), "TPU_PERSECOND": "true",
               "TPU_CHECKPOINT_DIR": ckpt}
        n = TOPOLOGY_LANES
        half_values = [
            lane_value("half", lane, n, f"h{lane}-{j}-")
            for lane in range(n)
            for j in range(HALF_KEYS_PER_LANE)
        ]
        t_boot = time.perf_counter()
        with serving("cuda", env=env) as (runner, request, R):
            out["boot_s"] = time.perf_counter() - t_boot
            OK, OVER = R.OK, R.OVER_LIMIT
            cache = runner.cache
            from ratelimit_tpu_torch.backends.checkpoint import bank_roles

            roles = bank_roles(cache)
            slots = [e.model.num_slots for e in cache.engines()]
            want = [NUM_SLOTS // n] * n + [NUM_SLOTS, ALGO_SLOTS, ALGO_SLOTS]
            if roles != TOPOLOGY_ROLES or slots != want or runner.checkpointer is None:
                fail(f"topology: banks {roles} of {slots} slots, want {TOPOLOGY_ROLES} of {want}")
            if cache.fault_domain is None or cache.fault_domain.kernel_deadline_s != DEFAULT_DEADLINE_S:
                fail("topology: the fault domain is not armed at its defaults")
            out["streams"] = live_streams(runner, "at boot")
            out["past_the_pool"] = streams_past_the_pool(torch, runner)
            out["counting"] = topology_counting(runner, OK, fw, kernels)
            out["stall"] = topology_stall(torch, kernels, runner, request, OK, fw, cycles_per_ms)
            out["snapshot"] = topology_snapshot(runner, kernels, OK)
            first = [request("half", v).overall_code for v in half_values for _ in range(HALF_LIMIT // 2)]
            if any(c != OK for c in first):
                fail("topology: half a limit was refused before the restart")
            t_stop = time.perf_counter()
        out["stop_s"] = time.perf_counter() - t_stop
        files = sorted(os.listdir(ckpt))
        if files != [f"bank{i}.npz" for i in range(len(TOPOLOGY_ROLES))]:
            fail(f"topology: the drain wrote {files}")
        t_boot = time.perf_counter()
        with serving("cuda", env=env) as (runner, request, R):
            out["restore_boot_s"] = time.perf_counter() - t_boot
            restored = [e.stat_live_keys for e in runner.cache.engines()]
            second = {
                v: [request("half", v).overall_code for _ in range(HALF_LIMIT // 2 + 1)]
                for v in half_values
            }
            want = [R.OK] * (HALF_LIMIT // 2) + [R.OVER_LIMIT]
            if any(codes != want for codes in second.values()):
                fail(f"topology: after the restart a key admitted {second}")
            out["restored_live_keys"] = dict(zip(TOPOLOGY_ROLES, restored))
            out["restart_faults"] = fault_free(runner, "topology after the restart")
        env["TPU_NUM_LANES"] = "2"
        with serving("cuda", env=env) as (runner, request, R):
            live = [len(k) for k in (bank_keys(runner, b) for b in range(len(runner.cache.engines())))]
            if any(live):
                fail(f"topology: a two-lane runner restored live keys {live} from four-lane files")
            codes = [request("half", half_values[0]).statuses[0].limit_remaining]
            if codes != [HALF_LIMIT - 1]:
                fail(f"topology: the two-lane runner did not start fresh: remaining {codes}")
            out["two_lane_roles"] = bank_roles(runner.cache)
            out["two_lane_faults"] = fault_free(runner, "topology with two lanes")
    fill = out["snapshot"]["fill_launches"]
    return {k: v - fill.get(k, 0) for k, v in kernels.launches.items()}, out


def topology_lines(t) -> list:
    """The phase's report, a line each."""
    c, st, sn = t["counting"], t["stall"], t["snapshot"]
    lines = [
        f"topology: banks {TOPOLOGY_ROLES} (boot {t['boot_s']:.1f} s), streams at boot "
        f"{t['streams']} (all distinct); {t['past_the_pool']['claimed']} more streams "
        f"claimed beside them, all distinct, {t['past_the_pool']['made']} of them made past "
        f"torch's pool of 32 and run on",
        f"topology counting: {TOPOLOGY_CLIENTS} gRPC clients, {c['keys']} keys of a "
        f"{TOPO_LIMIT}/hour rule over {TOPOLOGY_LANES} lanes, each admitted exactly "
        f"{TOPO_LIMIT}; {c['rpcs']} RPCs in {c['seconds']:.3f} s ({c['per_s']:.1f}/s); "
        f"launches by bank {c['launches_by_bank']}; K1 by value {c['k1_lanes']}; SECOND-unit "
        f"keys {c['per_second_keys']} in the per-second bank and none on a lane (lanes hold "
        f"{c['lane_keys']} keys); fault domain: {c['faults']}",
        episode_line("topology, lane 2", st),
        f"topology stall, the other lanes during it: {st['during']}; streams after the "
        f"restart {st['streams_after']} (all distinct; the restarted lane's is new)",
        f"topology snapshot: lane 0 filled to {sn['live_keys']} live keys in "
        f"{sn['fill_s']:.2f} s through the engine, not the served path (its launches "
        f"{sn['fill_launches']} are left out of the phase's and the kernels line's); the reference's decode of every key on the dispatcher thread "
        f"{sn['reference_decode_ms']:.1f} ms; checkpoint() during an {TOPOLOGY_CLIENTS}-client "
        f"burst took {sn['snapshot_ms']:.1f} ms, per bank "
        + "; ".join(
            f"{b['role']} exclusive {b['exclusive_ms']:.2f} ms, {b['bytes']} bytes, {b['keys']} keys"
            for b in sn["banks"]
        )
        + f"; RPC ms (n, median, max) during the snapshot {sn['inside']}, outside it "
        f"{sn['outside']}; faults {sn['faults']}, fallback {sn['fallback']}",
        f"topology restart: half of a {HALF_LIMIT}/hour limit on {HALF_KEYS_PER_LANE} keys a "
        f"lane, stop() {t['stop_s']:.2f} s with the final checkpoint, a second runner "
        f"(boot {t['restore_boot_s']:.1f} s, restored live keys {t['restored_live_keys']}) "
        f"admitted exactly the other half on every key, fault domain {t['restart_faults']}; a "
        f"two-lane runner ({t['two_lane_roles']}) refused the lane files by role and started "
        f"fresh, fault domain {t['two_lane_faults']}",
    ]
    return lines


# -- phase 11: the write-behind and memory backends ------------------------

WB_CLIENTS = 8
WB_KEYS = 64  # per client
WB_LIMIT = 2  # the wb rule's requests per minute
WB_SHARDED_CLIENTS = 4
WB_SHARDED_KEYS = 16  # per client
#: The stall on the write-behind bank's stream, and the bound on every
#: RPC during it: the RPC decides from the host view and never waits.
WB_STALL_MS = 1000
WB_RPC_BOUND_MS = 50.0
WB_STALL_LIMIT = 150  # the wbstall rule's requests per hour
WB_AFTER_STALL = 20
#: The full view: a quarter of the default 2^20-slot table, filled in
#: requests of WB_FILL_WIDTH descriptors of a 1/hour rule.
WB_FILL_KEYS = 1 << 18
WB_FILL_WIDTH = 512
WB_RECONCILE_LANES = 4096
WB_RECONCILE_REPS = 10
WB_PROBE_KEYS = 32


def card_counts(cache, prefix) -> dict:
    """After cache.flush(): {key: count on the card} of every live key
    starting with `prefix`, read on the bank's dispatcher thread."""
    engine = cache.engine
    out = {}

    def read():
        counts = engine.export_counts()
        out.update(
            (k, int(counts[slot]))
            for k, slot, _exp in engine.slot_table.entries()
            if k.startswith(prefix)
        )

    cache.run_exclusive(engine, read)
    return out


def wb_counting(runner, R, clients, keys, what) -> dict:
    """`clients` gRPC clients, each over `keys` keys of its own on the
    WB_LIMIT/minute rule, every key hit WB_LIMIT + 1 times: each key
    admits exactly its limit; after flush() its counter on the card
    equals the hits sent; a MemoryRateLimitCache fed each client's
    requests in the client's order agrees on every status (code and
    remaining).  A run that straddled a minute boundary is run again on
    fresh keys."""
    from ratelimit_tpu_torch.api import Descriptor, RateLimitRequest
    from ratelimit_tpu_torch.backends.memory_cache import MemoryRateLimitCache
    from ratelimit_tpu_torch.config.loader import ConfigFile, load_config
    from ratelimit_tpu_torch.stats.manager import Manager
    from ratelimit_tpu_torch.utils.time import PinnedTimeSource

    for attempt in range(2):
        tag = f"{what}-{time.time_ns()}-"
        values = [[f"{tag}c{i}k{j}" for j in range(keys)] for i in range(clients)]

        def work(i, call):
            out = []
            for _ in range(WB_LIMIT + 1):
                for v in values[i]:
                    resp, _t0, _t1 = call("wb", v, response=True)
                    out.append((v, resp.overall_code, resp.statuses[0].limit_remaining))
            return out

        t0 = time.time()
        started = time.perf_counter()
        results = grpc_clients(runner, clients, work)
        seconds = time.perf_counter() - started
        if int(t0 // 60) == int(time.time() // 60):
            break
    else:
        fail(f"{what}: two runs straddled a minute boundary")
    admitted = {}
    for r in results:
        for v, code, _rem in r:
            admitted[v] = admitted.get(v, 0) + (code == R.OK)
    if set(admitted.values()) != {WB_LIMIT} or len(admitted) != clients * keys:
        fail(f"{what}: admitted {sorted(set(admitted.values()))} per key, want {WB_LIMIT}")
    runner.cache.flush()
    on_card = card_counts(runner.cache, "rl_wb_" + tag)
    if on_card != {f"rl_wb_{v}_{int(t0 // 60) * 60}": WB_LIMIT + 1 for v in admitted}:
        wrong = {k: c for k, c in on_card.items() if c != WB_LIMIT + 1}
        fail(f"{what}: {len(on_card)} keys on the card, counts off the hits sent: {list(wrong.items())[:4]}")
    config = load_config([ConfigFile("rl.yaml", CONFIG)], Manager())
    memory = MemoryRateLimitCache(PinnedTimeSource(int(t0)))
    disagree = 0
    for r in results:
        for v, code, rem in r:
            desc = Descriptor.of(("wb", v))
            [st] = memory.do_limit(RateLimitRequest("rl", [desc], 0), [config.get_limit("rl", desc)])
            disagree += (int(st.code), st.limit_remaining) != (code, rem)
    if disagree:
        fail(f"{what}: the memory backend disagreed on {disagree} statuses")
    rpcs = sum(len(r) for r in results)
    return dict(keys=len(admitted), rpcs=rpcs, seconds=seconds, per_s=rpcs / seconds,
                attempts=attempt + 1)


def stall_stream(torch, engine, ms, cycles_per_ms):
    """A kernel spinning `ms` on `engine`'s stream; returns the event
    recorded after it."""
    end = torch.cuda.Event()
    with torch.cuda.stream(engine._stream):
        torch.cuda._sleep(int(ms * cycles_per_ms))
        end.record()
    return end


def wb_stall(torch, runner, R, cycles_per_ms) -> dict:
    """A stall of about WB_STALL_MS on the write-behind bank's stream
    while one client keeps hitting one key of the WB_STALL_LIMIT/hour
    rule: every RPC answered within WB_RPC_BOUND_MS, exactly the limit
    admitted, the dispatcher's intake above 0 during the stall; then
    flush() reconciles and the key's counter on the card equals the hits
    sent."""
    cache = runner.cache
    store = runner.stats_manager.store
    gauge = "ratelimit.tpu.bank0.dispatch_queue"
    value = f"stall-{time.time_ns()}"
    hour = int(time.time() // 3600)

    def work(_i, call):
        call("wbstall", value)  # the key's first hit, before the stall
        end = stall_stream(torch, cache.engine, WB_STALL_MS, cycles_per_ms)
        t_stall = time.perf_counter()
        during, after, queue = [], [], []
        while not end.query():
            code, t0, t1 = call("wbstall", value)
            during.append((code, (t1 - t0) * 1e3))
            queue.append(store.gauges()[gauge])
        stall_s = time.perf_counter() - t_stall
        for _ in range(WB_AFTER_STALL):
            code, t0, t1 = call("wbstall", value)
            after.append((code, (t1 - t0) * 1e3))
        return during, after, queue, stall_s

    [(during, after, queue, stall_s)] = grpc_clients(runner, 1, work)
    t_flush = time.perf_counter()
    cache.flush()
    flush_ms = (time.perf_counter() - t_flush) * 1e3
    sent = 1 + len(during) + len(after)
    admitted = 1 + sum(c == R.OK for c, _ms in during + after)
    key = f"rl_wbstall_{value}_{hour * 3600}"
    on_card = card_counts(cache, key)
    rpc_ms = [ms for _c, ms in during]
    out = dict(
        stall_s=stall_s,
        rpcs_during=len(during),
        rpc_ms_max=max(rpc_ms, default=None),
        rpc_ms_median=float(np.median(rpc_ms)) if rpc_ms else None,
        queue_max=max(queue, default=0),
        queue_hwm=cache._dispatcher.queue_depth_hwm(),
        sent=sent,
        admitted=admitted,
        on_card=on_card.get(key),
        flush_ms=flush_ms,
        pending=sum(e[1] for e in cache._view.values()),
    )
    if not during or out["rpc_ms_max"] > WB_RPC_BOUND_MS:
        fail(f"write-behind stall: RPCs during the stall {out}")
    if admitted != min(sent, WB_STALL_LIMIT) or sent <= WB_STALL_LIMIT:
        fail(f"write-behind stall: admitted {admitted} of {sent}, want {WB_STALL_LIMIT}: {out}")
    if out["queue_max"] < 1:
        fail(f"write-behind stall: the dispatcher's intake never grew: {out}")
    if out["on_card"] != sent or out["pending"]:
        fail(f"write-behind stall: after flush the card holds {out['on_card']} of {sent}: {out}")
    if int(time.time() // 3600) != hour:
        fail("write-behind stall: the hour rolled over inside the check")
    return out


def wb_fill(runner, R) -> dict:
    """WB_FILL_KEYS distinct keys of the 1/hour rule through
    cache.do_limit in requests of WB_FILL_WIDTH descriptors, then
    flush(): every key stands at its limit.  Times the completer's
    _reconcile over the fill, and a direct call over
    WB_RECONCILE_LANES keys of the view (the work of one full batch)."""
    from types import SimpleNamespace

    from ratelimit_tpu_torch.api import Descriptor, RateLimitRequest

    cache = runner.cache
    config = runner.service.get_current_config()
    rule = config.get_limit("rl", Descriptor.of(("wbfill", "x")))
    tag = f"f{time.time_ns()}-"
    spent = []
    reconcile = cache._reconcile

    def timed(keys, hits, decisions):
        t0 = time.perf_counter()
        reconcile(keys, hits, decisions)
        spent.append((len(keys), time.perf_counter() - t0))

    cache._reconcile = timed  # the completer's apply looks it up per call
    refused = 0
    t0 = time.perf_counter()
    try:
        for lo in range(0, WB_FILL_KEYS, WB_FILL_WIDTH):
            descs = [Descriptor.of(("wbfill", f"{tag}{i}")) for i in range(lo, lo + WB_FILL_WIDTH)]
            statuses = cache.do_limit(RateLimitRequest("rl", descs, 0), [rule] * WB_FILL_WIDTH)
            refused += sum(st.code != R.OK for st in statuses)
        cache.flush()
    finally:
        del cache._reconcile
    fill_s = time.perf_counter() - t0
    if refused:
        fail(f"write-behind fill: {refused} first hits refused")
    keys = [k for k in cache._view if k.startswith("rl_wbfill_" + tag)]
    if len(keys) != WB_FILL_KEYS or any(cache._view[k][:2] != [1, 0] for k in keys):
        fail(f"write-behind fill: the view holds {len(keys)} fill keys, or one is not at 1")
    lanes = keys[:WB_RECONCILE_LANES]
    decisions = SimpleNamespace(afters=np.array([cache._view[k][0] for k in lanes], np.int64))
    direct = []
    for _ in range(WB_RECONCILE_REPS):
        t1 = time.perf_counter()
        cache._reconcile(lanes, 0, decisions)  # hits 0: leaves the view as it is
        direct.append((time.perf_counter() - t1) * 1e3)
    lanes_done = sum(n for n, _s in spent)
    return dict(
        keys=len(keys),
        fill_s=fill_s,
        live_keys=cache.engine.stat_live_keys,
        max_launch_lanes=cache._dispatcher.max_launch_lanes,
        reconcile_calls=len(spent),
        reconcile_ms_per_4096=sum(s for _n, s in spent) * 1e3 * WB_RECONCILE_LANES / max(1, lanes_done),
        reconcile_direct_ms=(min(direct), float(np.median(direct)), max(direct)),
        probe=[k for k in keys[:: WB_FILL_KEYS // WB_PROBE_KEYS]][:WB_PROBE_KEYS],
        tag=tag,
    )


def wb_healthy(runner, what) -> None:
    """No commit failed and the dispatcher lives: health SERVING."""
    d = runner.cache._dispatcher
    if d.dead is not None or d._consecutive_failures or not runner.health.healthy:
        fail(f"{what}: dispatcher dead {d.dead!r}, failures {d._consecutive_failures}, "
             f"healthy {runner.health.healthy}")


def write_behind_phase(torch, kernels, fw, sh, dev, cycles_per_ms) -> tuple:
    """BACKEND_TYPE=cuda-write-behind at the default 2^20 slots with
    TPU_CHECKPOINT_DIR: exact counts under WB_CLIENTS clients, the
    envelope under a stall on the bank's stream, a quarter of the table
    filled and carried across stop() and a boot on the files; then
    cuda-sharded-write-behind on BANKS banks, and memory, which must
    launch nothing."""
    from ratelimit_tpu_torch.backends import write_behind as wb_mod
    from ratelimit_tpu_torch.backends.memory_cache import MemoryRateLimitCache

    kernels.launches.clear()
    out = {}
    if time.time() % 3600 > 3600 - PHASE10_HOUR_MARGIN_S:
        time.sleep(3601 - time.time() % 3600)  # the hour rules: no rollover inside
    with tempfile.TemporaryDirectory() as ckpt:
        env = {"TPU_CHECKPOINT_DIR": ckpt, "TPU_WARMUP": "true"}
        t_boot = time.perf_counter()
        with serving("cuda-write-behind", env=env) as (runner, request, R):
            out["boot_s"] = time.perf_counter() - t_boot
            cache = runner.cache
            if (
                not isinstance(cache, wb_mod.WriteBehindRateLimitCache)
                or cache.engine.model.num_slots != NUM_SLOTS
                or cache.engine.device != dev
            ):
                fail(f"cuda-write-behind did not build one 2^20-slot bank on {dev}")
            out["warmup"] = dict(kernels.launches)
            if out["warmup"].get(fw.K1, 0) < 1:
                fail(f"write-behind warmup launched no device-form K1: {out['warmup']}")
            out["counting"] = wb_counting(runner, R, WB_CLIENTS, WB_KEYS, "wb")
            out["stall"] = wb_stall(torch, runner, R, cycles_per_ms)
            out["fill"] = wb_fill(runner, R)
            wb_healthy(runner, "write-behind")
            out["view_keys_before"] = len(cache._view)
            t_stop = time.perf_counter()
        out["stop_s"] = time.perf_counter() - t_stop
        restored_ms = []
        on_restored = wb_mod.WriteBehindRateLimitCache.on_restored

        def timed(self):
            t0 = time.perf_counter()
            on_restored(self)
            restored_ms.append((time.perf_counter() - t0) * 1e3)

        wb_mod.WriteBehindRateLimitCache.on_restored = timed
        t_boot = time.perf_counter()
        try:
            with serving("cuda-write-behind", env=env) as (runner, request, R):
                out["restore_boot_s"] = time.perf_counter() - t_boot
                out["view_keys_after"] = len(runner.cache._view)
                codes = [request("wbfill", k[len("rl_wbfill_"):].rsplit("_", 1)[0]).overall_code
                         for k in out["fill"]["probe"]]
                if codes != [R.OVER_LIMIT] * len(codes) or not codes:
                    fail(f"write-behind restart: a key at its limit answered {codes}")
                wb_healthy(runner, "write-behind after the restart")
        finally:
            wb_mod.WriteBehindRateLimitCache.on_restored = on_restored
        out["on_restored_ms"] = restored_ms
        if len(restored_ms) != 1 or out["view_keys_after"] != out["view_keys_before"]:
            fail(f"write-behind restart: on_restored {restored_ms}, view "
                 f"{out['view_keys_before']} -> {out['view_keys_after']} keys")
    before = dict(kernels.launches)
    mesh = sh.make_mesh(BANKS, dev)
    with serving("cuda-sharded-write-behind", env={"TPU_WARMUP": "true"}, device=dev,
                 mesh=mesh) as (runner, request, R):
        engine = runner.cache.engine
        if not isinstance(engine, sh.ShardedCounterEngine) or (
            engine.model.num_banks, engine.model.num_slots
        ) != (BANKS, NUM_SLOTS):
            fail(f"cuda-sharded-write-behind did not build {BANKS} banks of 2^20 slots")
        out["sharded"] = wb_counting(runner, R, WB_SHARDED_CLIENTS, WB_SHARDED_KEYS, "wbsh")
        wb_healthy(runner, "sharded write-behind")
    out["sharded"]["launches"] = _since(kernels, before, (sh.K6, sh.K6_LANES))
    if min(out["sharded"]["launches"].values()) < 1:
        fail(f"sharded write-behind: K6 launches {out['sharded']['launches']}")
    before = dict(kernels.launches)
    with serving("memory") as (runner, request, R):
        if not isinstance(runner.cache, MemoryRateLimitCache):
            fail("BACKEND_TYPE=memory did not build the memory backend")
        # The 5/hour rule: the phase runs inside one hour.
        value = f"mem{time.time_ns()}"
        codes = [request("burst", value).overall_code for _ in range(6)]
        client = JsonClient(runner.http_server.bound_port)
        try:
            statuses = [client.post("burst", value + "j")[0] for _ in range(6)]
        finally:
            client.close()
        out["memory"] = dict(grpc=codes, json=statuses, counter_keys=len(runner.cache._counters))
        if codes != [R.OK] * 5 + [R.OVER_LIMIT] or statuses != [200] * 5 + [429]:
            fail(f"memory: gRPC {codes}, /json {statuses}")
    if dict(kernels.launches) != before:
        fail(f"memory launched kernels: {_since(kernels, before, kernels.launches)}")
    return dict(kernels.launches), out


def write_behind_lines(w) -> list:
    """The phase's report, a line each."""
    c, st, f, shd = w["counting"], w["stall"], w["fill"], w["sharded"]
    lo, med, hi = f["reconcile_direct_ms"]
    return [
        f"write-behind: cuda-write-behind, one bank of 2^20 slots (boot {w['boot_s']:.1f} s, "
        f"warmup launches {w['warmup']}); {WB_CLIENTS} gRPC clients x {WB_KEYS} keys of a "
        f"{WB_LIMIT}/minute rule, each hit {WB_LIMIT + 1} times: each admitted exactly "
        f"{WB_LIMIT}, each counter on the card {WB_LIMIT + 1} after flush, the memory backend "
        f"equal on every status; {c['rpcs']} RPCs in {c['seconds']:.3f} s ({c['per_s']:.1f}/s; "
        f"{c['attempts']} run(s))",
        f"write-behind stall: {WB_STALL_MS} ms on the bank's stream ({st['stall_s']:.3f} s seen "
        f"by the client); {st['rpcs_during']} RPCs during it, median {st['rpc_ms_median']:.2f} "
        f"ms, max {st['rpc_ms_max']:.2f} ms (bound {WB_RPC_BOUND_MS:.0f}); dispatch_queue up "
        f"to {st['queue_max']} (hwm {st['queue_hwm']}); {st['admitted']} of {st['sent']} "
        f"admitted on a {WB_STALL_LIMIT}/hour rule; flush {st['flush_ms']:.1f} ms, then "
        f"{st['on_card']} on the card, 0 pending",
        f"write-behind fill: {f['keys']} keys through do_limit in requests of {WB_FILL_WIDTH} "
        f"in {f['fill_s']:.2f} s (live keys {f['live_keys']}, widest launch "
        f"{f['max_launch_lanes']} lanes); _reconcile on the completer "
        f"{f['reconcile_ms_per_4096']:.2f} ms per {WB_RECONCILE_LANES} lanes over "
        f"{f['reconcile_calls']} calls; one call of {WB_RECONCILE_LANES} lanes min / median / "
        f"max {lo:.2f} / {med:.2f} / {hi:.2f} ms",
        f"write-behind restart: stop() {w['stop_s']:.2f} s with the final checkpoint; a boot on "
        f"the files {w['restore_boot_s']:.1f} s, on_restored {w['on_restored_ms'][0]:.1f} ms, "
        f"view {w['view_keys_after']} keys (before the stop {w['view_keys_before']}); "
        f"{WB_PROBE_KEYS} keys at their limit answered OVER_LIMIT on their first hit",
        f"sharded write-behind: {BANKS} banks of 2^20 slots; {WB_SHARDED_CLIENTS} clients x "
        f"{WB_SHARDED_KEYS} keys exact and equal to the memory backend, {shd['rpcs']} RPCs in "
        f"{shd['seconds']:.3f} s; launches {shd['launches']}",
        f"memory: gRPC 5 x OK then OVER_LIMIT, /json 5 x 200 then 429, "
        f"{w['memory']['counter_keys']} window counters on the host; no kernel launched",
    ]


# -- phase 12: the observability planes ------------------------------------

#: The sampler intervals of the observability phase (5 s by default).
PLANES_INTERVAL_S = "0.5"
#: The healthy burst: client threads (half gRPC, half /json), requests
#: each, and the share of them on the one hot value.
OBS_CLIENTS = 8
OBS_PER_CLIENT = 100
OBS_HOT_SHARE = 0.4
OBS_HOT = ("obs_fw", "hot")
OBS_KEYS = ("obs_fw", "obs_sw", "obs_tb")
OBS_ALGO = {"obs_fw": "fixed_window", "obs_sw": "sliding_window", "obs_tb": "gcra"}
#: Sampler ticks of calm one-client traffic before the stall, so the
#: latency detector's baseline is the calm path's.
CALM_TICKS = 4
#: Interpreter-lock probes during the second burst: captures, samples
#: and plain windows, each this many times.
GIL_PROBES = 3
#: An incident capture or a time-series sample may keep the interpreter
#: lock from another thread for at most this share of the deadline.
GIL_GAP_SHARE = 0.5
#: The plane cost: alternating pairs, warm requests per leg, and the
#: settings that turn every plane off.
PLANES_PAIRS = 10
PLANES_LEG = 150
PLANES_OFF = {
    "FLIGHT_RECORDER_SIZE": "0",
    "EVENT_JOURNAL_SIZE": "0",
    "LAUNCH_RECORDER_SIZE": "0",
    "TSDB_INTERVAL_S": "0",
    "ANOMALY_INTERVAL_S": "0",
    "HOTKEYS_TOP_K": "0",
}


class GilProbe:
    """A thread that sleeps 0.2 ms at a time and stamps each wakeup.
    The longest stretch between two stamps across a window is the
    longest the interpreter lock (and the host's scheduler) kept one
    ready Python thread waiting there."""

    def __init__(self):
        self.stamps = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="gil-probe", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _loop(self):
        stamps, stop = self.stamps, self._stop
        while not stop.is_set():
            stamps.append(time.perf_counter())
            time.sleep(0.0002)

    def max_gap_ms(self, t0, t1) -> float:
        """The longest stretch between two stamps that overlaps [t0, t1]."""
        import bisect

        s = self.stamps
        lo = max(0, bisect.bisect_left(s, t0) - 1)
        hi = min(len(s) - 1, bisect.bisect_right(s, t1))
        return max((s[i + 1] - s[i] for i in range(lo, hi)), default=0.0) * 1e3


def obs_clients(runner, per_client, tag, stop=None):
    """OBS_CLIENTS client threads, half over gRPC (a channel each) and
    half over /json (a keep-alive connection each), sending `per_client`
    requests each (or until `stop` is set) over the fixed-window,
    sliding-window and GCRA keys, OBS_HOT_SHARE of them on the one hot
    value.  Returns {(key, value): requests} of every answered request;
    any refusal or error fails the phase."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    sent = {}
    lock = threading.Lock()
    errors = []

    def client(w):
        rng = np.random.default_rng(1200 + w)
        counts = {}
        try:
            if w % 2 == 0:
                channel = grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}")
                stub = channel.unary_unary(
                    "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                    request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                    response_deserializer=rls_pb2.RateLimitResponse.FromString,
                )

                def call(key, value):
                    req = rls_pb2.RateLimitRequest(domain="rl")
                    e = req.descriptors.add().entries.add()
                    e.key, e.value = key, value
                    return stub(req, timeout=60).overall_code == rls_pb2.RateLimitResponse.OK

                close = channel.close
            else:
                jc = JsonClient(runner.http_server.bound_port)

                def call(key, value):
                    return jc.post(key, value)[0] == 200

                close = jc.close
            try:
                i = 0
                while (stop is None and i < per_client) or (stop is not None and not stop.is_set()):
                    if rng.random() < OBS_HOT_SHARE:
                        key, value = OBS_HOT
                    else:
                        key, value = OBS_KEYS[i % 3], f"{tag}{w}-{i}"
                    if not call(key, value):
                        errors.append(f"{key}/{value} refused")
                        return
                    counts[(key, value)] = counts.get((key, value), 0) + 1
                    i += 1
            finally:
                close()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(repr(exc))
        with lock:
            for k, n in counts.items():
                sent[k] = sent.get(k, 0) + n

    threads = [threading.Thread(target=client, args=(w,)) for w in range(OBS_CLIENTS)]
    for t in threads:
        t.start()
    return threads, sent, errors


def join_clients(threads, errors, what):
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{what}: clients failed: {errors[:3]}")


def bank_dispatchers(runner) -> list:
    """(bank, dispatcher) of every bank that has one, by bank index."""
    cache = runner.cache
    return [
        (b, cache._dispatchers[id(e)])
        for b, e in enumerate(cache.engines())
        if id(e) in cache._dispatchers
    ]


def wait_ticks(store, n, timeout=10.0):
    """Block until the time-series store has ticked `n` more times."""
    seq = store.snapshot()["seq"]
    deadline = time.monotonic() + timeout
    while store.snapshot()["seq"] < seq + n and time.monotonic() < deadline:
        time.sleep(0.02)
    if store.snapshot()["seq"] < seq + n:
        fail(f"the time-series sampler did not tick {n} times in {timeout} s")


def planes_healthy(runner):
    """The healthy burst and its checks: one launch record for each
    completed launch of each bank, all ok, items adding up to the items
    served, per-algorithm tallies equal to the keys sent, every
    complete_ns positive; one flight record per RPC with its code; the
    SLO counts; the hot key on top; the time series moving; no fault."""
    from ratelimit_tpu_torch.observability import OUTCOME_OK

    launches, flight, slo, ts = runner.launches, runner.flight, runner.slo, runner.timeseries
    sketch = runner.cache.hotkeys
    l0, f0 = launches.stamped(), flight.stamped()
    items0 = launches.items_by_algo()
    done0 = {b: d.completed_launches for b, d in bank_dispatchers(runner)}
    cum0 = dict(slo.summary()["domains"]["rl"]["cumulative"])
    ts0 = ts.snapshot()["seq"]
    t0 = time.perf_counter()
    threads, sent, errors = obs_clients(runner, OBS_PER_CLIENT, "h")
    join_clients(threads, errors, "healthy burst")
    elapsed = time.perf_counter() - t0
    runner.cache.flush()
    wait_ticks(ts, 2)
    n_sent = sum(sent.values())
    if n_sent != OBS_CLIENTS * OBS_PER_CLIENT:
        fail(f"healthy burst: sent {n_sent}, want {OBS_CLIENTS * OBS_PER_CLIENT}")
    live = launches.snapshot(since=l0)
    records = launches.snapshot_dicts(since=l0)
    done = {b: d.completed_launches - done0[b] for b, d in bank_dispatchers(runner)}
    by_bank = {}
    for r in records:
        by_bank[r["bank"]] = by_bank.get(r["bank"], 0) + 1
    want_algo = {}
    for (key, _), n in sent.items():
        want_algo[OBS_ALGO[key]] = want_algo.get(OBS_ALGO[key], 0) + n
    items = {a: n - items0[a] for a, n in launches.items_by_algo().items() if n - items0[a]}
    out = dict(
        requests=n_sent,
        seconds=elapsed,
        launches=len(records),
        by_bank=by_bank,
        items=int(live["items"].sum()),
        items_by_algo=items,
        coalesce=round(float(live["items"].mean()), 3),
        complete_us_min=float(live["complete_ns"].min()) / 1e3,
        complete_us_median=float(np.median(live["complete_ns"])) / 1e3,
        launch_us_median=float(np.median(live["launch_ns"])) / 1e3,
    )
    if launches.stamped() - l0 != len(records) or by_bank != {b: n for b, n in done.items() if n}:
        fail(f"healthy burst: launch records {by_bank} != completed launches {done}")
    if (live["outcome"] != OUTCOME_OK).any() or out["items"] != n_sent:
        fail(f"healthy burst: records not all ok or items {out['items']} != {n_sent}: {out}")
    if items != want_algo:
        fail(f"healthy burst: per-algorithm tallies {items} != keys sent {want_algo}")
    if (live["complete_ns"] <= 0).any():
        fail(f"healthy burst: a launch record with complete_ns <= 0: {out}")
    frecs = [r for r in flight.snapshot_dicts() if r["seq"] > f0]
    codes = {r["code"] for r in frecs}
    out["flight"] = len(frecs)
    if len(frecs) != n_sent or flight.stamped() - f0 != n_sent or codes != {1}:
        fail(f"healthy burst: {len(frecs)} flight records with codes {codes}, want {n_sent} OK")
    cum = slo.summary()["domains"]["rl"]["cumulative"]
    out["slo"] = {k: cum[k] - cum0[k] for k in cum}
    if out["slo"]["requests"] != n_sent or out["slo"]["over_limit"] or out["slo"]["errors"]:
        fail(f"healthy burst: SLO counts {out['slo']}, want {n_sent} requests")
    top = sketch.snapshot(limit=1)[0]
    hot_stem = f"rl_{OBS_HOT[0]}_{OBS_HOT[1]}_"
    out["hot"] = dict(key=top["key"], hits=top["hits"], sent=sent[OBS_HOT])
    if top["key"] != hot_stem or top["hits"] < sent[OBS_HOT]:
        fail(f"healthy burst: the hot key is not on top: {out['hot']}")
    series = ts.snapshot(since=ts0)["series"]
    out["series"] = {
        name: max((v for v in series[name] if v is not None), default=None)
        for name in ("decisions_per_s", "launches_per_s", "decisions_per_s.fixed_window",
                     "decisions_per_s.sliding_window", "decisions_per_s.gcra")
    }
    if not all(v and v > 0 for v in out["series"].values()):
        fail(f"healthy burst: a series did not move: {out['series']}")
    out["faults"] = fault_free(runner, "observability phase (healthy)")
    return out


def planes_stall(torch, kernels, runner, request, R, fw, cycles_per_ms):
    """Phase 8's stall on the fixed-window bank, after CALM_TICKS ticks
    of calm traffic: the journal tells quarantine, fallback, restart in
    seq order; the OUTCOME_FALLBACK records equal the fallback answers,
    and so do the flight records carrying the fallback code; the
    stalled launch's record is stamped once its event completed; the
    latency detector trips and the incident, in memory and in
    INCIDENT_DIR, holds the flight rows, the journal and the series."""
    from ratelimit_tpu_torch.observability import FLIGHT_CODE_FALLBACK

    bank = bank_of(runner, "lane0of1")
    fd = runner.cache.fault_domain
    ts = runner.timeseries
    seq = ts.snapshot()["seq"]
    i = 0
    while ts.snapshot()["seq"] < seq + CALM_TICKS:
        request("obs_fw", f"calm{i}")
        i += 1
    e0 = runner.events.emitted
    l0, f0 = runner.launches.stamped(), runner.flight.stamped()
    fallback0 = fd.stat_fallback_decisions
    incidents0 = runner.detectors.captured
    t_stall = time.time()
    episode = stall_episode(
        torch, kernels, runner, request, R.OK, bank, "probe", fw.K1_LANES, cycles_per_ms
    )
    fallback = fd.stat_fallback_decisions - fallback0
    # The detectors capture on their own tick: wait for one past the stall.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        new = runner.detectors.incidents()[: runner.detectors.captured - incidents0]
        if any(inc["detector"] == "latency_spike" for inc in new):
            break
        time.sleep(0.05)
    new = runner.detectors.incidents()[: runner.detectors.captured - incidents0]
    events = [
        e for e in runner.events.snapshot(since=e0)
        if e["type"].startswith("bank_") and e.get("bank") == bank
    ]
    types = [e["type"] for e in events]
    seqs = [e["seq"] for e in events]
    records = [r for r in runner.launches.snapshot_dicts(since=l0) if r["bank"] == bank]
    fallback_records = [r for r in records if r["outcome"] == "fallback"]
    stalled = max((r["complete_us"] for r in records if r["outcome"] == "ok"), default=0.0)
    fcodes = [r["code"] for r in runner.flight.snapshot_dicts() if r["seq"] > f0]
    files = sorted(os.listdir(runner.detectors.incident_dir))
    out = dict(
        episode=episode,
        events=types,
        fallback=fallback,
        fallback_records=len(fallback_records),
        fallback_flight=fcodes.count(FLIGHT_CODE_FALLBACK),
        stalled_complete_ms=stalled / 1e3,
        tripped=[inc["detector"] for inc in new][::-1],
        incident_files=len(files),
    )
    if not types or types[0] != "bank_quarantine" or types[1:2] != ["bank_fallback"] or types[-1] != "bank_restart" or seqs != sorted(seqs):
        fail(f"stall: journal {list(zip(types, seqs))}, want bank_quarantine, bank_fallback ... bank_restart in seq order")
    if not (out["fallback_records"] == out["fallback_flight"] == fallback == 40):
        fail(f"stall: fallback answers {fallback}, OUTCOME_FALLBACK records {out['fallback_records']}, fallback flight records {out['fallback_flight']}")
    if out["stalled_complete_ms"] < 0.5 * episode["stall_ms"]:
        fail(f"stall: no launch record waited out the stall ({out['stalled_complete_ms']:.1f} ms)")
    if "latency_spike" not in out["tripped"]:
        fail(f"stall: the latency detector did not trip (tripped: {out['tripped']}; all: "
             f"{[(i['detector'], i['reason']) for i in runner.detectors.incidents()]})")
    inc = next(i for i in new if i["detector"] == "latency_spike")
    on_disk = [f for f in files if inc["id"] in f]
    out["incident"] = dict(
        id=inc["id"],
        reason=inc["reason"],
        ring=len(inc["ring"]),
        events=[e["type"] for e in inc["events"] if e["type"].startswith("bank_")],
        series=len(inc["timeseries"]),
        on_disk=len(on_disk),
    )
    if not (inc["ring"] and "bank_quarantine" in out["incident"]["events"] and inc["timeseries"] and on_disk):
        fail(f"stall: the incident lacks evidence: {out['incident']}")
    with open(os.path.join(runner.detectors.incident_dir, on_disk[0])) as f:
        if json.load(f)["id"] != inc["id"]:
            fail("stall: the incident file holds another incident")
    return out


def planes_lock_gaps(runner):
    """During a second burst, the longest interpreter-lock gap that one
    incident capture and one time-series sample leave another thread,
    beside plain windows of the same length; no fault may come of it."""
    fd = runner.cache.fault_domain
    faults0 = dict(fd.stat_faults)
    stop = threading.Event()
    out = {"capture": [], "sample": [], "plain": [], "capture_ms": [], "sample_ms": []}
    with GilProbe() as probe:
        threads, sent, errors = obs_clients(runner, 0, "g", stop=stop)
        time.sleep(0.5)
        try:
            for _ in range(GIL_PROBES):
                t0 = time.perf_counter()
                runner.detectors._capture("gil_probe", "interpreter-lock gap of one capture")
                t1 = time.perf_counter()
                out["capture"].append(probe.max_gap_ms(t0, t1))
                out["capture_ms"].append((t1 - t0) * 1e3)
                time.sleep(0.1)
                t0 = time.perf_counter()
                runner.timeseries.tick()
                t1 = time.perf_counter()
                out["sample"].append(probe.max_gap_ms(t0, t1))
                out["sample_ms"].append((t1 - t0) * 1e3)
                time.sleep(0.1)
                t0 = time.perf_counter()
                time.sleep(max(out["capture_ms"][-1], 1.0) / 1e3)
                out["plain"].append(probe.max_gap_ms(t0, time.perf_counter()))
                time.sleep(0.1)
        finally:
            stop.set()
            join_clients(threads, errors, "lock-gap burst")
    out["requests"] = sum(sent.values())
    if fd.stat_faults != faults0 or fd.quarantined_count():
        fail(f"lock gaps: the fault domain acted during the burst: {fd.summary()}")
    bound = GIL_GAP_SHARE * DEFAULT_DEADLINE_S * 1e3
    if max(out["capture"] + out["sample"]) >= bound:
        fail(f"lock gaps: a capture or sample held the interpreter lock {max(out['capture'] + out['sample']):.1f} ms >= {bound:.0f} ms")
    return out


def planes_cost():
    """Warm served microseconds per request with every plane at its
    default against every plane off: two runners side by side, legs in
    PLANES_PAIRS alternating pairs of PLANES_LEG requests."""
    legs = {"on": [], "off": []}
    with serving("cuda") as (on_runner, on_request, _):
        with serving("cuda", env=PLANES_OFF) as (off_runner, off_request, _):
            if on_runner.flight is None or on_runner.timeseries is None:
                fail("plane cost: the default runner has a plane off")
            if any(
                p is not None
                for p in (off_runner.flight, off_runner.launches, off_runner.events,
                          off_runner.timeseries, off_runner.cache.hotkeys)
            ) or off_runner.detectors._thread is not None:
                fail("plane cost: the planes-off runner has a plane on")
            runs = {"on": on_request, "off": off_request}
            for p in range(PLANES_PAIRS):
                for side in ("on", "off") if p % 2 == 0 else ("off", "on"):
                    legs[side].append(warm_us(runs[side], "obs_fw", n=PLANES_LEG))
            fault_free(on_runner, "plane cost (on)")
            fault_free(off_runner, "plane cost (off)")
    diffs = [a - b for a, b in zip(legs["on"], legs["off"])]
    return dict(legs=legs, diffs=diffs)


def planes_phase(torch, kernels, fw, cycles_per_ms, smi):
    """The runner with BACKEND_TYPE=cuda and every default but the
    sampler intervals (PLANES_INTERVAL_S), INCIDENT_DIR and
    DEBUG_PROFILING=1, on the card's default state size (2^20
    fixed-window slots, 2^18 per algorithm bank): the healthy burst,
    the stall, the interpreter-lock gaps; then the plane cost."""
    kernels.launches.clear()
    if time.time() % 3600 > 3600 - 60:
        # The stall's probe rule counts per hour: no rollover inside.
        time.sleep(3601 - time.time() % 3600)
    with tempfile.TemporaryDirectory() as incidents:
        env = {
            "TSDB_INTERVAL_S": PLANES_INTERVAL_S,
            "ANOMALY_INTERVAL_S": PLANES_INTERVAL_S,
            "INCIDENT_DIR": incidents,
            "DEBUG_PROFILING": "1",
        }
        with serving("cuda", env=env) as (runner, request, R):
            s = runner.settings
            if (s.tpu_num_slots, s.tpu_algorithm_num_slots) != (NUM_SLOTS, ALGO_SLOTS):
                fail(f"observability phase: not the default state size: {s.tpu_num_slots}")
            out = dict(healthy=planes_healthy(runner))
            port = runner.debug_server.bound_port
            views = {}
            for path in ("/debug/hotkeys", "/debug/events", "/debug/launches", "/debug/timeseries",
                         "/debug/incidents", "/debug/slo", "/debug/flight"):
                status, body = http_get(port, path)
                views[path] = (status, len(body))
                if status != 200:
                    fail(f"observability phase: {path} answered {status}")
            out["views"] = views
            out["stall"] = planes_stall(torch, kernels, runner, request, R, fw, cycles_per_ms)
            out["gaps"] = planes_lock_gaps(runner)
    out["cost"] = planes_cost()
    return dict(kernels.launches), out


def planes_lines(o, smi) -> list:
    h, st, g, c = o["healthy"], o["stall"], o["gaps"], o["cost"]
    ep = st["episode"]

    def spread(v):
        return f"median {np.median(v):.1f}, min {min(v):.1f}, max {max(v):.1f}"

    return [
        f"planes (healthy): {h['requests']} requests from {OBS_CLIENTS} clients (gRPC and /json) "
        f"in {h['seconds']:.2f} s; {h['launches']} launch records {h['by_bank']} = the banks' "
        f"completed launches, all ok, items {h['items']} = requests, per algorithm "
        f"{h['items_by_algo']}, coalesce {h['coalesce']}, complete_us min "
        f"{h['complete_us_min']:.1f} median {h['complete_us_median']:.1f}, launch_us median "
        f"{h['launch_us_median']:.1f}; {h['flight']} flight records, all OK; SLO {h['slo']}; "
        f"hot key {h['hot']}; series maxima {h['series']}; {h['faults']}",
        f"planes (views): {o['views']}",
        f"planes (stall): journal {st['events']}; {st['fallback']} fallback answers = "
        f"{st['fallback_records']} OUTCOME_FALLBACK records = {st['fallback_flight']} flight "
        f"records with the fallback code; the stalled launch's record stamped after its event "
        f"completed, complete {st['stalled_complete_ms']:.1f} ms; tripped {st['tripped']}; "
        f"incident {st['incident']}; {st['incident_files']} files in INCIDENT_DIR; "
        f"RPCs during the stall max {ep['rpc_max_ms']:.1f} ms",
        f"planes (interpreter lock, {smi}): during a {OBS_CLIENTS}-client burst "
        f"({g['requests']} requests), one incident capture took {spread(g['capture_ms'])} ms "
        f"and left another thread at most {spread(g['capture'])} ms; one time-series sample "
        f"took {spread(g['sample_ms'])} ms, gap {spread(g['sample'])} ms; plain windows gap "
        f"{spread(g['plain'])} ms (bound {GIL_GAP_SHARE * DEFAULT_DEADLINE_S * 1e3:.0f} ms); "
        f"no fault",
        f"planes (cost, {smi}): warm us/request over gRPC, {PLANES_PAIRS} alternating pairs of "
        f"{PLANES_LEG}: every plane on {spread(c['legs']['on'])}; every plane off "
        f"{spread(c['legs']['off'])}; on - off per pair {spread(c['diffs'])}",
    ]


# -- 13. overload control and the replica half of the cluster tier ----------------

OVERLOAD_DOMAIN = """domain: {domain}
priority: {priority}
descriptors:
  - key: fw
    rate_limit: {{unit: minute, requests_per_unit: 5}}
  - key: sw
    rate_limit: {{unit: minute, requests_per_unit: 5, algorithm: sliding_window}}
  - key: tb
    rate_limit: {{unit: minute, requests_per_unit: 5, algorithm: gcra}}
"""
OVERLOAD_CONFIG = {
    "bulk.yaml": OVERLOAD_DOMAIN.format(domain="bulk", priority=1),
    "checkout.yaml": OVERLOAD_DOMAIN.format(domain="checkout", priority=5),
}
OVERLOAD_LIMIT = 5
#: The runner of 13a and 13b: every default but these.
OVERLOAD_ENV = {
    "OVERLOAD_PROMOTE_ENABLED": "true",
    "OVERLOAD_SHED_ENABLED": "true",
    "OVERLOAD_BACKPRESSURE_ENABLED": "true",
    "PROMOTE_TTL_S": "1",
    "ANOMALY_INTERVAL_S": "0.5",
    "BACKPRESSURE_TOKENS": "4",
    "BACKPRESSURE_HOLD_S": "1",
    "DEVICE_RESTART_BACKOFF_S": FAULT_BACKOFF_S,
}
PROMOTE_CLIENTS = 4
HOT = ("fw", "hot")
PROMOTED_HITS = 100
PROMOTE_PAIRS = 10
PROMOTE_LEG = 100
#: 13b: clients per domain, the calm sampler ticks before the stall,
#: and the stall's length (phase 8's).
SHED_CLIENTS = 4
SHED_CALM_TICKS = 4
SHED_KEYS = 4  # values a checkout client cycles, each offered past its limit
SHED_AFTER_S = 1.0  # of traffic after the restart
SHED_PERIOD_S = 0.04  # each client's request period
HANDOFF_CONFIG = """domain: ho
descriptors:
  - key: hm
    rate_limit: {unit: minute, requests_per_unit: 10}
  - key: hs
    rate_limit: {unit: second, requests_per_unit: 10}
  - key: hsw
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: sliding_window}
  - key: htb
    rate_limit: {unit: minute, requests_per_unit: 10, algorithm: gcra}
"""
HANDOFF_KEYS = 4096  # a quarter on each rule
HANDOFF_LIMIT = 10
HANDOFF_WIDTH = 64  # descriptors a request
HANDOFF_PREFIX = "c13:"
HANDOFF_ENV = {
    "CLUSTER_HANDOFF_ENABLED": "true",
    "TPU_PERSECOND": "true",
    "CACHE_KEY_PREFIX": HANDOFF_PREFIX,
}
HANDOFF_CLIENTS = 8
#: Where runner B's 8 banks live.
MESH_DEVICE = "cuda:0"
HANDOFF_BURST_S = 1.0  # of burst on each side of the full-lane handoff


def k1_launches(kernels, fw) -> int:
    return kernels.launches.get(fw.K1_LANES, 0) + kernels.launches.get(fw.K1, 0)


def overload_summary(runner) -> dict:
    status, body = http_get(runner.debug_server.bound_port, "/debug/overload")
    if status != 200:
        fail(f"/debug/overload answered {status}")
    return json.loads(body)


def promotion_phase(runner, request, R, fw, kernels):
    """13a: PROMOTE_CLIENTS clients on one bulk key until the controller
    promotes its stem (shown live in /debug/overload); then
    PROMOTED_HITS hits on it answer OVER_LIMIT with no K1 launch while as
    many hits on as many cold keys launch K1; after the TTL with no
    traffic the entry expires and the key launches K1 again; and warm
    µs a request on the promoted key against a device key, in
    alternating pairs."""
    promo = runner.overload.promotion
    stem = f"bulk_{HOT[0]}_{HOT[1]}_"
    stop = threading.Event()
    t_start = time.monotonic()

    def work(i, call):
        n = 0
        while not stop.is_set() and time.monotonic() < t_start + 20:
            call(*HOT, domain="bulk")
            n += 1
        return n

    def watch():
        while stem not in promo.entries and time.monotonic() < t_start + 20:
            time.sleep(0.005)
        stop.set()

    watcher = threading.Thread(target=watch)
    watcher.start()
    sent = sum(grpc_clients(runner, PROMOTE_CLIENTS, work))
    watcher.join()
    if stem not in promo.entries:
        fail(f"promotion: {stem} not promoted after {sent} hits in 20 s")
    promoted_after_s = time.monotonic() - t_start
    live = [e["key"] for e in overload_summary(runner)["promotion"]["live"]]
    if stem not in live:
        fail(f"promotion: /debug/overload does not show {stem} live: {live}")
    k0, h0 = k1_launches(kernels, fw), promo.hits
    codes = [request(*HOT, domain="bulk").overall_code for _ in range(PROMOTED_HITS)]
    promoted_k1, promoted_hits = k1_launches(kernels, fw) - k0, promo.hits - h0
    k0 = k1_launches(kernels, fw)
    cold = [request("fw", f"cold{i}", domain="bulk").overall_code for i in range(PROMOTED_HITS)]
    cold_k1 = k1_launches(kernels, fw) - k0
    if codes != [R.OVER_LIMIT] * PROMOTED_HITS or promoted_k1 or promoted_hits != PROMOTED_HITS:
        fail(f"promotion: the promoted key reached the card ({promoted_k1} K1 launches, "
             f"{promoted_hits} promotion hits, codes {set(codes)})")
    if cold != [R.OK] * PROMOTED_HITS or cold_k1 < PROMOTED_HITS:
        fail(f"promotion: {PROMOTED_HITS} cold keys made {cold_k1} K1 launches")
    t0 = time.monotonic()
    while stem in promo.entries and time.monotonic() < t0 + 10:
        time.sleep(0.02)
    expired_after_s = time.monotonic() - t0
    k0 = k1_launches(kernels, fw)
    after = request(*HOT, domain="bulk").overall_code
    expired_k1 = k1_launches(kernels, fw) - k0
    if stem in promo.entries or expired_k1 != 1 or after != R.OVER_LIMIT:
        fail(f"promotion: after the TTL the key made {expired_k1} K1 launches ({after})")
    legs = {"promoted": [], "device": []}
    for p in range(PROMOTE_PAIRS):
        for side in ("promoted", "device") if p % 2 == 0 else ("device", "promoted"):
            if side == "promoted":
                promo.promote(stem)  # re-armed for the leg, as a hot tick would
                h0 = promo.hits
            t0 = time.perf_counter()
            for i in range(PROMOTE_LEG):
                if side == "promoted":
                    request(*HOT, domain="bulk")
                else:
                    request("fw", f"dev{p}-{i}", domain="bulk")
            legs[side].append((time.perf_counter() - t0) / PROMOTE_LEG * 1e6)
            if side == "promoted" and promo.hits - h0 != PROMOTE_LEG:
                fail("promotion: a promoted leg reached the card")
    return dict(
        sent_to_promote=sent,
        promoted_after_s=promoted_after_s,
        promoted_k1=promoted_k1,
        cold_k1=cold_k1,
        expired_after_s=expired_after_s,
        expired_k1=expired_k1,
        legs=legs,
        summary=overload_summary(runner)["promotion"],
    )


def metric_values(runner, prefix) -> dict:
    """The /metrics samples whose name starts with `prefix`."""
    status, body = http_get(runner.debug_server.bound_port, "/metrics")
    if status != 200:
        fail(f"/metrics answered {status}")
    out = {}
    for line in body.decode().splitlines():
        if line.startswith(prefix):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def shed_stall_phase(torch, runner, R, cycles_per_ms):
    """13b: SHED_CLIENTS clients on bulk and as many on checkout, each
    sending a request every SHED_PERIOD_S, through phase 8's stall on
    the fixed-window bank, after SHED_CALM_TICKS calm
    sampler ticks.  The clients pause while the snapshot is taken and the
    stall enqueued (so the mirror starts from every hit), then run until
    the bank has restarted, the shed floor has lowered and the gate has
    released.  Checks: the journal's backpressure engage before the shed
    floor's raise, then its lower and the release; every shed answer a
    bulk one with flight code 8 and no backend work; checkout never shed
    and every checkout key admitting exactly its limit; the overload
    families moving on /metrics; no RPC past the deadline + margin;
    health SERVING at the end."""
    from ratelimit_tpu_torch.observability import FLIGHT_CODE_SHED

    # The runner's clock is pinned (overload_phase): the 5/minute rules
    # see no rollover, so the phase starts at once.
    cache, ov, fd = runner.cache, runner.overload, runner.cache.fault_domain
    bank = bank_of(runner, "lane0of1")
    rec = fd._records[bank]
    engine = fd.engine_at(bank)
    f0 = runner.flight.stamped()
    shed0 = ov.shed_total
    seen0 = cache.resolver.hits + cache.resolver.misses
    metrics0 = metric_values(runner, "ratelimit_overload_")
    restarts0 = rec.restarts
    paused = threading.Event()
    idle = threading.Semaphore(0)
    stop = threading.Event()

    def work(i, call):
        domain = "bulk" if i < SHED_CLIENTS else "checkout"
        keys = ("fw", "sw", "tb") if domain == "bulk" else ("fw", "sw")
        out = []
        j = 0
        while not stop.is_set():
            if paused.is_set():
                idle.release()
                while paused.is_set():
                    time.sleep(0.001)
            key = keys[j % len(keys)]
            value = f"{domain[0]}{i}-{(j // len(keys)) % SHED_KEYS}"
            code, t0, t1 = call(key, value, domain=domain)
            out.append((domain, key, value, code, t0, t1))
            j += 1
            # Paced, so the stall's slow answers are a share of a tick
            # the SLO burn can see.
            time.sleep(max(0.0, SHED_PERIOD_S - (time.perf_counter() - t0)))
        return out

    timeline = {}

    def conduct():
        # Calm: SHED_CALM_TICKS ticks in a row with no backpressure trip,
        # the gate off and no floor, so the latency baseline is the 8
        # clients'.
        trips, since = ov.bp_trips, ov.ticks
        give_up = time.monotonic() + 30
        while time.monotonic() < give_up:
            calm = ov.summary()
            if ov.bp_trips != trips or calm["backpressure"]["active"] or calm["shed"]["active"]:
                trips, since = ov.bp_trips, ov.ticks
            elif ov.ticks >= since + SHED_CALM_TICKS:
                break
            time.sleep(0.01)
        timeline["events"] = runner.events.emitted
        paused.set()
        for _ in range(2 * SHED_CLIENTS):
            if not idle.acquire(timeout=30):
                stop.set()
                paused.clear()
                return
        fd.snapshot_now(bank)
        timeline["stall"] = time.perf_counter()
        stall_stream(torch, engine, STALL_DEADLINES * fd.kernel_deadline_s * 1e3, cycles_per_ms)
        paused.clear()
        deadline = time.monotonic() + 30
        while rec.restarts == restarts0 and time.monotonic() < deadline:
            time.sleep(0.01)
        timeline["restart"] = time.perf_counter()
        time.sleep(SHED_AFTER_S)
        stop.set()

    conductor = threading.Thread(target=conduct)
    conductor.start()
    results = grpc_clients(runner, 2 * SHED_CLIENTS, work)
    conductor.join()
    if "restart" not in timeline:
        fail("shed stall: the clients did not pause for the snapshot")
    # With the traffic over, the burn decays and the hold runs out.
    give_up = time.monotonic() + 30
    while time.monotonic() < give_up:
        s = ov.summary()
        if not s["shed"]["active"] and not s["backpressure"]["active"]:
            break
        time.sleep(0.05)
    timeline["calm"] = time.perf_counter()
    rows = [r for res in results for r in res]
    events = [
        e for e in runner.events.snapshot(since=timeline["events"])
        if e["type"] in ("backpressure", "shed_floor")
    ]
    marks = [
        (e["type"], e.get("action") or e.get("direction"), e["seq"]) for e in events
    ]

    def first(kind, what):
        return next((seq for t, a, seq in marks if t == kind and a == what), None)

    order = [first("backpressure", "engage"), first("shed_floor", "raise"),
             first("shed_floor", "lower"), first("backpressure", "release")]
    engage = next((e for e in events if e["type"] == "backpressure"), {})
    frecs = [r for r in runner.flight.snapshot_dicts() if r["seq"] > f0]
    shed_recs = [r for r in frecs if r["code"] == FLIGHT_CODE_SHED]
    shed = ov.shed_total - shed0
    seen = cache.resolver.hits + cache.resolver.misses - seen0
    admitted = {}
    for domain, key, value, code, _t0, _t1 in rows:
        if domain == "checkout":
            admitted.setdefault((key, value), [0, 0])
            admitted[(key, value)][0] += code == R.OK
            admitted[(key, value)][1] += 1
    rpc_ms = [(t1 - t0) * 1e3 for *_x, t0, t1 in rows]
    stall_rpc = [(t1 - t0) * 1e3 for *_x, t0, t1 in rows if t1 > timeline["stall"] and t0 < timeline["restart"]]
    metrics = metric_values(runner, "ratelimit_overload_")
    moved = sorted(k for k, v in metrics.items() if v != metrics0.get(k, 0.0))
    health = (runner.health.healthy, runner.health.degraded)
    summary = ov.summary()
    out = dict(
        requests=len(rows),
        seconds=timeline["calm"] - timeline["stall"],
        restart_s=timeline["restart"] - timeline["stall"],
        events=marks,
        engage=dict(detector=engage.get("detector"), tokens=engage.get("tokens")),
        shed=shed,
        shed_flight=len(shed_recs),
        shed_domains=sorted({r["domain"] for r in shed_recs}),
        shed_counts=summary["shed"]["counts"],
        backend_requests=seen,
        checkout_keys=len(admitted),
        checkout_admitted=sorted({a for a, _n in admitted.values()}),
        checkout_offered_min=min((n for _a, n in admitted.values()), default=0),
        rpc_max_ms=max(rpc_ms),
        rpc_p99_ms=float(np.percentile(rpc_ms, 99)),
        stall_rpcs=len(stall_rpc),
        stall_rpc_max_ms=max(stall_rpc, default=0.0),
        bp_trips=summary["backpressure"]["trips"],
        metrics_moved=moved,
        health=health,
        faults=dict(fd.stat_faults),
    )
    if None in order or order[0] > order[1] or order[1] > order[2] or order[0] > order[3]:
        fail(f"shed stall: journal {marks}, want backpressure engage, shed_floor raise, "
             f"then lower and release in seq order; {summary['shed']}; {summary['backpressure']}")
    if engage.get("detector") not in ("latency_spike", "queue_saturation"):
        fail(f"shed stall: backpressure engaged by {engage}")
    counts = summary["shed"]["counts"]
    checkout_bp = counts.get("checkout", {}).get("backpressure", 0)
    out["checkout_shed_flight"] = sum(r["domain"] == "checkout" for r in shed_recs)
    if not shed or shed != len(shed_recs) or "bulk" not in out["shed_domains"]:
        fail(f"shed stall: {shed} sheds, {len(shed_recs)} flight records with code "
             f"{FLIGHT_CODE_SHED} from {out['shed_domains']}")
    if not counts.get("bulk", {}).get("slo_burn"):
        fail(f"shed stall: the floor never shed bulk: {counts}")
    if seen != len(rows) - shed:
        fail(f"shed stall: {seen} requests reached the backend, want {len(rows)} - {shed} shed")
    # The top level is never shed by the floor; the backpressure gate
    # admits every domain alike, and its sheds are counted apart.
    if counts.get("checkout", {}).get("slo_burn") or out["checkout_shed_flight"] != checkout_bp:
        fail(f"shed stall: checkout was shed by the floor: {counts}")
    if out["checkout_admitted"] != [OVERLOAD_LIMIT] or out["checkout_offered_min"] <= OVERLOAD_LIMIT:
        fail(f"shed stall: checkout keys admitted {out['checkout_admitted']} "
             f"(offered at least {out['checkout_offered_min']}), want exactly {OVERLOAD_LIMIT}")
    if not any("shed" in k for k in moved) or not any("backpressure_trips" in k for k in moved):
        fail(f"shed stall: the overload families did not move on /metrics: {moved}")
    bound_ms = (fd.kernel_deadline_s + STALL_RPC_MARGIN_S) * 1e3
    if out["rpc_max_ms"] > bound_ms:
        fail(f"shed stall: an RPC took {out['rpc_max_ms']:.1f} ms > {bound_ms:.0f} ms")
    if rec.restarts != restarts0 + 1 or health != (True, False):
        fail(f"shed stall: restarts {rec.restarts - restarts0}, health {health}")
    return out


def ho_call(runner):
    """call(pairs) -> the statuses' (code, remaining) of one request of
    domain ho with a descriptor per (key, value)."""
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2

    channel = grpc.insecure_channel(f"127.0.0.1:{runner.grpc_server.bound_port}")
    stub = channel.unary_unary(
        "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
        request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
        response_deserializer=rls_pb2.RateLimitResponse.FromString,
    )

    def call(pairs):
        req = rls_pb2.RateLimitRequest(domain="ho")
        for key, value in pairs:
            e = req.descriptors.add().entries.add()
            e.key, e.value = key, value
        return [(s.code, s.limit_remaining) for s in stub(req, timeout=60).statuses]

    return call, channel


def handoff_keys():
    per = HANDOFF_KEYS // 4
    return [(k, f"{k}{i}") for k in ("hm", "hs", "hsw", "htb") for i in range(per)]


def hit_all(call, pairs, times):
    """Each (key, value) hit `times` times, HANDOFF_WIDTH descriptors a
    request; returns each pair's answers."""
    out = {p: [] for p in pairs}
    for _ in range(times):
        for lo in range(0, len(pairs), HANDOFF_WIDTH):
            part = pairs[lo : lo + HANDOFF_WIDTH]
            for p, st in zip(part, call(part)):
                out[p].append(st)
    return out


def exclusive_timer(cache, log):
    """Wrap cache.run_exclusive so each call notes (its function's name,
    ms it held the bank)."""
    run = cache.run_exclusive

    def timed(engine, fn):
        def held():
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                log.append((getattr(fn, "__name__", "?"), (time.perf_counter() - t0) * 1e3))

        run(engine, held)

    cache.run_exclusive = timed


def handoff_phase(kernels):
    """13c: runner A (cuda, two lanes) and runner B (cuda-sharded, 8
    banks on the card), both with CLUSTER_HANDOFF_ENABLED, TPU_PERSECOND
    and one CACHE_KEY_PREFIX, on a pinned clock.  HANDOFF_KEYS keys of a
    minute, a second-unit, a sliding-window and a GCRA rule hit to half
    their limit on A; the HandoffCoordinator over the debug listeners
    moves membership [A] -> [A, B]; every key then admits exactly the
    other half on its owner; both /debug/cluster views and journals tell
    it.  Then lane 0 of A is filled to FULL_LANE_KEYS live keys: the
    reference's way timed on it (export_keys and the rebuild its drop
    adds; import_keys of the moved keys into a fresh engine), then the
    port's export and import during a HANDOFF_CLIENTS-client burst on
    both runners: each exclusive leg's ms, RPC ms during against outside,
    no fault."""
    from ratelimit_tpu_torch.backends.engine import CounterEngine, release_stream
    from ratelimit_tpu_torch.cluster import handoff as ho
    from ratelimit_tpu_torch.cluster.hashing import owner_id, stem_of_cache_key
    from ratelimit_tpu_torch.parallel import make_mesh

    pinned = pinned_clock()
    env_a = dict(HANDOFF_ENV, TPU_NUM_LANES="2")
    cfg = {"ho.yaml": HANDOFF_CONFIG}
    with serving("cuda", env=env_a, config=cfg, time_source=pinned) as (a, _ra, R):
        with serving("cuda-sharded", env=HANDOFF_ENV, config=cfg, time_source=pinned,
                     mesh=make_mesh(BANKS, MESH_DEVICE)) as (b, _rb, _):
            call_a, chan_a = ho_call(a)
            call_b, chan_b = ho_call(b)
            try:
                pairs = handoff_keys()
                first = hit_all(call_a, pairs, HANDOFF_LIMIT // 2)
                if any(st[0] != R.OK for sts in first.values() for st in sts):
                    fail("handoff: a hit before the move was refused")
                urls = {
                    "A": f"http://127.0.0.1:{a.debug_server.bound_port}",
                    "B": f"http://127.0.0.1:{b.debug_server.bound_port}",
                }
                admins = {rid: ho.HttpAdminTransport(url) for rid, url in urls.items()}
                a_e0, b_e0 = a.events.emitted, b.events.emitted
                summary = ho.HandoffCoordinator(admins.get).run(["A"], ["A", "B"])
                from ratelimit_tpu_torch.limiter.cache_key import build_stem
                from ratelimit_tpu_torch.api import Descriptor

                owners = {
                    p: owner_id(build_stem("", "ho", Descriptor.of(p).entries), ["A", "B"]) for p in pairs
                }
                to_b = [p for p in pairs if owners[p] == "B"]
                on_a = [p for p in pairs if owners[p] == "A"]
                rest = {**hit_all(call_b, to_b, HANDOFF_LIMIT // 2 + 1), **hit_all(call_a, on_a, HANDOFF_LIMIT // 2 + 1)}
                want = [(R.OK, HANDOFF_LIMIT // 2 - 1 - i) for i in range(HANDOFF_LIMIT // 2)] + [(R.OVER_LIMIT, 0)]
                wrong = [p for p, sts in rest.items() if sts != want]
                views = {rid: json.loads(http_get(r.debug_server.bound_port, "/debug/cluster")[1])["handoff"]
                         for rid, r in (("A", a), ("B", b))}
                journal = {
                    "A": [(e["type"], e.get("keys")) for e in a.events.snapshot(since=a_e0) if e["type"].startswith("handoff")],
                    "B": [(e["type"], e.get("imported")) for e in b.events.snapshot(since=b_e0) if e["type"].startswith("handoff")],
                }
                moved = dict(
                    keys=len(pairs), to_b=len(to_b), kept=len(on_a), summary=summary,
                    views={rid: {k: v[k] for k in ("exported_keys", "imported_keys", "merged_keys", "dropped_keys")}
                           for rid, v in views.items()},
                    journal=journal, wrong=len(wrong),
                )
                if summary["errors"] or summary["moved_keys"] != len(to_b) or summary["imported"] != len(to_b):
                    fail(f"handoff: the coordinator moved {summary}, want {len(to_b)} keys to B")
                if wrong:
                    p = wrong[0]
                    fail(f"handoff: {len(wrong)} keys did not admit exactly the rest on their owner, "
                         f"e.g. {p} ({owners[p]}): {rest[p]}")
                if views["A"]["exported_keys"] != len(to_b) or views["B"]["imported_keys"] != len(to_b):
                    fail(f"handoff: /debug/cluster shows {moved['views']}")
                if journal["A"] != [("handoff_export", len(to_b))] or journal["B"] != [("handoff_import", len(to_b))]:
                    fail(f"handoff: journals {journal}")
                full = fill_and_move(kernels, a, b, admins, R, (CounterEngine, release_stream),
                                     ho, owner_id, stem_of_cache_key)
            finally:
                chan_a.close()
                chan_b.close()
    return moved, full


def fill_and_move(kernels, a, b, admins, R, engine_api, ho, owner_id, stem_of_cache_key):
    """13c's second half (handoff_phase's docstring)."""
    CounterEngine, release_stream = engine_api
    lane = bank_of(a, "lane0of2")
    fill_s, fill_launches = fill_lane(a, kernels, lane, FULL_LANE_KEYS)
    engine = a.cache.engines()[lane]
    live = engine.stat_live_keys
    if live < FULL_LANE_KEYS:
        fail(f"handoff: the filled lane holds {live} live keys")
    members = ["A", "B"]

    def moved(key):
        return owner_id(stem_of_cache_key(key, HANDOFF_PREFIX), members) != "A"

    ref = {}

    def reference():
        # export_keys without its drop, then what the drop adds: the
        # state's round trip and the slot table's rebuild from the kept
        # entries (built, not installed).
        t0 = time.perf_counter()
        state, entries = engine.export_keys(moved, drop=False)
        ref["export_ms"] = (time.perf_counter() - t0) * 1e3
        gone = {k for k, _e in entries}
        keep = [e for e in engine.slot_table.entries() if e[0] not in gone]
        t0 = time.perf_counter()
        engine.import_state(engine.export_state())
        type(engine.slot_table).from_entries(engine.model.num_slots, keep)
        ref["drop_ms"] = (time.perf_counter() - t0) * 1e3
        ref["state"], ref["entries"] = state, entries
        ref["moved"] = len(entries)

    a.cache.run_exclusive(engine, reference)
    scratch = CounterEngine(num_slots=engine.model.num_slots, buckets=engine.buckets, device=engine.device)
    t0 = time.perf_counter()
    ref_import = scratch.import_keys(ref["state"], ref["entries"], int(time.time()))
    ref["import_ms"] = (time.perf_counter() - t0) * 1e3
    release_stream(scratch)
    # The reference's per-key tuples are this harness's garbage: gone
    # before the burst, so no collection of them lands in it.
    del ref["state"], ref["entries"], scratch
    gc.collect()
    legs = {"A": [], "B": []}
    exclusive_timer(a.cache, legs["A"])
    exclusive_timer(b.cache, legs["B"])
    fds = {"A": a.cache.fault_domain, "B": b.cache.fault_domain}
    faults0 = {rid: dict(fd.stat_faults) for rid, fd in fds.items()}
    stop = threading.Event()
    window = {}

    def work(i, call):
        # Keys the side's own replica owns, so the export moves fill
        # keys only.
        side = "A" if i < HANDOFF_CLIENTS // 2 else "B"
        times = []
        j = 0
        while not stop.is_set():
            j += 1
            value = f"burst{i}-{j}"
            if owner_id(f"ho_hm_{value}_", members) != side:
                continue
            code, t0, t1 = call("hm", value, domain="ho")
            times.append((t0, t1, code))
        return times

    def move():
        time.sleep(HANDOFF_BURST_S)
        window["t0"] = time.perf_counter()
        window["summary"] = ho.HandoffCoordinator(admins.get).run(["A"], members)
        window["t1"] = time.perf_counter()
        time.sleep(HANDOFF_BURST_S)
        stop.set()

    mover = threading.Thread(target=move)
    half = HANDOFF_CLIENTS // 2
    res = [None, None]
    side_b = threading.Thread(
        target=lambda: res.__setitem__(1, grpc_clients(b, half, lambda i, call: work(half + i, call)))
    )
    with GilProbe() as probe:
        mover.start()
        side_b.start()
        res[0] = grpc_clients(a, half, work)
        side_b.join()
        mover.join()
    lock_gap_ms = probe.max_gap_ms(window["t0"], window["t1"])
    times = [t for side in res for r in side for t in r]
    if any(c != R.OK for _t0, _t1, c in times):
        fail("handoff burst: an RPC was refused")
    inside = [(t1 - t0) * 1e3 for t0, t1, _c in times if t1 > window["t0"] and t0 < window["t1"]]
    outside = [(t1 - t0) * 1e3 for t0, t1, _c in times if t1 <= window["t0"] or t0 >= window["t1"]]
    faults = {rid: {k: v - faults0[rid][k] for k, v in fd.stat_faults.items()} for rid, fd in fds.items()}
    summary = window["summary"]
    out = dict(
        fill_s=fill_s,
        fill_launches=fill_launches,
        live_keys=live,
        reference=dict(export_ms=ref["export_ms"], drop_ms=ref["drop_ms"], import_ms=ref["import_ms"],
                       moved=ref["moved"], imported=ref_import["imported"]),
        moved=summary["moved_keys"],
        imported=summary["imported"],
        handoff_s=window["t1"] - window["t0"],
        legs={rid: sorted(((n, round(ms, 3)) for n, ms in log), key=lambda x: -x[1])[:6] for rid, log in legs.items()},
        leg_max_ms={rid: max((ms for _n, ms in log), default=0.0) for rid, log in legs.items()},
        leg_count={rid: len(log) for rid, log in legs.items()},
        rpcs=len(times),
        inside=(len(inside), float(np.median(inside)) if inside else None, max(inside, default=None)),
        outside=(len(outside), float(np.median(outside)) if outside else None, max(outside, default=None)),
        lock_gap_ms=lock_gap_ms,
        faults=faults,
        quarantined={rid: fd.quarantined_count() for rid, fd in fds.items()},
    )
    if summary["errors"] or summary["moved_keys"] != ref["moved"] or summary["imported"] != ref["moved"]:
        fail(f"handoff burst: moved {summary}, want {ref['moved']} fill keys to B")
    if any(v for f in faults.values() for v in f.values()) or any(out["quarantined"].values()):
        fail(f"handoff burst: the fault domain acted: {out}")
    return out


#: The chaos twin's device.
CHAOS_DEVICE = "cuda"


def chaos_twin() -> dict:
    """13d: scripts/torch_chaos_smoke.py --device cuda, in this process."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "torch_chaos_smoke.py")
    spec = importlib.util.spec_from_file_location("torch_chaos_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "chaos.json")
        t0 = time.perf_counter()
        rc = mod.main(["--device", CHAOS_DEVICE, "--out", out])
        seconds = time.perf_counter() - t0
        with open(out) as f:
            result = json.load(f)
    if rc != 0:
        fail(f"chaos twin failed: {[c['name'] for c in result['checks'] if not c['ok']]}")
    return dict(seconds=seconds, controlled=result["controlled"], uncontrolled=result["uncontrolled"],
                matrix=result["failure_mode_matrix"], checks=len(result["checks"]))


def overload_phase(torch, kernels, fw, cycles_per_ms):
    """Phase 13: 13a promotion and 13b shedding and backpressure on one
    runner (BACKEND_TYPE=cuda, every default but OVERLOAD_ENV, the two
    domains of OVERLOAD_CONFIG), 13c the handoff between two runners,
    13d the chaos twin."""
    kernels.launches.clear()
    out = {}

    def overload():
        # A pinned clock, as 13c's: the 5/minute rules of 13a and 13b
        # never see a minute roll over.  The controller, the SLO windows
        # and the detectors read their own monotonic clock, not this one.
        pinned = pinned_clock()
        with serving("cuda", env=OVERLOAD_ENV, config=OVERLOAD_CONFIG, time_source=pinned) as (runner, request, R):
            s = runner.settings
            if (s.tpu_num_slots, s.tpu_algorithm_num_slots) != (NUM_SLOTS, ALGO_SLOTS) or runner.overload is None:
                fail(f"overload phase: not the default state size or no controller: {s.tpu_num_slots}")
            t0 = time.perf_counter()
            out["promotion"] = promotion_phase(runner, request, R, fw, kernels)
            out["promotion"]["s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["shed"] = shed_stall_phase(torch, runner, R, cycles_per_ms)
            out["shed"]["s"] = time.perf_counter() - t0

    def handoff():
        t0 = time.perf_counter()
        out["handoff"], out["full"] = handoff_phase(kernels)
        out["handoff"]["s"] = time.perf_counter() - t0
        out["chaos"] = chaos_twin()

    overload()
    handoff()
    fill = out["full"]["fill_launches"]
    return {k: v - fill.get(k, 0) for k, v in kernels.launches.items()}, out


def overload_lines(o, smi) -> list:
    p, sd, h, f, c = o["promotion"], o["shed"], o["handoff"], o["full"], o["chaos"]

    def spread(v):
        return f"median {np.median(v):.1f}, min {min(v):.1f}, max {max(v):.1f}"

    return [
        f"overload (promotion, {smi}): {p['sent_to_promote']} hits from {PROMOTE_CLIENTS} clients "
        f"promoted the hot stem in {p['promoted_after_s']:.2f} s (live in /debug/overload); "
        f"{PROMOTED_HITS} hits on it OVER_LIMIT with {p['promoted_k1']} K1 launches, {PROMOTED_HITS} "
        f"cold keys {p['cold_k1']} K1 launches; expired {p['expired_after_s']:.2f} s after the traffic "
        f"stopped, then {p['expired_k1']} K1 launch; warm us/request over gRPC, {PROMOTE_PAIRS} "
        f"alternating pairs of {PROMOTE_LEG}: promoted {spread(p['legs']['promoted'])}; device "
        f"{spread(p['legs']['device'])}; {p['s']:.1f} s",
        f"overload (shed and backpressure, {smi}): {sd['requests']} requests from "
        f"{2 * SHED_CLIENTS} clients over a {STALL_DEADLINES}-deadline stall; journal {sd['events']}; "
        f"engaged by {sd['engage']}; {sd['shed']} sheds = {sd['shed_flight']} flight records with "
        f"code 8 from {sd['shed_domains']} (checkout only by the gate: "
        f"{sd['checkout_shed_flight']}); counts {sd['shed_counts']}; {sd['backend_requests']} "
        f"requests reached the backend; {sd['checkout_keys']} checkout keys each admitted "
        f"{sd['checkout_admitted']} (offered at least {sd['checkout_offered_min']}); restart "
        f"{sd['restart_s']:.2f} s after the stall, calm after {sd['seconds']:.2f} s; RPC max "
        f"{sd['rpc_max_ms']:.1f} ms, p99 {sd['rpc_p99_ms']:.1f} ms ({sd['stall_rpcs']} during "
        f"the stall, max {sd['stall_rpc_max_ms']:.1f} ms); trips {sd['bp_trips']}; moved on "
        f"/metrics {sd['metrics_moved']}; health {sd['health']}; faults {sd['faults']}; {sd['s']:.1f} s",
        f"handoff ({smi}): {h['keys']} keys at half their limit on A (cuda, 2 lanes), [A] -> [A, B "
        f"(cuda-sharded, {BANKS} banks)]: {h['to_b']} moved, {h['kept']} kept, every one admitted "
        f"exactly the rest on its owner; coordinator {h['summary']['duration_s']:.3f} s; "
        f"/debug/cluster {h['views']}; journals {h['journal']}; {h['s']:.1f} s",
        f"handoff (full lane, {smi}): lane filled to {f['live_keys']} keys in {f['fill_s']:.2f} s "
        f"through the engine, not the served path (its launches {f['fill_launches']} are left out "
        f"of the phase's and the kernels line's); "
        f"the reference's way on it: export_keys {f['reference']['export_ms']:.1f} ms + its drop "
        f"(state round trip, table rebuild) {f['reference']['drop_ms']:.1f} ms exclusive, "
        f"import_keys of {f['reference']['moved']} keys {f['reference']['import_ms']:.1f} ms; "
        f"the port's during a {HANDOFF_CLIENTS}-client burst: {f['moved']} moved, {f['imported']} "
        f"imported in {f['handoff_s']:.3f} s, exclusive legs A {f['leg_count']['A']} (max "
        f"{f['leg_max_ms']['A']:.1f} ms) B {f['leg_count']['B']} (max {f['leg_max_ms']['B']:.1f} "
        f"ms), longest {f['legs']}; {f['rpcs']} RPCs, during (n, median, max) {f['inside']}, "
        f"outside {f['outside']}; longest interpreter-lock gap during the handoff "
        f"{f['lock_gap_ms']:.1f} ms; faults {f['faults']}",
        f"chaos twin ({smi}): {c['checks']} checks passed in {c['seconds']:.1f} s; controlled "
        f"quarantine {c['controlled']['quarantine_latency_s']} s, p99 {c['controlled']['p99_ms']} "
        f"ms, admitted {c['controlled']['probe_admitted']}/{c['controlled']['probe_limit']}; "
        f"uncontrolled max {c['uncontrolled']['max_ms']} ms, {c['uncontrolled']['cache_errors']} "
        f"failed; matrix {c['matrix']}",
    ]


# -- 14. the cluster's front tier: a port proxy in its own process ----------------

CLUSTER_CONFIG = """domain: ct
descriptors:
  - key: churn
    rate_limit: {unit: minute, requests_per_unit: 120}
  - key: bg
    rate_limit: {unit: minute, requests_per_unit: 1000000}
  - key: hop
    rate_limit: {unit: hour, requests_per_unit: 1000000}
"""
CHURN_LIMIT = 120
CHURN_HITS = 240  # offered to the target before the churn, and again after it
CHURN_CLIENTS = 4  # background clients through the proxy
CHURN_KEYS = 64  # background values each client cycles
HOP_PAIRS = 10
HOP_LEG = 100
#: The proxy's flags beyond the replicas file, the admin map and the ports.
PROXY_POLL_S = "0.1"
PROXY_START_S = 60.0
CLUSTER_ENV = {"CLUSTER_HANDOFF_ENABLED": "true"}
#: Where the replicas' banks live.
FRONT_TIER_DEVICE = "cuda"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProxyProcess:
    """`python -m ratelimit_tpu_torch.cluster.proxy` in a process of its
    own, its standard error in a file; `fail` prints that file's tail
    before failing the smoke, and leaving the block stops the process."""

    def __init__(self, tmp, replicas_file, admin, port, debug_port):
        self.port, self.debug_port = port, debug_port
        self.err_path = os.path.join(tmp, "proxy.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ratelimit_tpu_torch.cluster.proxy",
             "--replicas-file", replicas_file, "--replica-admin", admin,
             "--host", "127.0.0.1", "--port", str(port), "--debug-port", str(debug_port),
             "--poll-seconds", PROXY_POLL_S],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=self._err,
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._err.close()

    def tail(self, n=4000) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-n:]

    def fail(self, msg):
        log(f"proxy process (rc {self.proc.poll()}) stderr tail:\n{self.tail()}")
        fail(msg)

    def stats(self) -> dict:
        status, body = http_get(self.debug_port, "/stats.json")
        if status != 200:
            self.fail(f"proxy /stats.json answered {status}")
        return json.loads(body)

    def wait_serving(self, health_pb2, channel):
        """Seconds until gRPC health answers SERVING and the debug
        listener, which the proxy starts after its gRPC server, answers
        /healthcheck."""
        check = channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PROXY_START_S:
            if self.proc.poll() is not None:
                self.fail(f"the proxy exited with {self.proc.returncode} before serving")
            try:
                if (check(health_pb2.HealthCheckRequest(), timeout=2).status
                        == health_pb2.HealthCheckResponse.SERVING
                        and http_get(self.debug_port, "/healthcheck")[0] == 200):
                    return time.perf_counter() - t0
            except Exception:  # noqa: BLE001 -- not listening yet
                pass
            time.sleep(0.05)
        self.fail(f"the proxy did not serve within {PROXY_START_S:.0f} s")

    def maps_no_torch(self) -> bool:
        with open(f"/proc/{self.proc.pid}/maps") as f:
            maps = f.read()
        return not any(lib in maps for lib in ("libtorch", "libc10", "libcuda.so", "libcudart"))

    def terminate(self) -> int:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.fail("the proxy did not exit within 30 s of SIGTERM")


def write_replicas(path, ids):
    """Replace the replicas file in one rename, as the proxy's watcher asks."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(ids) + "\n")
    os.replace(tmp, path)


def hop_pairs(proxy_call, direct_call, values):
    """Warm µs a request via the proxy against direct to the owner, in
    HOP_PAIRS alternating pairs of HOP_LEG requests on `values`."""
    legs = {"proxy": [], "direct": []}
    for call in (proxy_call, direct_call):  # warm both paths
        for v in values[:20]:
            call("hop", v)
    for p in range(HOP_PAIRS):
        for side in ("proxy", "direct") if p % 2 == 0 else ("direct", "proxy"):
            call = proxy_call if side == "proxy" else direct_call
            t0 = time.perf_counter()
            for i in range(HOP_LEG):
                call("hop", values[i % len(values)])
            legs[side].append((time.perf_counter() - t0) / HOP_LEG * 1e6)
    return legs


def front_tier_phase(kernels, fw, smi):
    """Phase 14: runners A, B and C (BACKEND_TYPE=cuda at the default
    state size, CLUSTER_HANDOFF_ENABLED, one pinned clock) in this
    process and the port's proxy in another, over the replicas file [A,
    B] and an admin map of all three: the proxy hop against a direct
    call, membership churn with the target key exact, the handoff its
    coordinator drives over HTTP, /fleet.json, and SIGTERM."""
    import grpc

    from ratelimit_tpu_torch.cluster.hashing import owner_of
    from ratelimit_tpu_torch.server import pb  # noqa: F401

    from envoy.service.ratelimit.v3 import rls_pb2
    from grpchealth.v1 import health_pb2

    kernels.launches.clear()
    pinned = pinned_clock()
    cfg = {"ct.yaml": CLUSTER_CONFIG}
    OK = rls_pb2.RateLimitResponse.OK
    out = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        reps = {}
        for name in "ABC":
            runner, _request, _R = stack.enter_context(
                serving("cuda", env=CLUSTER_ENV, config=cfg, time_source=pinned)
            )
            reps[name] = runner
        for name, r in reps.items():
            s = r.settings
            devices = {e.device.type for e in r.cache.engines()}
            if devices != {FRONT_TIER_DEVICE} or (s.tpu_num_slots, s.tpu_algorithm_num_slots) != (NUM_SLOTS, ALGO_SLOTS):
                fail(f"front tier: replica {name} serves on {devices}, {s.tpu_num_slots} slots")
        ids = {n: f"127.0.0.1:{r.grpc_server.bound_port}" for n, r in reps.items()}
        admin = ",".join(f"{ids[n]}=http://127.0.0.1:{r.debug_server.bound_port}" for n, r in reps.items())
        replicas_file = os.path.join(tmp, "replicas.txt")
        write_replicas(replicas_file, [ids["A"], ids["B"]])
        stamped0 = {n: r.launches.stamped() for n, r in reps.items()}
        proxy = stack.enter_context(ProxyProcess(tmp, replicas_file, admin, free_port(), free_port()))
        channels = [stack.enter_context(grpc.insecure_channel(f"127.0.0.1:{proxy.port}"))
                    for _ in range(2 + CHURN_CLIENTS)]
        direct_channel = stack.enter_context(grpc.insecure_channel(ids["A"]))
        out["start_s"] = proxy.wait_serving(health_pb2, channels[0])
        out["maps_no_torch"] = proxy.maps_no_torch()
        if not out["maps_no_torch"]:
            proxy.fail("the proxy process maps a torch or CUDA library")

        def caller(channel):
            stub = channel.unary_unary(
                "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
                request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
                response_deserializer=rls_pb2.RateLimitResponse.FromString,
            )

            def call(key, value):
                req = rls_pb2.RateLimitRequest(domain="ct")
                e = req.descriptors.add().entries.add()
                e.key, e.value = key, value
                return stub(req, timeout=30)

            return call

        # 1. The hop: keys A owns under [A, B].
        ab, ac = [ids["A"], ids["B"]], [ids["A"], ids["C"]]
        hop_values = [f"h{i}" for i in range(10_000) if owner_of(f"ct_hop_h{i}_", ab) == 0][:50]
        out["hop"] = hop_pairs(caller(channels[0]), caller(direct_channel), hop_values)

        # 2. Membership churn: the target key is A's under [A, B] and C's
        # under [A, C].
        target = next(
            f"t{i}" for i in range(100_000)
            if owner_of(f"ct_churn_t{i}_", ab) == 0 and owner_of(f"ct_churn_t{i}_", ac) == 1
        )
        legs = {"A": [], "C": []}
        for n, log_ in legs.items():
            exclusive_timer(reps[n].cache, log_)
        rows, stop, errors = [], threading.Event(), []
        rows_lock = threading.Lock()

        def background(i):
            call, local, n = caller(channels[2 + i]), [], 0
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    call("bg", f"b{i}-{n % CHURN_KEYS}")
                    local.append((t0, time.perf_counter()))
                    n += 1
            except Exception as exc:  # noqa: BLE001 -- fails the phase below
                errors.append(repr(exc))
            with rows_lock:
                rows.extend(local)

        target_call = caller(channels[1])

        def offer(n):
            admitted = 0
            for _ in range(n):
                t0 = time.perf_counter()
                admitted += target_call("churn", target).overall_code == OK
                with rows_lock:
                    rows.append((t0, time.perf_counter()))
            return admitted

        bg = [threading.Thread(target=background, args=(i,)) for i in range(CHURN_CLIENTS)]
        for t in bg:
            t.start()
        with GilProbe() as probe:
            before = offer(CHURN_HITS)
            t_kill = time.perf_counter()
            reps["B"].stop()
            give_up = time.monotonic() + 15
            while proxy.stats()["ejections"] < 1 and time.monotonic() < give_up:
                time.sleep(0.02)
            at_kill = proxy.stats()
            t_swap = time.perf_counter()
            write_replicas(replicas_file, ac)
            give_up = time.monotonic() + 20
            while time.monotonic() < give_up:
                st = proxy.stats()
                if st["replica_ids"] == ac and "last_handoff" in st:
                    break
                time.sleep(0.02)
            t_done = time.perf_counter()
            after = offer(CHURN_HITS)
            stop.set()
            for t in bg:
                t.join(timeout=60)
        if errors or any(t.is_alive() for t in bg):
            proxy.fail(f"front tier: background clients failed: {errors[:3]}")
        st = proxy.stats()
        summary = st.get("last_handoff")
        if st["replica_ids"] != ac or summary is None:
            proxy.fail(f"front tier: the proxy did not swap to [A, C] with a handoff: {st}")
        inside = [(t1 - t0) * 1e3 for t0, t1 in rows if t1 > t_kill and t0 < t_done]
        outside = [(t1 - t0) * 1e3 for t0, t1 in rows if not (t1 > t_kill and t0 < t_done)]
        out["churn"] = dict(
            target=target, before=before, after=after, admitted=before + after,
            rpcs=len(rows), bg_rpcs=len(rows) - 2 * CHURN_HITS,
            ejections=at_kill["ejections"], failovers=at_kill["failovers"],
            fallback=at_kill["fallback_descriptors"], retries=at_kill["retries"],
            kill_to_eject_s=t_swap - t_kill, swap_to_handoff_s=t_done - t_swap,
            inside=(len(inside), float(np.median(inside)), max(inside)) if inside else (0, 0.0, 0.0),
            outside=(len(outside), float(np.median(outside)), max(outside)),
            lock_gap_ms=probe.max_gap_ms(t_kill, t_done),
            summary={k: summary.get(k) for k in ("moved_keys", "imported", "merged", "dropped",
                                                    "duration_s", "exports", "errors")},
            forwarded=st["forwarded"],
        )
        c = out["churn"]
        if c["admitted"] != CHURN_LIMIT:
            proxy.fail(f"front tier: the target admitted {c['admitted']} of {2 * CHURN_HITS} "
                       f"({before} before, {after} after), want exactly {CHURN_LIMIT}")
        if c["ejections"] < 1 or c["failovers"] < 1:
            proxy.fail(f"front tier: stopping B made {c['ejections']} ejections, {c['failovers']} failovers")
        if summary["imported"] + summary["merged"] < 1 or any(ids["B"] not in e for e in summary["errors"]):
            proxy.fail(f"front tier: handoff {summary}")

        # 3. The coordinator in the other process: the legs it drove here.
        views = {}
        for n in ("A", "C"):
            status, body = http_get(reps[n].debug_server.bound_port, "/debug/cluster")
            if status != 200:
                proxy.fail(f"front tier: {n}'s /debug/cluster answered {status}")
            view = json.loads(body)["handoff"]
            views[n] = dict(
                exported=view["exported_keys"], imported=view["imported_keys"], merged=view["merged_keys"],
                legs=len(legs[n]), leg_max_ms=max((ms for _f, ms in legs[n]), default=0.0),
                leg_ms=[round(ms, 3) for _f, ms in legs[n]],
                faults=fault_free(reps[n], f"front tier ({n})"),
            )
        out["coordinator"] = views
        if views["A"]["exported"] < 1 or views["C"]["imported"] + views["C"]["merged"] < 1:
            proxy.fail(f"front tier: /debug/cluster {views}")

        # 4. /fleet.json from the proxy's debug listener.
        status, body = http_get(proxy.debug_port, "/fleet.json")
        if status != 200:
            proxy.fail(f"front tier: /fleet.json answered {status}")
        fleet = json.loads(body)
        live = sorted(rid for rid, r in fleet["replicas"].items() if r.get("metrics", {}).get("up"))
        proxy_types = [e["type"] for e in fleet["events"] if e["replica"] == "_proxy"]
        order = [proxy_types.index(t) if t in proxy_types else None
                 for t in ("membership_change", "handoff_begin", "handoff_end")]
        names = {rid: n for n, rid in ids.items()}
        out["fleet"] = dict(
            live=[n for n in "ABC" if ids[n] in live], bytes=len(body),
            slo=sorted(fleet["slo"]["domains"]), proxy_events=proxy_types,
            # The merged timeline, oldest first.  A proxy row that names
            # a replica (replica_eject) carries that replica's id, as
            # the JAX package's merge gives it.
            timeline=[(names.get(e["replica"], e["replica"]), e["type"]) for e in fleet["events"]],
            quarantined=len(fleet["faults"]["quarantined_banks"]),
        )
        if len(live) < 2 or not all("domains" in fleet["replicas"][rid].get("slo", {}) for rid in live):
            proxy.fail(f"front tier: /fleet.json live replicas {live}")
        if None in order or order != sorted(order) or "ct" not in fleet["slo"]["domains"]:
            proxy.fail(f"front tier: /fleet.json timeline {proxy_types}, slo {fleet['slo']}")
        for n in ("A", "C"):
            if reps[n].launches.stamped() - stamped0[n] < 1:
                fail(f"front tier: replica {n} launched nothing")
        out["stamped"] = {n: reps[n].launches.stamped() - stamped0[n] for n in "ABC"}
        out["rc"] = proxy.terminate()
        if out["rc"] != 0:
            proxy.fail(f"front tier: the proxy exited {out['rc']} on SIGTERM")
    out["k1_lanes"] = kernels.launches.get(fw.K1_LANES, 0)
    if out["k1_lanes"] < 1:
        fail("front tier: no K1 by-value launch")
    return dict(kernels.launches), out


def front_tier_lines(o, smi) -> list:
    h, c, v, f = o["hop"], o["churn"], o["coordinator"], o["fleet"]

    def spread(x):
        return f"median {np.median(x):.1f}, min {min(x):.1f}, max {max(x):.1f}"

    diffs = [p - d for p, d in zip(h["proxy"], h["direct"])]
    s = c["summary"]
    return [
        f"front tier (hop, {smi}): the proxy process served {o['start_s']:.2f} s after its start and "
        f"maps no torch or CUDA library ({o['maps_no_torch']}); warm us/request on keys A owns, "
        f"{HOP_PAIRS} alternating pairs of {HOP_LEG}: via the proxy {spread(h['proxy'])}; direct "
        f"{spread(h['direct'])}; proxy - direct per pair {spread(diffs)}",
        f"front tier (churn, {smi}): the target ({CHURN_LIMIT}/minute) admitted {c['admitted']} of "
        f"{2 * CHURN_HITS} ({c['before']} before, {c['after']} after) beside {c['bg_rpcs']} RPCs of "
        f"{CHURN_CLIENTS} background clients; B stopped: {c['ejections']} ejection(s), {c['failovers']} "
        f"failover(s), {c['retries']} retries, {c['fallback']} fallback descriptors, seen in "
        f"{c['kill_to_eject_s']:.2f} s; [A, B] -> [A, C] swapped and handed off in "
        f"{c['swap_to_handoff_s']:.2f} s: moved {s['moved_keys']}, imported {s['imported']}, merged "
        f"{s['merged']}, dropped {s['dropped']}, coordinator {s['duration_s']} s, exports "
        f"{s['exports']}, errors {s['errors']}; forwarded {c['forwarded']}; RPC ms during the churn "
        f"(n, median, max) ({c['inside'][0]}, {c['inside'][1]:.2f}, {c['inside'][2]:.2f}), outside "
        f"({c['outside'][0]}, {c['outside'][1]:.2f}, {c['outside'][2]:.2f}); longest "
        f"interpreter-lock gap on the replicas' process {c['lock_gap_ms']:.1f} ms",
        f"front tier (coordinator in the proxy process, {smi}): " + "; ".join(
            f"{n}: exported {x['exported']}, imported {x['imported']}, merged {x['merged']}, "
            f"{x['legs']} exclusive legs {x['leg_ms']} ms (max {x['leg_max_ms']:.2f}), faults "
            f"{x['faults']['faults']}" for n, x in v.items()),
        f"front tier (/fleet.json, {smi}): {f['bytes']} bytes, live replicas {f['live']}, SLO domains "
        f"{f['slo']}, quarantined banks {f['quarantined']}, timeline {f['timeline']}; launch "
        f"records by replica {o['stamped']}, "
        f"K1 by value {o['k1_lanes']}; the proxy exited {o['rc']} on SIGTERM",
    ]


# -- phase 15: sanitized serving ------------------------------------------

SANITIZED_CLIENTS = 8  # gRPC clients, beside one /json client
SANITIZED_SECONDS = 5.0
SANITIZED_PAIRS = 10
SANITIZED_LEG = 50
SANITIZED_KEYS = ("obs_fw", "obs_sw", "obs_tb")
SANITIZED_TIMEOUT_S = 300
SANITIZED_RESULT = "SANITIZED_RESULT "


def sanitized_traffic(runner, OK, fd, dev_engine, disp):
    """SANITIZED_CLIENTS gRPC clients and one /json client over the
    fixed-window, sliding-window and GCRA keys for SANITIZED_SECONDS, with
    one forced periodic snapshot and one fault-domain probe half way;
    returns the requests answered by transport, the snapshots taken and
    the probe's answer.  Any refusal or error fails the child."""
    stop = threading.Event()
    sent = {"grpc": 0, "json": 0}
    lock = threading.Lock()
    errors = []

    def grpc_work(i, call):
        n = 0
        while not stop.is_set():
            key = SANITIZED_KEYS[n % 3]
            if call(key, f"s{i}-{n % 64}")[0] != OK:
                errors.append(f"{key} refused")
                break
            n += 1
        with lock:
            sent["grpc"] += n
        return n

    def json_work():
        client = JsonClient(runner.http_server.bound_port)
        n = 0
        try:
            while not stop.is_set():
                key = SANITIZED_KEYS[n % 3]
                if client.post(key, f"j-{n % 64}")[0] != 200:
                    errors.append(f"/json {key} refused")
                    break
                n += 1
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(repr(exc))
        finally:
            client.close()
        with lock:
            sent["json"] += n

    done = []  # grpc_clients' results: empty if it failed on its thread
    json_thread = threading.Thread(target=json_work)
    clients = threading.Thread(
        target=lambda: done.append(grpc_clients(runner, SANITIZED_CLIENTS, grpc_work))
    )
    json_thread.start()
    clients.start()
    time.sleep(SANITIZED_SECONDS / 2)
    snapshots = fd.snapshot_now()
    probe_ok = fd._probe(0, fd._records[0], dev_engine, disp)
    time.sleep(SANITIZED_SECONDS / 2)
    stop.set()
    clients.join(timeout=120)
    json_thread.join(timeout=120)
    if errors or not done or clients.is_alive() or json_thread.is_alive():
        fail(f"sanitized serving: clients failed: {errors[:3]}")
    return sent, snapshots, probe_ok


def sanitized_child() -> None:
    """Phase 15's child process: the port's lock sanitizer installed
    before any port module allocates a lock (torch is loaded first, so
    its waits for the card are patched too), then the default
    BACKEND_TYPE=cuda runner under traffic, one forced snapshot and one
    probe, and served us per request on it against a runner booted and
    driven with the sanitizer uninstalled, in alternating pairs.  Prints one
    SANITIZED_RESULT line; the parent judges it."""
    t0 = time.perf_counter()
    stages = {}

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stages[name] = round(now - t0, 2)
        t0 = now

    import torch  # noqa: F401  (before install: torch.cuda waits get wrapped)

    sys.path.insert(0, REPO)
    from ratelimit_tpu_torch.analysis import sanitizer

    san = sanitizer.install()
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.models import gcra
    from ratelimit_tpu_torch.models import sliding_window as sw

    kernels.build_all()
    stage("imports")
    out = {"stages": stages}
    with serving("cuda") as (runner, request, R):
        stage("boot")
        fd = runner.cache.fault_domain
        engine = runner.cache.engine
        disp = runner.cache._dispatchers[id(engine)]
        kernels.launches.clear()
        sent, snapshots, probe_ok = sanitized_traffic(runner, R.OK, fd, engine, disp)
        stage("traffic")
        out["launches"] = {
            k: kernels.launches.get(k, 0) for k in (fw.K1_LANES, sw.K4_LANES, gcra.K5_LANES)
        }
        out["all_launches"] = dict(kernels.launches)
        out.update(requests=sent, snapshots=snapshots, probe_ok=probe_ok)
        out["faults"] = fault_free(runner, "sanitized serving")
        # The cost of the tracking: this runner's locks are wrapped; one
        # booted with the sanitizer uninstalled has raw instance locks, and
        # its legs run uninstalled too (unpatched lock factories, sleeps,
        # Event and card waits).  The module-level locks, made at import
        # under the sanitizer, stay wrapped in both legs.
        san.uninstall()
        with serving("cuda") as (_u, plain_request, _R):
            san.install()
            stage("second_boot")
            us = {"sanitized": [], "unsanitized": []}
            legs = (("sanitized", request), ("unsanitized", plain_request))

            def leg(name, req, tag, n):
                if name == "unsanitized":
                    san.uninstall()
                t1 = time.perf_counter()
                for i in range(n):
                    req("obs_fw", f"{tag}-{i}")
                seconds = time.perf_counter() - t1
                san.install()
                return seconds / n * 1e6

            for name, req in legs:
                leg(name, req, "pair-warm", 20)
            for p in range(SANITIZED_PAIRS):
                for name, req in legs if p % 2 == 0 else legs[::-1]:
                    us[name].append(leg(name, req, f"pair{p}", SANITIZED_LEG))
            out["us_per_request"] = us
            stage("pairs")
        stage("second_stop")
    stage("stop")
    out["summary"] = san.summary()
    out["violations"] = [v.as_dict() for v in san.violations()]
    log(SANITIZED_RESULT + json.dumps(out))


def sanitized_phase() -> dict:
    """Phase 15 (sanitized serving): runs sanitized_child in a process of
    its own, so the patched lock factories never touch phases 1-14, and
    fails on a lock-order cycle, an unsanctioned blocking call under a
    lock (a wait for the card included), a child that does not exit 0,
    or a K1 / K4 / K5 by-value kernel never launched."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.sanitized_child()"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=SANITIZED_TIMEOUT_S,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        log(f"sanitized child stdout tail:\n{proc.stdout[-3000:]}")
        log(f"sanitized child stderr tail:\n{proc.stderr[-3000:]}")
        fail(f"sanitized serving: the child exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(SANITIZED_RESULT)]
    if len(lines) != 1:
        fail(f"sanitized serving: no result line: {proc.stdout[-2000:]}")
    out = json.loads(lines[0][len(SANITIZED_RESULT):])
    out["seconds"] = seconds
    for v in out["violations"]:
        log(f"sanitizer violation [{v['kind']}] {v['detail']} (thread {v['thread']})\n{v['stack']}")
    if out["violations"]:
        fail(f"sanitized serving: {len(out['violations'])} sanitizer violation(s): "
             f"{out['summary']['by_kind']}")
    missing = [k for k, n in out["launches"].items() if n < 1]
    if missing:
        fail(f"sanitized serving: no by-value launch of {missing}: {out['all_launches']}")
    if not out["probe_ok"] or out["snapshots"] < 1:
        fail(f"sanitized serving: snapshot {out['snapshots']}, probe {out['probe_ok']}")
    return out


def sanitized_lines(o, smi) -> list:
    s = o["summary"]
    us = o["us_per_request"]
    med = {k: float(np.median(v)) for k, v in us.items()}
    return [
        f"sanitized serving: child {o['seconds']:.1f} s (stages {o['stages']}); "
        f"{SANITIZED_CLIENTS} gRPC + 1 /json "
        f"clients for {SANITIZED_SECONDS:.0f} s answered {o['requests']}; forced "
        f"snapshots {o['snapshots']}, probe {'OK' if o['probe_ok'] else 'FAILED'}; "
        f"fault domain {o['faults']}",
        f"sanitized serving: sanitizer {s['locks']} locks tracked at {s['lock_sites']} "
        f"creation sites, {s['order_edges']} lock-order edges, {s['violations']} "
        f"violations {s['by_kind']}",
        f"sanitized serving: by-value launches {o['launches']} (all {o['all_launches']})",
        f"sanitized serving: warm us/request over {SANITIZED_PAIRS} alternating pairs of "
        f"{SANITIZED_LEG} requests, sanitized median {med['sanitized']:.1f} "
        f"(legs {[round(x, 1) for x in us['sanitized']]}) against unsanitized (booted and "
        f"driven uninstalled; the module-level locks stay wrapped in both) "
        f"{med['unsanitized']:.1f} (legs {[round(x, 1) for x in us['unsanitized']]}); "
        f"{smi}",
    ]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA GPU")
    if not os.path.isdir(os.path.join(REPO, "ratelimit_tpu_torch")):
        fail("ratelimit_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    laps = {}
    last = [time.perf_counter()]

    def lap(phase):
        """Note the wall seconds since the previous lap as `phase`'s."""
        now = time.perf_counter()
        laps[phase] = round(now - last[0], 1)
        last[0] = now

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    from ratelimit_tpu_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build_all()
    log(
        f"build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
    )
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    lap("build")

    # 3. kernels vs plain versions
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.ops import prefix_cuda
    from ratelimit_tpu_torch.ops.prefix import per_slot_inclusive_prefix

    from ratelimit_tpu_torch.models import gcra
    from ratelimit_tpu_torch.models import sliding_window as sw
    from ratelimit_tpu_torch.parallel import sharded as sh

    errs = check_kernels(torch, fw, prefix_cuda, per_slot_inclusive_prefix, dev)
    lap("check_kernels")
    log(
        f"kernels: exact for N in {SIZES} at 2^20 slots and 4096 at 2^24, "
        f"positive and negative slot ids; max|err| {errs}"
    )
    prefix_err = check_prefix(torch, prefix_cuda, per_slot_inclusive_prefix, dev)
    lap("check_prefix")
    errs[prefix_cuda.KERNEL] = max(errs[prefix_cuda.KERNEL], prefix_err)
    log(
        f"{prefix_cuda.KERNEL}: exact also for N in {PREFIX_EDGE_SIZES}, "
        f"distinct in (1, N/8, N), positive and negative ids, and on slots "
        f"{list(WRAP_SLOTS)} hits {[hex(h) for h in WRAP_HITS]} (u32 wrap inside "
        f"a segment); max|err| {prefix_err}"
    )
    algo_errs = check_algorithms(torch, sw, gcra, kernels, dev)
    lap("check_algorithms")
    log(
        f"algorithm kernels: exact for N in {SIZES} at 2^18 slots and 4096 at "
        f"2^24 over {len(ALGO_STEPS)} steps each; by value (readback into mapped "
        f"pinned memory) for N in {LANES_SIZES} at 2^18 and 2^24 slots over every "
        f"step, equal to the plain version and to the device form; a pageable "
        f"readback raises KernelError and a device one ValueError; max|err| {algo_errs}"
    )
    errs.update(algo_errs)
    sharded_errs = check_sharded(torch, sh, dev)
    lap("check_sharded")
    log(
        f"sharded routed step: exact over {BANKS} banks for N in {SIZES} at 2^20 "
        f"slots and 4096 at 2^24, uniform and all-one-bank routing, three "
        f"readback types; max|err| {sharded_errs}"
    )
    errs.update(sharded_errs)
    general_errs = check_general_step(torch, fw, sh, dev)
    lap("check_general_step")
    log(
        f"fused general step (one cooperative launch): exact on one table and over "
        f"{BANKS} banks, raw afters, u8 / u16 readback and the decision block, for N "
        f"in {SIZES + PREFIX_EDGE_SIZES} at 2^20 and 2^24 slots, duplicates over 1, "
        f"N/8, N slots with positive and negative ids, one slot fresh on its last "
        f"lane, a u32 wrap inside a segment, -1 beside ns - 1; max|err| {general_errs}"
    )
    errs.update(general_errs)
    form_errs, k6_lanes_cases = check_served_forms(torch, fw, sh, kernels, dev)
    lap("check_served_forms")
    for name, e in form_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    log(
        f"served step in both forms: K1 and K6 exact by value for N in "
        f"{LANES_SIZES} ({k6_lanes_cases} K6 cases fit {BANKS} banks x cap by "
        f"value), readback into mapped pinned memory, and in the device form for "
        f"N in {DEVICE_FORM_SIZES}, at 2^20 and 2^24 slots, three readback types; "
        f"pinned slices alias at their offset; a pageable readback raises "
        f"KernelError and a device one ValueError; max|err| {form_errs}"
    )
    mirror_errs = check_mirror(torch, dev)
    lap("check_mirror")
    log(
        f"host mirror (numpy, backends/host_engine.py) against the kernels on the "
        f"card: codes and remaining equal for fixed window (K1, 2^20 slots), "
        f"sliding window (K4) and GCRA (K5, 2^18 slots) over {len(ALGO_STEPS)} clock "
        f"steps x N in {MIRROR_WIDTHS}; max|err| {mirror_errs}"
    )

    timing, calls, extra = time_kernels(
        torch, fw, prefix_cuda, per_slot_inclusive_prefix, sw, gcra, sh, dev
    )
    lap("time_kernels")
    floor = extra["floor"]
    log(
        "launch floor (profiler device time of a one-element in-place torch "
        "add on the current stream, a yardstick the port never calls), min / "
        "median / max over 50 calls: "
        + (spread_us(floor) if floor else "not measured (no device activity)")
    )
    log(
        "per-call device time of every kernel (N=4096; the by-value forms at "
        "their served width), min / median / max over 50 calls: "
        + "; ".join(f"{k} {spread_us(v)}" for k, v in extra["samples"].items())
    )
    log(
        "the serving kernels at the served widths, min / median / max over 50 calls: "
        + "; ".join(
            f"{k} {spread_us(v) if v else 'not measured'} (bound {b[0] * 1e3:.4g} us by {b[1]})"
            for k, (v, b) in extra["served"].items()
        )
    )
    big = extra["prefix_big"]
    log(
        f"{prefix_cuda.KERNEL} at N={big['n']}: "
        + (spread_us(big["samples"]) if big["samples"] else "not measured")
        + " device (min / median / max over 50 calls); plain "
        + (f"{big['plain_ms'] * 1e3:.1f} us" if big["plain_ms"] else "not measured")
        + f"; bound {big['bound'][0] * 1e3:.4f} us by {big['bound'][1]}"
    )
    log(
        "kernel device times at N=4096, the by-value forms at 8 lanes "
        "(profiler): "
        + "; ".join(
            f"{k} {v['ms'] * 1e3:.2f} us (plain {v['plain_ms'] * 1e3:.1f} us, "
            f"bound {v['bound_ms'] * 1e3:.4g} us by {v['bound_by']})"
            for k, v in timing.items()
        )
    )
    log(
        "call times (as above; CUDA-event median of back-to-back calls, "
        "host enqueue included): "
        + "; ".join(
            f"{k} {c * 1e3:.2f} us (plain {p * 1e3:.1f} us)"
            for k, (c, p) in calls.items()
        )
    )

    # The served chunk, the engine's form: one by-value kernel, no memcpy.
    from ratelimit_tpu_torch.backends import engine as eng

    for (label, width), st in served_chunks(torch, sh, eng, sw, gcra, dev).items():
        log(served_chunk_line(label, width, st))
        if max(st["activities"]) != 1 or max(st["memcpys"]) != 0:
            fail(f"the engine's served chunk ({label}, {width} lanes) is not one kernel")
    lap("served_chunks")

    # 4. flagship forward step (main path b)
    fwd_launches, fwd_ms, n_over, fwd_acts = forward_phase(torch, fw, kernels, dev)
    lap("forward")
    log(
        f"forward: graft batch 2^20 slots x 4096 lanes exact vs plain and numpy; "
        f"{n_over} lanes OVER_LIMIT; {fwd_ms[0] * 1e3:.1f} us/step "
        f"(device {fwd_ms[1] * 1e3 if fwd_ms[1] else float('nan'):.1f} us); "
        f"launches {fwd_launches}; per step over {STEP_CAPTURE} profiled steps {fwd_acts}"
    )

    # 5. sharded forward step
    shf_launches, shf_ms, shf_acts = sharded_forward_phase(torch, fw, sh, kernels, dev)
    lap("sharded_forward")
    log(
        f"sharded forward: graft batch over {BANKS} banks equals the single-table "
        f"forward step and the sharded plain version, table too; "
        f"{shf_ms[0] * 1e3:.1f} us/step "
        f"(device {shf_ms[1] * 1e3 if shf_ms[1] else float('nan'):.1f} us); "
        f"launches {shf_launches}; per step over {STEP_CAPTURE} profiled steps {shf_acts}"
    )

    # 6. served path (main path a)
    srv_launches, lanes, us_per_req, us_per_algo_req, shadow_moved, forms, srv_faults = (
        served_phase(torch, kernels, fw, sw, gcra)
    )
    lap("served")
    log(
        f"served: 6th hit OVER_LIMIT on fixed-window, sliding-window, GCRA and "
        f"shadow-GCRA keys (shadow gcra agree/diverge +{shadow_moved}), burst "
        f"coalesced up to {lanes} lanes/launch, warm {us_per_req:.1f} us/request "
        f"(fixed window), {us_per_algo_req:.1f} us/request (GCRA); "
        f"launches {srv_launches}; by form, per key: "
        + "; ".join(
            f"{key}: one-descriptor requests{' and the burst' if key == 'foo' else ''} "
            f"{f[0]}, a {WIDE_DESCRIPTORS}-descriptor request {f[2]}, 50 requests made "
            f"{f[1][2]} by-value launches, the profiler saw {f[1][0]} kernels and "
            f"{f[1][1]} memcpys on the card"
            for key, f in forms.items()
        )
        + f"; fault domain armed at KERNEL_DEADLINE_S={DEFAULT_DEADLINE_S}: {srv_faults}"
    )

    # 7. sharded served path
    shs_launches, sh_lanes, sh_us_per_req, sh_forms, shs_faults = sharded_served_phase(
        torch, kernels, sh, dev
    )
    lap("sharded_served")
    log(
        f"sharded served: 2^20 slots over {BANKS} banks, 6th hit OVER_LIMIT with "
        f"remaining [4, 3, 2, 1, 0, 0], 40 keys live in all {BANKS} banks, burst "
        f"coalesced up to {sh_lanes} lanes/launch, warm {sh_us_per_req:.1f} "
        f"us/request (fixed window); launches {shs_launches}; by form: "
        f"one-descriptor requests and the burst {sh_forms[0]}, a "
        f"{WIDE_DESCRIPTORS}-descriptor request {sh_forms[2]}; 50 requests made "
        f"{sh_forms[1][2]} by-value launches, the profiler saw {sh_forms[1][0]} "
        f"kernels and {sh_forms[1][1]} memcpys on the card; fault domain armed at "
        f"KERNEL_DEADLINE_S={DEFAULT_DEADLINE_S}: {shs_faults}"
    )

    # 8. the fault domain on the card
    flt_launches, episodes, cycles_per_ms = fault_phase(torch, kernels, fw, gcra)
    lap("fault")
    log(
        f"fault phase: torch.cuda._sleep spins {cycles_per_ms:.0f} cycles/ms; launches "
        f"{flt_launches}"
    )
    for name, e in episodes.items():
        log(episode_line(name, e))

    # 9. the HTTP and debug listeners
    k1_ms = timing[fw.K1_LANES]["ms"]
    lst_launches, listeners = listeners_phase(torch, kernels, fw, sw, gcra, k1_ms)
    lap("listeners")
    log(f"listeners: launches {lst_launches}")
    for line in listeners_lines(listeners, k1_ms):
        log(line)

    # 10. the bank topology: lanes, the per-second bank, checkpoint files
    top_launches, topology = topology_phase(torch, kernels, fw, cycles_per_ms)
    lap("topology")
    log(f"topology: launches {top_launches}")
    for line in topology_lines(topology):
        log(line)

    # 11. the write-behind and memory backends
    wb_launches, write_behind = write_behind_phase(torch, kernels, fw, sh, dev, cycles_per_ms)
    lap("write_behind")
    log(f"write-behind and memory: launches {wb_launches}")
    for line in write_behind_lines(write_behind):
        log(line)

    # 12. the observability planes
    obs_launches, planes = planes_phase(torch, kernels, fw, cycles_per_ms, smi)
    lap("observability")
    log(f"observability: launches {obs_launches}")
    for line in planes_lines(planes, smi):
        log(line)

    # 13. overload control and the replica half of the cluster tier
    ovl_launches, overload = overload_phase(torch, kernels, fw, cycles_per_ms)
    lap("overload")
    log(f"overload and handoff: launches {ovl_launches}")
    for line in overload_lines(overload, smi):
        log(line)

    # 14. the cluster's front tier: a port proxy in its own process
    ft_launches, front = front_tier_phase(kernels, fw, smi)
    lap("front_tier")
    log(f"front tier: launches {ft_launches}")
    for line in front_tier_lines(front, smi):
        log(line)

    # 15. sanitized serving: the default runner under the port's lock
    # sanitizer, in a child process
    sanitized = sanitized_phase()
    lap("sanitized")
    for line in sanitized_lines(sanitized, smi):
        log(line)

    phases = (
        fwd_launches, shf_launches, srv_launches, shs_launches, flt_launches, lst_launches,
        top_launches, wb_launches, obs_launches, ovl_launches, ft_launches,
    )
    main_launches = {
        k: sum(p.get(k, 0) for p in phases) for k in set().union(*phases)
    }
    # The fused general step runs the bodies of K2, the K3 update and
    # decide, and K7: its launches count for each body it runs.
    bodies = {
        prefix_cuda.KERNEL: (prefix_cuda.KERNEL, fw.K3_UPDATE, fw.K3_STEP, sh.K7, sh.K7_STEP),
        fw.K3_UPDATE: (fw.K3_UPDATE, fw.K3_STEP),
        fw.K3_DECIDE: (fw.K3_DECIDE, fw.K3_STEP, sh.K7_STEP),
        sh.K7: (sh.K7, sh.K7_STEP),
    }
    fused = "ratelimit_tpu_torch/csrc/counter_update.cuh"
    replaces = {
        fw.K1: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:171"),
        fw.K1_LANES: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:171"),
        prefix_cuda.KERNEL: ("ratelimit_tpu_torch/csrc/prefix.cu", "ratelimit_tpu/ops/prefix_pallas.py:82"),
        fw.K3_UPDATE: (fused, "ratelimit_tpu/models/fixed_window.py:247"),
        fw.K3_DECIDE: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:294"),
        fw.K3_STEP: (fused, "ratelimit_tpu/models/fixed_window.py:282"),
        sw.K4: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/sliding_window.py:71"),
        sw.K4_LANES: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/sliding_window.py:71"),
        gcra.K5: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/gcra.py:87"),
        gcra.K5_LANES: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/gcra.py:87"),
        sh.K6: ("ratelimit_tpu_torch/csrc/sharded.cu", "ratelimit_tpu/parallel/sharded.py:184"),
        sh.K6_LANES: ("ratelimit_tpu_torch/csrc/sharded.cu", "ratelimit_tpu/parallel/sharded.py:184"),
        sh.K7: (fused, "ratelimit_tpu/parallel/sharded.py:270"),
        sh.K7_STEP: (fused, "ratelimit_tpu/parallel/sharded.py:308"),
    }
    rows = []
    for name, (source, rep) in replaces.items():
        launches = sum(main_launches.get(k, 0) for k in bodies.get(name, (name,)))
        if launches < 1:
            fail(f"{name} never launched on the main path")
        rows.append(
            dict(
                name=name,
                route="cuda",
                source=source,
                replaces=rep,
                launches=launches,
                max_abs_err=errs[name],
                **timing[name],
            )
        )
    log(f"total: {time.perf_counter() - started:.1f} s wall; seconds by phase {laps}")
    log(json.dumps({"kernels": rows}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
