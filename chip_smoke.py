#!/usr/bin/env python3
"""Smoke run of ratelimit_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each; any failure exits non-zero:

1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from csrc/, one nvcc per source in parallel;
3. kernels: each kernel against its plain PyTorch version on the card,
   same seeded inputs, exact equality (integer arithmetic and IEEE f32
   steps in one fixed order: the tolerance is 0).  K1-K3 for N in {8,
   100, 128, 4096} at 2^20 slots and once at 2^24 slots, with positive
   and then with negative slot ids; K2 also at the sizes its triangular
   tiling can get wrong, N in {1, 127, 129, 4097, 16384}, and on a batch
   whose running sum wraps u32 inside a segment; the algorithm-bank kernels K4
   (sliding window) and K5 (GCRA) for the same N at 2^18 slots (the
   bank default) and 4096 at 2^24, over several steps with the clock
   advancing through same, adjacent and older windows, with fresh,
   padding, saturated and limit-0 lanes and ids in [-ns, -1]; the
   bank-sharded kernels K6 (routed serving step) and K7 (general update
   over global ids, and its compact u8/u16 readback) over 8 banks for
   the same N at 2^20 slots and 4096 at 2^24, with uniform and
   all-one-bank routing, fresh, padding, saturated, duplicate,
   out-of-table and negative ids; profiler device times at 4096, beside
   the launch floor (a one-element in-place torch add), with min /
   median / max per call for K2, K3 update and K7, and K2 at 16384;
4. forward: the flagship forward step (the __graft_entry__ batch: 2^20
   slots, 4096 lanes, seed 0, 10% fresh) through K2 and K3 on the card,
   against the plain version and an independent numpy reference;
5. sharded forward: the same batch through the bank-sharded model (8
   banks on the card) -- K7, K2 and K3's decision block -- against the
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
   GCRA key;
7. sharded served: the runner with BACKEND_TYPE=cuda-sharded, 2^20
   slots over a mesh of 8 banks on the card -- the 6th hit on a 5/min
   key is OVER_LIMIT with remaining [4, 3, 2, 1, 0, 0], 40 keys leave a
   live counter in every bank, a concurrent burst coalesces into
   multi-lane K6 launches -- and the warm microseconds per request.

Kernel launch counts are zeroed just before each main-path phase (4-7)
and read just after: every kernel must have run there.  The last lines
are a JSON summary of the kernels and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, and the non-tensor-core 32-bit rate used for the integer
# compare/add work of these kernels.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SIZES = (8, 100, 128, 4096)
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
    records; None when the profiler sees no device activity.  The
    activities are cut in time order into `iters` equal groups, one per
    call; where their count does not divide, every call gets the mean."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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
        return None
    if len(us) % iters:
        return [sum(us) / iters / 1e3] * iters
    k = len(us) // iters
    return [sum(us[c * k : (c + 1) * k]) / 1e3 for c in range(iters)]


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
    err = {fw.K1: 0, prefix_cuda.KERNEL: 0, fw.K3_UPDATE: 0, fw.K3_DECIDE: 0}

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
                ck, cp = base.clone(), base.clone()
                ak = fw.fw_general_update(ck, slots, hits, fresh)
                ap = fw._update_plain(cp, slots, hits, fresh)
                what = f"n={n} ns={ns} d={distinct} negative ids={neg}"
                note(fw.K3_UPDATE, ak, ap, "afters " + what)
                note(fw.K3_UPDATE, ck, cp, "table " + what)
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


def check_algorithms(torch, sw, gcra, dev):
    """K4 and K5 against their plain versions, several steps each with
    the clock advancing (ALGO_STEPS); returns max |err| by kernel."""
    rng = np.random.default_rng(2025)
    steps = {sw.K4: (sw.sw_serve_step, sw._sw_step_plain, "sw"),
             gcra.K5: (gcra.gcra_serve_step, gcra._gcra_step_plain, "gcra")}
    err = {name: 0 for name in steps}
    for name, (kernel, plain, algo) in steps.items():
        for ns, sizes in ((ALGO_SLOTS, SIZES), (BIG_SLOTS, (4096,))):
            for n in sizes:
                pool = rng.choice(ns, 2 * n, replace=False)
                sk = _algo_state(torch, rng, algo, ns, pool, dev)
                sp = sk.clone()
                for dt in ALGO_STEPS:
                    now = ALGO_NOW + dt
                    pk = _algo_packed(torch, rng, n, ns, pool, dev)
                    for what, a, b in (
                        ("out", kernel(sk, pk, now), plain(sp, pk, now)),
                        ("state", sk, sp),
                    ):
                        e = u32_max_abs_err(a, b)
                        err[name] = max(err[name], e)
                        if e != 0:
                            fail(
                                f"{name} disagrees with its plain version ({what} "
                                f"n={n} ns={ns} now=+{dt}): max|err|={e}"
                            )
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
    """K6 and K7 against their plain versions over BANKS banks; returns
    max |err| by kernel."""
    rng = np.random.default_rng(2026)
    err = {sh.K6: 0, sh.K7: 0}

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
            limits = torch.from_numpy(rng.integers(1, 300, n).astype(np.int32)).to(dev)
            for distinct, dt in itertools.product((1, max(1, n // 8), n), ("", "uint8", "uint16")):
                # pads ns + i past the table, about a third of the live
                # lanes negative (out of a sharded table), duplicates
                slots, hits, fresh = _dup_lanes(torch, rng, n, ns, dev, distinct, neg=True)
                ck, cp = base.clone(), base.clone()
                what = f"n={n} ns={ns} d={distinct} dtype={dt!r}"
                note(sh.K7, sh.sharded_general_update(ck, slots, hits, fresh, limits, dt),
                     sh._general_update_plain(cp, slots, hits, fresh, limits, dt), "out " + what)
                note(sh.K7, ck, cp, "table " + what)
    torch.cuda.synchronize()
    return err


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


def time_kernels(torch, fw, prefix_cuda, prefix_plain, sw, gcra, sh, dev):
    """Median ms of each kernel and its plain version at 4096 lanes and
    2^20 slots (K4, K5: 2^18, the bank default), plus the bound of each
    (larger of bytes over HBM rate and operations over the 32-bit
    peak), from this run's inputs.  Also returns, as `extra`: the launch
    floor (a one-element in-place torch add, which the port never
    calls), the per-call device times of K2, K3 update and K7 (for their
    spread), and K2 at 16384 lanes."""
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
        # K2 and the two updates that run it: 50 calls, kept for their
        # spread.
        spread = name in (prefix_cuda.KERNEL, fw.K3_UPDATE, sh.K7)
        per_call = device_samples(k, iters=50 if spread else 20)
        if spread and per_call is not None:
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

    ans = ALGO_SLOTS
    pool = rng.choice(ans, 2 * n, replace=False)
    apk = _algo_packed(torch, rng, n, ans, pool, dev)
    in_table = (apk[0] >= -ans) & (apk[0] < ans)
    a_live = int(in_table.sum().item())
    a_kept = int((in_table & (apk[3] == 0)).sum().item())  # K5 skips fresh
    s1 = _algo_state(torch, rng, "sw", ans, pool, dev)
    s2 = s1.clone()
    row(
        sw.K4,
        lambda: sw.sw_serve_step(s1, apk, ALGO_NOW),
        lambda: sw._sw_step_plain(s2, apk, ALGO_NOW),
        # packed rows slot, hits, fresh, divider (never the limit row),
        # gather, scatter, out
        16 * n + 12 * a_live + 12 * a_live + 8 * n,
        20 * n,  # ~20 integer and f32 operations per lane (csrc/algorithms.cu)
    )
    g1 = _algo_state(torch, rng, "gcra", ans, pool, dev)
    g2 = g1.clone()
    row(
        gcra.K5,
        lambda: gcra.gcra_serve_step(g1, apk, ALGO_NOW),
        lambda: gcra._gcra_step_plain(g2, apk, ALGO_NOW),
        20 * n + 8 * a_kept + 8 * a_live + 4 * n,
        40 * n,  # ~40 operations per lane
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
    row(
        sh.K7,
        lambda: sh.sharded_general_update(b1, slots, hits, fresh),
        lambda: sh._general_update_plain(b2, slots, hits, fresh, None, ""),
        9 * n + 8 * distinct + 4 * n,  # the same work as K3's update
        prefix_ops(n) + 4 * n,
    )
    return rows, calls, dict(floor=floor, samples=samples, prefix_big=prefix_big)


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


def forward_phase(torch, fw, kernels, dev):
    raw, batch = graft_device_batch(torch, fw, dev)
    model = fw.FixedWindowModel(NUM_SLOTS, device=dev)
    counts = model.init_state()
    torch.cuda.synchronize()
    kernels.launches.clear()
    counts, dec = model.forward(counts, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in (fw.K3_UPDATE, fw.K3_DECIDE, "per_slot_inclusive_prefix"):
        if launches.get(name, 0) < 1:
            fail(f"forward step did not launch {name}: {launches}")

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
    ms = (time_ms(step, reps=10, inner=20), device_ms(step))
    return launches, ms, int((got_codes == 2).sum())


# -- phase 5: the sharded forward step -----------------------------------


def sharded_forward_phase(torch, fw, sh, kernels, dev):
    """The graft batch through the bank-sharded model (K7, K2, K3
    decide).  Its ids are all in the table, where the sharded and the
    single-table steps agree exactly."""
    _, batch = graft_device_batch(torch, fw, dev)
    model = sh.ShardedFixedWindowModel(NUM_SLOTS, sh.make_mesh(BANKS, dev))
    counts = model.init_state()
    torch.cuda.synchronize()
    kernels.launches.clear()
    counts, dec = model.step(counts, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in (sh.K7, "per_slot_inclusive_prefix", fw.K3_DECIDE):
        if launches.get(name, 0) < 1:
            fail(f"sharded forward step did not launch {name}: {launches}")

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
    return launches, (time_ms(step, reps=10, inner=20), device_ms(step))


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
"""

SHADOW_COUNTERS = ("ratelimit.tpu.shadow.gcra.agree", "ratelimit.tpu.shadow.gcra.diverge")


@contextlib.contextmanager
def serving(backend: str, **runner_kwargs):
    """The runner in-process with BACKEND_TYPE=`backend` serving CONFIG
    (TPU_NUM_SLOTS and TPU_ALGORITHM_BANKS at their defaults); yields
    (runner, request(key, value, hits=0) over one gRPC channel, the
    response class)."""
    import grpc

    with tempfile.TemporaryDirectory() as root:
        cfg = os.path.join(root, "ratelimit", "config")
        os.makedirs(cfg)
        with open(os.path.join(cfg, "rl.yaml"), "w") as f:
            f.write(CONFIG)
        for name in ("TPU_ALGORITHM_BANKS", "TPU_NUM_SLOTS"):
            os.environ.pop(name, None)
        os.environ.update(
            BACKEND_TYPE=backend,
            KERNEL_DEADLINE_S="0",
            RUNTIME_ROOT=root,
            RUNTIME_SUBDIRECTORY="ratelimit",
            GRPC_HOST="127.0.0.1",
            GRPC_PORT="0",
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

                def request(key, value, hits=0):
                    req = rls_pb2.RateLimitRequest(domain="rl", hits_addend=hits)
                    e = req.descriptors.add().entries.add()
                    e.key, e.value = key, value
                    return call(req, timeout=60)

                yield runner, request, rls_pb2.RateLimitResponse
        finally:
            runner.stop()


def six_hits(request, key, value):
    """Six hits on a 5/min key inside one minute window: the responses."""
    if time.time() % 60 > 50:
        time.sleep(61 - time.time() % 60)
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


def served_phase(kernels, fw, sw, gcra):
    kernels.launches.clear()
    with serving("cuda") as (runner, request, R):
        OK, OVER = R.OK, R.OVER_LIMIT
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
    launches = dict(kernels.launches)
    for name in (fw.K1, sw.K4, gcra.K5):
        if launches.get(name, 0) < 1:
            fail(f"served path did not launch {name}: {launches}")
    return launches, lanes, us_per_req, us_per_algo_req, shadow_moved


def sharded_served_phase(kernels, sh, dev):
    """BACKEND_TYPE=cuda-sharded: 2^20 slots over BANKS banks on the card."""
    kernels.launches.clear()
    mesh = sh.make_mesh(BANKS, dev)
    with serving("cuda-sharded", device=dev, mesh=mesh) as (runner, request, R):
        OK, OVER = R.OK, R.OVER_LIMIT
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
    launches = dict(kernels.launches)
    if launches.get(sh.K6, 0) < 1:
        fail(f"sharded served path did not launch {sh.K6}: {launches}")
    return launches, lanes, us_per_req


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

    # 3. kernels vs plain versions
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.ops import prefix_cuda
    from ratelimit_tpu_torch.ops.prefix import per_slot_inclusive_prefix

    from ratelimit_tpu_torch.models import gcra
    from ratelimit_tpu_torch.models import sliding_window as sw
    from ratelimit_tpu_torch.parallel import sharded as sh

    errs = check_kernels(torch, fw, prefix_cuda, per_slot_inclusive_prefix, dev)
    log(
        f"kernels: exact for N in {SIZES} at 2^20 slots and 4096 at 2^24, "
        f"positive and negative slot ids; max|err| {errs}"
    )
    prefix_err = check_prefix(torch, prefix_cuda, per_slot_inclusive_prefix, dev)
    errs[prefix_cuda.KERNEL] = max(errs[prefix_cuda.KERNEL], prefix_err)
    log(
        f"{prefix_cuda.KERNEL}: exact also for N in {PREFIX_EDGE_SIZES}, "
        f"distinct in (1, N/8, N), positive and negative ids, and on slots "
        f"{list(WRAP_SLOTS)} hits {[hex(h) for h in WRAP_HITS]} (u32 wrap inside "
        f"a segment); max|err| {prefix_err}"
    )
    algo_errs = check_algorithms(torch, sw, gcra, dev)
    log(
        f"algorithm kernels: exact for N in {SIZES} at 2^18 slots and 4096 at "
        f"2^24 over {len(ALGO_STEPS)} steps each; max|err| {algo_errs}"
    )
    errs.update(algo_errs)
    sharded_errs = check_sharded(torch, sh, dev)
    log(
        f"sharded kernels: exact over {BANKS} banks for N in {SIZES} at 2^20 "
        f"slots and 4096 at 2^24, uniform and all-one-bank routing, three "
        f"readback types; max|err| {sharded_errs}"
    )
    errs.update(sharded_errs)
    timing, calls, extra = time_kernels(
        torch, fw, prefix_cuda, per_slot_inclusive_prefix, sw, gcra, sh, dev
    )
    floor = extra["floor"]
    log(
        "launch floor (profiler device time of a one-element in-place torch "
        "add on the current stream, a yardstick the port never calls), min / "
        "median / max over 50 calls: "
        + (spread_us(floor) if floor else "not measured (no device activity)")
    )
    log(
        "per-call device time at N=4096, min / median / max over 50 calls: "
        + "; ".join(f"{k} {spread_us(v)}" for k, v in extra["samples"].items())
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
        "kernel device times at N=4096 (profiler): "
        + "; ".join(
            f"{k} {v['ms'] * 1e3:.2f} us (plain {v['plain_ms'] * 1e3:.1f} us, "
            f"bound {v['bound_ms'] * 1e3:.3f} us by {v['bound_by']})"
            for k, v in timing.items()
        )
    )
    log(
        "call times at N=4096 (CUDA-event median of back-to-back calls, "
        "host enqueue included): "
        + "; ".join(
            f"{k} {c * 1e3:.2f} us (plain {p * 1e3:.1f} us)"
            for k, (c, p) in calls.items()
        )
    )

    # 4. flagship forward step (main path b)
    fwd_launches, fwd_ms, n_over = forward_phase(torch, fw, kernels, dev)
    log(
        f"forward: graft batch 2^20 slots x 4096 lanes exact vs plain and numpy; "
        f"{n_over} lanes OVER_LIMIT; {fwd_ms[0] * 1e3:.1f} us/step "
        f"(device {fwd_ms[1] * 1e3 if fwd_ms[1] else float('nan'):.1f} us); "
        f"launches {fwd_launches}"
    )

    # 5. sharded forward step
    shf_launches, shf_ms = sharded_forward_phase(torch, fw, sh, kernels, dev)
    log(
        f"sharded forward: graft batch over {BANKS} banks equals the single-table "
        f"forward step and the sharded plain version, table too; "
        f"{shf_ms[0] * 1e3:.1f} us/step "
        f"(device {shf_ms[1] * 1e3 if shf_ms[1] else float('nan'):.1f} us); "
        f"launches {shf_launches}"
    )

    # 6. served path (main path a)
    srv_launches, lanes, us_per_req, us_per_algo_req, shadow_moved = served_phase(
        kernels, fw, sw, gcra
    )
    log(
        f"served: 6th hit OVER_LIMIT on fixed-window, sliding-window, GCRA and "
        f"shadow-GCRA keys (shadow gcra agree/diverge +{shadow_moved}), burst "
        f"coalesced up to {lanes} lanes/launch, warm {us_per_req:.1f} us/request "
        f"(fixed window), {us_per_algo_req:.1f} us/request (GCRA); "
        f"launches {srv_launches}"
    )

    # 7. sharded served path
    shs_launches, sh_lanes, sh_us_per_req = sharded_served_phase(kernels, sh, dev)
    log(
        f"sharded served: 2^20 slots over {BANKS} banks, 6th hit OVER_LIMIT with "
        f"remaining [4, 3, 2, 1, 0, 0], 40 keys live in all {BANKS} banks, burst "
        f"coalesced up to {sh_lanes} lanes/launch, warm {sh_us_per_req:.1f} "
        f"us/request (fixed window); launches {shs_launches}"
    )

    phases = (fwd_launches, shf_launches, srv_launches, shs_launches)
    main_launches = {
        k: sum(p.get(k, 0) for p in phases) for k in set().union(*phases)
    }
    replaces = {
        fw.K1: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:171"),
        prefix_cuda.KERNEL: ("ratelimit_tpu_torch/csrc/prefix.cu", "ratelimit_tpu/ops/prefix_pallas.py:82"),
        fw.K3_UPDATE: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:247"),
        fw.K3_DECIDE: ("ratelimit_tpu_torch/csrc/fixed_window.cu", "ratelimit_tpu/models/fixed_window.py:294"),
        sw.K4: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/sliding_window.py:70"),
        gcra.K5: ("ratelimit_tpu_torch/csrc/algorithms.cu", "ratelimit_tpu/models/gcra.py:86"),
        sh.K6: ("ratelimit_tpu_torch/csrc/sharded.cu", "ratelimit_tpu/parallel/sharded.py:184"),
        sh.K7: ("ratelimit_tpu_torch/csrc/sharded.cu", "ratelimit_tpu/parallel/sharded.py:270"),
    }
    rows = []
    for name, (source, rep) in replaces.items():
        launches = main_launches.get(name, 0)
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
    log(f"total: {time.perf_counter() - started:.1f} s wall")
    log(json.dumps({"kernels": rows}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": 1,  # the one card this run uses
                },
            }
        )
    )


if __name__ == "__main__":
    main()
