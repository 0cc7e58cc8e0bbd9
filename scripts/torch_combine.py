#!/usr/bin/env python3
"""The combine (``sharded_combine``) against ``torch.sum`` and earlier
designs, on the card.

    python3 scripts/torch_combine.py [--pairs 10] [--n 4096]
    python3 scripts/torch_combine.py --rehearsal [--repo <checkout>]
    python3 scripts/torch_combine.py --diagnose

The combine stands in for K7's ``psum`` where a card cannot map the home
card.  Inputs are chip_smoke.py's phase 16 shapes (``group_kernel_rows``):
8 banks of a 2^20-slot table in 4 groups on the card, ``--n`` lanes of
duplicates with pads past the table, the decision block's layout, every
lane written by K7's card step of its owner's groups.  Legs:

- ``parent``: the PR 18 kernel (``scripts/torch_combine.cu``,
  ``rl_parent_combine``) on its stage u8[4, stride], each group's lanes
  in its own row, into a new output;
- ``sum4``: ``torch.sum(stage, 0, dtype=torch.uint8)`` on that stage,
  the nearest PyTorch call then (the stage starts at 0 and each row
  holds only its group's lanes, so the bytewise sum is the select);
- ``shipped``: the package's ``sharded_combine`` on the phase's
  rehearsal of a card without a peer mapping (``unmapped_cards``):
  groups {0, 2} stored in place into the home output, groups {1, 3}
  into one partial, their lanes put into the output in place;
- ``lane1`` and ``lane4``: the same select at 1 and 4 lanes a thread
  (``rl_probe_combine``), one of them the shipped kernel;
- ``sum2``: ``torch.sum`` over the output and the partial stacked, each
  zero off its own lanes: the same function on the same inputs.

Each leg is first held bit for bit against the plain version, then timed
in ``--pairs`` alternating pairs (legs in order, then backwards): the
profiler's device time a call (median of 50 a leg).  Prints the card's
name and power limit, each leg's medians, the per-pair differences, and
one JSON line with every number.

``--rehearsal`` times phase 16's rehearsal step instead -- K7's card
step over 4 groups on the card with groups {1, 3} as a card without a
peer mapping, the graft batch, the decision block -- with the package
and chip_smoke.py helpers of ``--repo`` (default: this checkout), so a
parent checkout runs its own design: device activities, memcpys and
busy µs a step over 20 profiled steps, and the call time.

``--diagnose`` runs chip_smoke.py's phase 16 kernel rows
(``group_kernel_rows``) with each profiler capture of its
``device_samples`` recorded, and prints, for every capture that saw the
combine, how many activities it saw against the calls it made and their
durations; then the same combine call timed as the pairs time it, in the
same process.  It says whether the smoke's row and the pairs differ by
lost activities or by the kernel's own time.
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
SOURCE = os.path.join(HERE, "scripts", "torch_combine.cu")


def _chip_smoke(repo):
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def build(kernels):
    """The probe library, built once a digest of its source and the
    port's kernel sources and headers."""
    h = hashlib.sha256()
    csrc = sorted(f for f in os.listdir(kernels.CSRC_DIR) if f.endswith((".cu", ".cuh")))
    for path in (SOURCE, *(os.path.join(kernels.CSRC_DIR, f) for f in csrc)):
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"libcombine_probe-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", so, SOURCE]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        print("\n".join(line for line in (done.stdout + done.stderr).splitlines()
                        if "combine" in line or "error" in line or "registers" in line), flush=True)
        if done.returncode:
            sys.exit(f"nvcc failed ({done.returncode})")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rl_parent_combine.argtypes = [vp, i64, i32, vp, i32, i64, i32, i32, i32, i32, vp, vp]
    lib.rl_parent_combine.restype = ctypes.c_int
    lib.rl_probe_combine.argtypes = [i32, vp, vp, i64, i32, vp, i32, vp, i32, i64, i32, i32, i32,
                                     i32, vp]
    lib.rl_probe_combine.restype = ctypes.c_int
    return lib


def rehearsal(repo: str) -> None:
    """Phase 16's rehearsal step with `repo`'s package and smoke helpers."""
    import torch

    sys.path.insert(0, repo)
    smoke = _chip_smoke(repo)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.parallel import sharded as sh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.build_all(["sharded"])
    rng = np.random.default_rng(1616)
    base, _ = smoke._banked_table(torch, rng, smoke.NUM_SLOTS, dev)
    _, graft = smoke.graft_device_batch(torch, fw, dev)
    mesh = smoke.group_mesh(torch, sh, dev, smoke.SERVED_GROUPS)
    model = sh.ShardedFixedWindowModel(smoke.NUM_SLOTS, mesh)
    parts = model.parts(smoke.split_groups(torch, sh, base, mesh))
    cards = smoke.unmapped_cards(mesh)

    def step():
        return sh.grouped_general_step(parts, cards, smoke.BANKS, graft.slots, graft.hits,
                                       graft.fresh, graft.limits, "decide", graft.shadow, 0.8)

    acts = smoke.step_activities(torch, step)
    call_us = smoke.time_ms(step, reps=10, inner=20) * 1e3
    smi = _smi()
    print(f"rehearsal ({os.path.abspath(repo)}): cards {cards}; per step over "
          f"{smoke.STEP_CAPTURE} profiled steps {acts}; call {call_us:.2f} us ({smi})")
    print(json.dumps({"card": smi, "repo": os.path.abspath(repo), "cards": cards,
                      "activities": acts, "call_us": call_us}))


def diagnose() -> None:
    """The smoke's kernel rows with every device_samples capture
    recorded (--diagnose)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = _chip_smoke(HERE)
    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.models import fixed_window as fw
    from ratelimit_tpu_torch.parallel import sharded as sh

    kernels.build_all(["sharded"])
    captures = []

    def recording(fn, iters=20):
        # chip_smoke.device_samples, each try's activities kept.
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        seen = None
        for t in range(smoke.PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            evs = sorted((ev for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda ev: ev.time_range.start)
            us = [ev.time_range.elapsed_us() for ev in evs]
            captures.append(dict(iters=iters, trial=t, names=sorted({ev.name for ev in evs}),
                                 us=us))
            if sum(us) <= 0:
                continue
            seen = us
            if len(us) % iters == 0:
                k = len(us) // iters
                return [sum(us[c * k : (c + 1) * k]) / 1e3 for c in range(iters)]
        if seen is None:
            return None
        smoke.SHORT_CAPTURES.append((len(seen), iters))
        k = max(1, round(len(seen) / iters))
        return [sum(seen) * k / len(seen) / 1e3] * iters

    smoke.device_samples = recording
    rows, _ = smoke.group_kernel_rows(torch, fw, sh, dev)
    smi = _smi()
    print(f"{sh.COMBINE} row of group_kernel_rows: {rows[sh.COMBINE]['ms'] * 1e3:.3f} us "
          f"({smi})")
    found = []
    for c in captures:
        if not any("combine_kernel" in name for name in c["names"]):
            continue
        us = np.array(c["us"])
        found.append(dict(iters=c["iters"], trial=c["trial"], activities=len(us),
                          names=c["names"], sum_over_iters_us=float(us.sum() / c["iters"]),
                          min_us=float(us.min()), median_us=float(np.median(us)),
                          max_us=float(us.max())))
        print(f"capture of {c['iters']} calls (try {c['trial']}): {len(us)} activities "
              f"{c['names']}; each min / median / max {us.min():.3f} / {np.median(us):.3f} / "
              f"{us.max():.3f} us; sum / calls {us.sum() / c['iters']:.3f} us")
    # The same call, timed as the pairs time it: median of 50.
    n, banks, groups, ns = 4096, smoke.BANKS, smoke.SERVED_GROUPS, smoke.NUM_SLOTS
    k, spb = banks // groups, ns // banks
    rng = np.random.default_rng(1617)
    base, _ = smoke._banked_table(torch, rng, ns, dev)
    slots, hits, fresh = smoke._dup_lanes(torch, rng, n, ns, dev, n // 2)
    limits = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32)).to(dev)
    shadow = torch.zeros(n, dtype=torch.bool, device=dev)
    size = sh.partial_bytes("decide", n)
    both = torch.zeros((2, -(-size // 16) * 16), dtype=torch.uint8, device=dev)
    parts = [base[i * k : (i + 1) * k].clone() for i in range(groups)]
    home, far = tuple(range(0, groups, 2)), tuple(range(1, groups, 2))
    for gs, out in ((home, both[0]), (far, both[1])):
        sh.sharded_card_step(parts, gs, banks, slots, hits, fresh, limits, "decide", shadow,
                             0.8, out)
    sources = sh._combine_sources([(home, "home"), (far, "combine")])
    captures.clear()
    per_call = recording(lambda: sh.sharded_combine(both[0], both[1:], sources, slots, banks,
                                                    spb, "decide"), iters=50)
    us = np.array(captures[-1]["us"])
    print(f"the pairs' way, same process: {len(us)} activities of 50 calls, median "
          f"{np.median(np.array(per_call)) * 1e3:.3f} us, mean {np.mean(per_call) * 1e3:.3f} us "
          f"({smi})")
    print(json.dumps({"card": smi, "row_us": rows[sh.COMBINE]["ms"] * 1e3, "captures": found,
                      "pairs_way_us": [v * 1e3 for v in per_call],
                      "pairs_way_activities": len(us)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--rehearsal", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--repo", default=HERE)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    if args.rehearsal:
        rehearsal(args.repo)
        return
    if args.diagnose:
        diagnose()
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke = _chip_smoke(HERE)
    sys.path.insert(0, HERE)
    from ratelimit_tpu_torch import kernels
    from ratelimit_tpu_torch.parallel import sharded as sh

    kernels.build_all(["sharded"])
    lib = build(kernels)
    n, banks, groups, ns = args.n, smoke.BANKS, smoke.SERVED_GROUPS, smoke.NUM_SLOTS
    k, spb = banks // groups, ns // banks
    rng = np.random.default_rng(1617)
    base, _ = smoke._banked_table(torch, rng, ns, dev)
    slots, hits, fresh = smoke._dup_lanes(torch, rng, n, ns, dev, n // 2)
    limits = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32)).to(dev)
    shadow = torch.zeros(n, dtype=torch.bool, device=dev)
    size = sh.partial_bytes("decide", n)
    stride = -(-size // 16) * 16
    rows = sh.LAYOUTS["decide"]

    def card_step(parts, gs, out):
        sh.sharded_card_step(parts, gs, banks, slots, hits, fresh, limits, "decide", shadow, 0.8,
                             out)

    # The parent's stage, each group's lanes in its own row (each group
    # run alone into its own zeroed row), and the
    # rehearsal's split (unmapped_cards on one card): groups {0, 2} in
    # place, {1, 3} in one partial -- row 0 of `both` the home output,
    # row 1 the partial -- each zero off its own lanes, both from the
    # same tables, so every leg gives one answer.
    stage = torch.zeros((groups, stride), dtype=torch.uint8, device=dev)
    parts = [base[i * k : (i + 1) * k].clone() for i in range(groups)]
    for g in range(groups):
        card_step(parts, (g,), stage[g])
    home, far = tuple(range(0, groups, 2)), tuple(range(1, groups, 2))
    both = torch.zeros((2, stride), dtype=torch.uint8, device=dev)
    parts = [base[i * k : (i + 1) * k].clone() for i in range(groups)]
    card_step(parts, home, both[0])
    card_step(parts, far, both[1])
    sources = sh._combine_sources([(home, "home"), (far, "combine")])
    pristine = both.clone()
    want = sh._combine_plain(pristine[0].clone(), pristine[1:], sources, slots, banks, spb,
                             "decide")[:size]
    owned = int(torch.isin((slots.to(torch.int64) % banks) // k, torch.tensor(far, device=dev))
                .logical_and(slots >= 0).logical_and(slots < ns).sum())
    stream = torch.cuda.current_stream().cuda_stream
    parent_out = torch.empty(size, dtype=torch.uint8, device=dev)
    table = (ctypes.c_int * groups)(*sources)

    def parent():
        rc = lib.rl_parent_combine(stage.data_ptr(), stride, groups, slots.data_ptr(), banks, spb,
                                   *rows, n, parent_out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"rl_parent_combine returned {rc}")
        return parent_out

    def probe(lanes):
        def launch():
            rc = lib.rl_probe_combine(lanes, both[0].data_ptr(), both[1:].data_ptr(), stride, 1,
                                      ctypes.addressof(table), groups, slots.data_ptr(), banks,
                                      spb, *rows, n, stream)
            if rc:
                raise RuntimeError(f"rl_probe_combine({lanes}) returned {rc}")
            return both[0]
        return launch

    legs = {
        "parent": parent,
        "sum4": lambda: torch.sum(stage, 0, dtype=torch.uint8),
        "shipped": lambda: sh.sharded_combine(both[0], both[1:], sources, slots, banks, spb,
                                              "decide"),
        "lane1": probe(1),
        "lane4": probe(4),
        "sum2": lambda: torch.sum(pristine, 0, dtype=torch.uint8),
    }
    for name, fn in legs.items():
        both.copy_(pristine)
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got[:size], want):
            sys.exit(f"{name} differs from the plain version at {n} lanes")
    medians = {name: [] for name in legs}
    for p in range(args.pairs):
        for name in (list(legs) if p % 2 == 0 else list(legs)[::-1]):
            us = np.array(smoke.device_samples(legs[name], iters=50) or [np.nan]) * 1e3
            medians[name].append(float(np.median(us)))
    smi = _smi()
    print(smi)
    print(f"{n} lanes, {owned} of them owned by the combine card's groups {far}")
    for name, ms in medians.items():
        print(f"{name}: device us a call, median of each of {args.pairs} legs: "
              + ", ".join(f"{v:.2f}" for v in ms) + f"; median {np.median(ms):.2f} ({smi})")
    diffs = {}
    for a, b in (("shipped", "sum2"), ("shipped", "parent"), ("shipped", "sum4"),
                 ("parent", "sum4"), ("lane4", "lane1")):
        d = np.array(medians[a]) - np.array(medians[b])
        diffs[f"{a}-{b}"] = [float(v) for v in d]
        print(f"{a} - {b} per pair: median {np.median(d):+.2f}, min {d.min():+.2f}, "
              f"max {d.max():+.2f} us, {a} faster in {int((d < 0).sum())} of {len(d)}")
    print(json.dumps({"card": smi, "n": n, "groups": groups, "layout": "decide",
                      "combine_lanes": owned, "medians_us": medians, "diffs_us": diffs}))


if __name__ == "__main__":
    main()
