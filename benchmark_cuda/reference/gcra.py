"""Plain reference of the GCRA limiter, in NumPy.

GCRA (the Generic Cell Rate Algorithm, virtual-scheduling form; ITU-T
I.371) as the program's docs/ALGORITHMS.md states it for a rule of
``requests_per_unit`` L over a unit of D seconds: each key holds a
theoretical arrival time (TAT); the emission interval is ``T = D / L``
and the burst tolerance ``tau = D - T``.  At a clock of ``now`` whole
seconds a key with ``v = max(TAT - now, 0)`` has a budget of
``B = floor((tau - v) / T) + 1`` cells (0 for L = 0).  The hits one batch
sends a key are decided together: the p-th of them (from 0, in batch
order) is OK while ``p + 1 <= B`` and answers ``B - p - 1`` remaining,
and the TAT moves to ``now + v + min(hits, B) * T``.  The configuration
states this arithmetic in float32 (the TAT kept as whole seconds and a
32-bit binary fraction), one IEEE operation at a time in the order above.

Nothing here imports the program.  The control (``precision="bf16"``)
is the same arithmetic rounded to bfloat16 after every operation, the
nearest precision below float32: it must come out wrong.
"""

from __future__ import annotations

import numpy as np

OK = 1
OVER_LIMIT = 2

_FRAC_UNIT = np.float32(2.0**-32)
_FRAC_SCALE = np.float32(2.0**32)
_FRAC_MAX = np.nextafter(np.float32(2.0**32), np.float32(0))
_BUDGET_MAX = np.float32(2**31 - 128)


def _bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even), kept as
    float32."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = rounded.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, out)


class Gcra:
    """TATs of `n` keys (indices 0..n-1), each with its own limit."""

    def __init__(self, limits, divider: int = 1, precision: str = "f32"):
        self.limits = np.asarray(limits, dtype=np.uint32)
        self.divider = int(divider)
        self.sec = np.zeros(len(self.limits), dtype=np.uint32)
        self.frac = np.zeros(len(self.limits), dtype=np.uint32)
        self._r = _bf16 if precision == "bf16" else (lambda x: np.asarray(x, np.float32))

    def batch(self, keys, now: int):
        """Decide one hit a lane of one batch, lanes in order: returns
        (codes, remaining) and moves the TATs."""
        r = self._r
        keys = np.asarray(keys, dtype=np.int64)
        uniq, inv, hits = np.unique(keys, return_inverse=True, return_counts=True)
        inv = inv.reshape(-1)
        order = np.argsort(inv, kind="stable")
        idx = np.arange(len(keys))
        starts = np.ones(len(keys), dtype=bool)
        starts[1:] = inv[order][1:] != inv[order][:-1]
        prefix = np.empty(len(keys), dtype=np.int64)
        prefix[order] = idx - np.maximum.accumulate(np.where(starts, idx, 0))

        now_u = np.uint32(now & 0xFFFFFFFF)
        sec, frac, limit = self.sec[uniq], self.frac[uniq], self.limits[uniq]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            rel = (sec - now_u).view(np.int32)
            d = r(r(rel.astype(np.float32)) + r(r(frac.astype(np.float32)) * _FRAC_UNIT))
            v = np.maximum(d, np.float32(0))
            div = r(np.float32(self.divider))
            t = r(div / r(limit.astype(np.float32)))
            tau = r(div - t)
            budget = r(np.floor(r(r(tau - v) / t)) + np.float32(1))
            budget = np.where(limit > 0, budget, np.float32(0))
            budget = np.clip(budget, np.float32(0), _BUDGET_MAX).astype(np.float32)
            adm = np.minimum(r(hits.astype(np.float32)), budget)
            moved = adm > 0
            new_d = r(v + r(adm * np.where(moved, t, np.float32(0))))
            whole = np.floor(new_d)
            part = np.minimum(r(r(new_d - whole) * _FRAC_SCALE), _FRAC_MAX)
            self.sec[uniq] = np.where(moved, now_u + whole.astype(np.uint32), sec)
            self.frac[uniq] = np.where(moved, part.astype(np.uint32), frac)
        b = budget.astype(np.int64)[inv]
        ok = prefix + 1 <= b
        codes = np.where(ok, OK, OVER_LIMIT).astype(np.int32)
        remaining = np.where(ok, b - prefix - 1, 0)
        return codes, remaining


# -- the engine cells' comparison -------------------------------------------

#: (bytes in, bytes out, HBM bytes) a distinct key of a served chunk needs
#: (benchmark_cuda/roofline.py): its slot, hits, limit, unit (4 B each)
#: and a fresh flag (1 B) in, its budget (4 B) out; its TAT (8 B) read and
#: written once in HBM.
BYTES_PER_KEY = (17, 4, 16)


def engine_checks(obs, ids, chunk, now, control: bool = False) -> dict:
    """The engine cell's comparison: every sampled lane decided batch by
    batch at its chunk's clock.  Returns the reference's answers, the
    judged answers (the program's, or with `control` the bfloat16
    control's) and how many judged TATs differ."""
    keys = np.unique(ids)
    index = np.searchsorted(keys, ids)
    limits = obs["limits"][keys]
    ref = Gcra(limits, obs["unit"])
    ctl = Gcra(limits, obs["unit"], precision="bf16") if control else None
    bounds = np.searchsorted(chunk, np.arange(len(now) + 1))
    codes, rem, got_codes, got_rem = [], [], [], []
    last_seen = np.full(len(keys), -1, dtype=np.int64)
    for c in range(len(now)):
        lanes = index[bounds[c]:bounds[c + 1]]
        if not len(lanes):
            continue
        a, b = ref.batch(lanes, int(now[c]))
        codes.append(a)
        rem.append(b)
        last_seen[lanes] = now[c]
        if ctl is not None:
            a, b = ctl.batch(lanes, int(now[c]))
            got_codes.append(a)
            got_rem.append(b)
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)  # noqa: E731
    if ctl is None:
        got_codes, got_rem = obs["codes"], obs["remaining"]
        held = {int(i): (int(s), int(f)) for i, s, f in obs["state"]}
    else:
        got_codes, got_rem = cat(got_codes), cat(got_rem)
        held = {int(k): (int(s), int(f)) for k, s, f in zip(keys, ctl.sec, ctl.frac)}
    state_wrong = 0
    pos = {int(k): j for j, k in enumerate(keys)}
    for i, tat in held.items():
        j = pos.get(i)
        state_wrong += j is None or tat != (int(ref.sec[j]), int(ref.frac[j]))
    if len(now):
        # A key whose lease (`lease` seconds past its window) still runs
        # cannot have lost its slot.
        last_window = int(now[-1] - now[-1] % obs["unit"])
        leased = last_seen - last_seen % obs["unit"] + obs["lease"] > last_window
        state_wrong += sum(1 for j in np.flatnonzero(leased) if int(keys[j]) not in held)
    return dict(expected=(cat(codes), cat(rem)), judged=(got_codes, got_rem),
                state_wrong=state_wrong)

