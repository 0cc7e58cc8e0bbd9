"""Plain reference of the fixed-window limiter, in NumPy.

The semantics are envoyproxy/ratelimit's (README, "Rate limit
configuration"; limiter/base_limiter.go): every (key, window) pair counts
the hits it is sent, from zero; the hit that takes a count past the
rule's ``requests_per_unit`` is OVER_LIMIT, and an OK answer carries the
limit less the count after the hit.  A rule of 0 a unit answers
OVER_LIMIT to every hit.  The window of a hit is its clock's unix second
less that second modulo the unit.

Nothing here imports the program: the reference works from the inputs the
benchmark made (addresses, windows, limits) and reads the program's
answers and counters only to judge them.

The control (``off_by_one=True``) is this reference with the fence post
moved: it admits ``requests_per_unit + 1`` hits a window.  It breaks the
configuration's stated limit by one hit and must come out wrong.
"""

from __future__ import annotations

import numpy as np

#: RateLimitResponse.Code (envoy rls.proto).
OK = 1
OVER_LIMIT = 2


def decide_in_order(keys, windows, limits, off_by_one: bool = False):
    """Decide one hit a lane, lanes in the order given.

    keys, windows, limits: int64 arrays, one entry a lane.  Returns
    (codes, remaining, groups, counts): each lane's code and remaining
    limit, and each (key, window) pair's count after every lane, as
    ``groups`` (an int64[g, 2] of key, window) and ``counts``."""
    keys = np.asarray(keys, dtype=np.int64)
    windows = np.asarray(windows, dtype=np.int64)
    limits = np.asarray(limits, dtype=np.int64)
    n = len(keys)
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty.astype(np.int32), empty, np.zeros((0, 2), np.int64), empty
    # One int64 a (key, window) pair, sorted once (stably: lane order
    # within a pair is the order of its hits).
    w0 = int(windows.min())
    span = int(windows.max()) - w0 + 1
    joint = keys * span + (windows - w0)
    order = np.argsort(joint, kind="stable")
    ordered = joint[order]
    idx = np.arange(n)
    starts = np.ones(n, dtype=bool)
    starts[1:] = ordered[1:] != ordered[:-1]
    first = np.maximum.accumulate(np.where(starts, idx, 0))
    after = np.empty(n, dtype=np.int64)
    after[order] = idx - first + 1
    admit = limits + (1 if off_by_one else 0)
    over = after > admit
    codes = np.where(over, OVER_LIMIT, OK).astype(np.int32)
    remaining = np.where(over, 0, np.maximum(limits - after, 0))
    heads = np.flatnonzero(starts)
    uniq = np.stack([ordered[heads] // span, ordered[heads] % span + w0], axis=1)
    counts = np.diff(np.append(heads, n)).astype(np.int64)
    return codes, remaining, uniq, counts


def compare_state(ref_groups, ref_counts, got_groups, got_counts, live_window):
    """Counters that differ: each (key, window) the program holds against
    the reference's count (a pair the reference never counted is wrong),
    and each pair of the live window (`live_window`, whose slots cannot
    have been reclaimed) that the program lacks."""
    ref = {(int(k), int(w)): int(c) for (k, w), c in zip(ref_groups, ref_counts)}
    got = {(int(k), int(w)): int(c) for (k, w), c in zip(got_groups, got_counts)}
    wrong = sum(ref.get(pair) != c for pair, c in got.items())
    wrong += sum(1 for pair in ref if pair[1] == live_window and pair not in got)
    return wrong


# -- answers whose window the server's clock chose ---------------------------
#
# A served request is decided at some instant between its send and its
# reply, so its window is any whole second from floor(send) to
# floor(reply).  The order of concurrent hits is the server's.  Neither is
# an input, so the served answers are judged by what they must satisfy in
# any order: in each window of a key the OK answers are the counts 1..m,
# each once, and OVER_LIMIT answers come only once m is the limit; where
# the program still holds the window's counter, m plus the OVER_LIMIT
# answers is that count.  ``feasible`` decides exactly whether some
# choice of window for each answer satisfies that, by a search over the
# windows in time order that takes, of interchangeable answers, those whose
# last candidate window comes first.


def answer_value(code: int, remaining: int, limit: int):
    """The count an answer claims (1..limit for OK), 0 for OVER_LIMIT, or
    None for an answer no count gives."""
    if code == OVER_LIMIT:
        return 0 if remaining == 0 else None
    if code == OK:
        k = limit - remaining
        return k if 1 <= k <= limit else None
    return None


def feasible(answers, limit: int, held=None) -> bool:
    """Whether the answers of one key admit windows and an order.

    answers: iterable of (first window, last window, code, remaining);
    held: {window: count} of the counters the program still holds."""
    held = dict(held or {})
    items = []
    for a, b, code, rem in answers:
        v = answer_value(int(code), int(rem), limit)
        if v is None or b < a:
            return False
        items.append((int(a), int(b), v))
    if not items:
        return not any(held.values())
    lo = min(min(a for a, _, _ in items), min(held, default=10**12))
    hi = max(max(b for _, b, _ in items), max(held, default=0))
    by_start = {}
    for a, b, v in items:
        by_start.setdefault(a, []).append((v, b))
    memo = {}

    def solve(w, pending):
        # pending: sorted tuple of (count, last window) not yet placed.
        if w > hi:
            return not pending
        key = (w, pending)
        if key not in memo:
            memo[key] = place(w, list(pending) + by_start.get(w, []))
        return memo[key]

    def place(w, pool):
        forced_ok = [v for v, b in pool if b == w and v > 0]
        forced_over = sum(1 for v, b in pool if b == w and v == 0)
        optional = sorted((v, b) for v, b in pool if b > w)
        if len(forced_ok) != len(set(forced_ok)):
            return False
        avail = set(forced_ok) | {v for v, _ in optional if v > 0}
        spare_over = sum(1 for v, _ in optional if v == 0)
        reach = 0  # counts 1..reach all have an answer here
        while reach < limit and reach + 1 in avail:
            reach += 1
        for m in range(max(forced_ok, default=0), reach + 1):
            if m < limit:
                overs = [0] if forced_over == 0 else []
            else:
                overs = range(forced_over, forced_over + spare_over + 1)
            for o in overs:
                if w in held and held[w] != m + o:
                    continue
                rest = list(optional)
                for k in range(1, m + 1):
                    if k not in forced_ok:
                        # of the answers of count k, the one whose
                        # candidate windows close first
                        rest.pop(next(i for i, (v, _) in enumerate(rest) if v == k))
                for _ in range(o - forced_over):
                    rest.pop(next(i for i, (v, _) in enumerate(rest) if v == 0))
                if solve(w + 1, tuple(sorted(rest))):
                    return True
        return False

    return solve(lo, ())


# -- the engine cells' comparison -------------------------------------------

#: (bytes in, bytes out, HBM bytes) a distinct key of a served chunk needs
#: (benchmark_cuda/roofline.py): its slot, hits, limit (4 B each) and a
#: fresh flag (1 B) in, its count after the hits (4 B) out; its counter
#: read and written once in HBM.
BYTES_PER_KEY = (13, 4, 8)


def engine_checks(obs, ids, chunk, now, control: bool = False) -> dict:
    """The engine cell's comparison: every sampled lane decided in order,
    each chunk at its clock's window.  Returns the reference's answers,
    the judged answers (the program's, or with `control` the control's)
    and how many judged counters differ."""
    unit = obs["unit"]
    windows = (now - now % unit)[chunk]
    limits = obs["limits"][ids]
    codes, rem, groups, counts = decide_in_order(ids, windows, limits)
    got_codes, got_rem = obs["codes"], obs["remaining"]
    got_groups, got_counts = obs["state"][:, :2], obs["state"][:, 2]
    if control:
        got_codes, got_rem, got_groups, got_counts = decide_in_order(
            ids, windows, limits, off_by_one=True
        )
    live = int(now[-1] - now[-1] % unit) if len(now) else -1
    return dict(expected=(codes, rem), judged=(got_codes, got_rem),
                state_wrong=compare_state(groups, counts, got_groups, got_counts, live))


# -- the served cells' comparison -------------------------------------------


def served_checks(obs, control: bool = False) -> dict:
    """The served cell's comparison: each address's answers and held
    counters against ``feasible``, and each answer's overall code
    against its one descriptor's code (with `control`, the control's
    answers and counters, each request decided at the midpoint of its
    send and reply).  An address with a failed request is not judged."""
    rpcs, unit, limits = obs["rpcs"], obs["unit"], obs["limits"]
    ids = rpcs["id"].astype(np.int64)
    first = np.floor(rpcs["t_send"] / unit).astype(np.int64)
    last = np.floor(rpcs["t_recv"] / unit).astype(np.int64)
    codes, rem = rpcs["code"].astype(np.int64), rpcs["remaining"].astype(np.int64)
    overall = rpcs["overall"].astype(np.int64)
    state = obs["state"]
    held_ids, held_w, held_n = state[:, 0], state[:, 1] // unit, state[:, 2]
    if control:
        ok = rpcs["err"] == 0
        mid = np.floor((rpcs["t_send"] + rpcs["t_recv"]) / 2 / unit).astype(np.int64)
        order = np.argsort(mid, kind="stable")
        order = order[ok[order]]
        c, r, groups, counts = decide_in_order(
            ids[order], mid[order], limits[ids[order]], off_by_one=True
        )
        codes, rem = codes.copy(), rem.copy()
        codes[order], rem[order] = c, r
        overall = codes
        held_ids, held_w, held_n = groups[:, 0], groups[:, 1], counts
    failed = set(ids[rpcs["err"] != 0].tolist())
    by_key = {}
    for j, i in enumerate(ids.tolist()):
        by_key.setdefault(i, []).append(j)
    held = {}
    for i, w, n in zip(held_ids.tolist(), held_w.tolist(), held_n.tolist()):
        held.setdefault(i, {})[w] = n
    wrong = sum(1 for i in held if i not in by_key)
    for i, rows in by_key.items():
        if i in failed:
            continue
        answers = [(first[j], last[j], codes[j], rem[j]) for j in rows]
        wrong += bool((overall[rows] != codes[rows]).any()) or not feasible(
            answers, int(limits[i]), held.get(i))
    return wrong
