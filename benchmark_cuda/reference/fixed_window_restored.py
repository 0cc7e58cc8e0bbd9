"""Plain reference of the fixed-window limiter after a restore, in NumPy.

The semantics are envoyproxy/ratelimit's (README, "Rate limit
configuration"; limiter/base_limiter.go), as in ``fixed_window.py``, for
a deployment restarted mid-window from a snapshot: a (key, window) pair
holds, before the first hit sent after the restore, the count the
snapshot kept for it (the morning's, for the day's window; zero for any
other window), and every hit adds to it.  The hit that takes a count
past the rule's ``requests_per_unit`` is OVER_LIMIT; an OK answer
carries the limit less the count after the hit.  A key holds its
counter for its whole window, so the state after the window is every
restored pair and every pair sent, each at its count.

Nothing here imports the program: the reference works from the inputs
the benchmark made (key ids, windows, limits, the morning's counts a key
id) and reads the program's answers and counters only to judge them.

The control (``off_by_one=True``) admits ``requests_per_unit + 1`` hits
a window and must come out wrong.
"""

from __future__ import annotations

import numpy as np

#: RateLimitResponse.Code (envoy rls.proto).
OK = 1
OVER_LIMIT = 2


def decide_in_order(keys, windows, limits, held, off_by_one: bool = False):
    """Decide one hit a lane, lanes in the order given, each (key, window)
    pair counting on from `held` (int64 a lane: the count its pair held
    before the first lane).  Returns (codes, remaining, groups, counts):
    each lane's code and remaining limit, and each pair sent (an
    int64[g, 2] of key, window) with its count after every lane."""
    keys = np.asarray(keys, dtype=np.int64)
    windows = np.asarray(windows, dtype=np.int64)
    limits = np.asarray(limits, dtype=np.int64)
    held = np.asarray(held, dtype=np.int64)
    n = len(keys)
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty.astype(np.int32), empty, np.zeros((0, 2), np.int64), empty
    w0 = int(windows.min())
    span = int(windows.max()) - w0 + 1
    joint = keys * span + (windows - w0)
    order = np.argsort(joint, kind="stable")  # lane order within a pair
    ordered = joint[order]
    idx = np.arange(n)
    starts = np.ones(n, dtype=bool)
    starts[1:] = ordered[1:] != ordered[:-1]
    first = np.maximum.accumulate(np.where(starts, idx, 0))
    after = np.empty(n, dtype=np.int64)
    after[order] = held[order] + idx - first + 1
    over = after > limits + (1 if off_by_one else 0)
    codes = np.where(over, OVER_LIMIT, OK).astype(np.int32)
    remaining = np.where(over, 0, np.maximum(limits - after, 0))
    heads = np.flatnonzero(starts)
    groups = np.stack([ordered[heads] // span, ordered[heads] % span + w0], axis=1)
    last = np.append(heads[1:], n) - 1
    return codes, remaining, groups, after[order][last]


def expected_state(obs, groups, counts):
    """{(key id, window): count} the program must hold for the sampled
    ids: every restored pair, then every pair sent at its count."""
    day, base, sampled = int(obs["day"]), obs["base"], obs["sampled"]
    held = np.flatnonzero(sampled & (base > 0))
    out = dict(zip(zip(held.tolist(), [day] * len(held)), base[held].astype(np.int64).tolist()))
    out.update(zip(map(tuple, groups.tolist()), counts.tolist()))
    return out


def compare_state(expected: dict, got_rows) -> int:
    """Counters that differ: each (key id, window) the program holds
    against the expected count (a pair not expected, an unparsed key
    among them, is wrong; so is a pair held twice), and each expected
    pair the program lacks (a day's counter lives until midnight)."""
    got = {}
    wrong = 0
    for k, w, c in np.asarray(got_rows, dtype=np.int64).tolist():
        if (k, w) in got:
            wrong += 1
        got[(k, w)] = c
    wrong += sum(expected.get(pair) != c for pair, c in got.items())
    wrong += sum(1 for pair in expected if pair not in got)
    return wrong


#: (bytes in, bytes out, HBM bytes) a distinct key of a served chunk
#: needs: as ``fixed_window.py`` (K1 serves both).
BYTES_PER_KEY = (13, 4, 8)


def engine_checks(obs, ids, chunk, now, control: bool = False) -> dict:
    """The engine cell's comparison: every sampled lane decided in order,
    each chunk at its clock's window, from the morning's counts.  Returns
    the reference's answers, the judged answers (the program's, or with
    `control` the control's) and how many judged counters differ."""
    unit, day = int(obs["unit"]), int(obs["day"])
    windows = (now - now % unit)[chunk]
    held = np.where(windows == day, obs["base"][ids].astype(np.int64), 0)
    limits = obs["limits"][ids]
    codes, rem, groups, counts = decide_in_order(ids, windows, limits, held)
    expected = expected_state(obs, groups, counts)
    got_codes, got_rem, got_rows = obs["codes"], obs["remaining"], obs["state"]
    if control:
        got_codes, got_rem, g, c = decide_in_order(ids, windows, limits, held, off_by_one=True)
        pairs = expected_state(obs, g, c)
        got_rows = [(k, w, n) for (k, w), n in pairs.items()]
    return dict(expected=(codes, rem), judged=(got_codes, got_rem),
                state_wrong=compare_state(expected, got_rows))
