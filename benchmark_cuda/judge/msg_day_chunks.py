"""The messaging cell's comparison with the plain reference.

The driver kept, for every chunk in the order sent, the clock it was
sent at and which chunk of the pool it was, every answer to a lane of a
sampled key id, the morning's counts a key id, and the program's state
of the sampled ids after the window.  ``reference/fixed_window_restored.py``
decides the same lanes in the same order and batches, each (key, window)
counting on from the morning's count, and every answer and held counter
is compared exactly.

Checks (each has the limit 0):

- ``answers_wrong``: lanes whose code or remaining limit differ;
- ``state_wrong``: sampled counters that differ, one the program holds
  that the reference never made (a key of no template among them), or
  one the reference holds that the program lacks (a restored count
  dropped among them).

With ``control`` the reference's control is judged in the program's
place.
"""

from __future__ import annotations

import numpy as np


def lanes_in_order(obs):
    """(key ids, chunk number) of every sampled lane, in order."""
    per = [obs["pool"][c][obs["sample_idx"][c]] for c in obs["chunk_pool"]]
    ids = np.concatenate(per) if per else np.zeros(0, np.int64)
    chunk = np.repeat(np.arange(len(per)), [len(p) for p in per])
    return ids.astype(np.int64), chunk


def judge(obs, control: bool = False) -> dict:
    import harness

    ids, chunk = lanes_in_order(obs)
    reference = harness.part("reference", "fixed_window_restored")
    got = reference.engine_checks(obs, ids, chunk, obs["now"], control)
    (codes, rem), (got_codes, got_rem) = got["expected"], got["judged"]
    if len(codes) != len(got_codes):
        wrong = max(len(codes), len(got_codes))
    else:
        wrong = int(np.count_nonzero((codes != got_codes) | (rem != got_rem)))
    return {"answers_wrong": (wrong, 0), "state_wrong": (got["state_wrong"], 0)}
