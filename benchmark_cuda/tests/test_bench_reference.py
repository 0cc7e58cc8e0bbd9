"""The plain references, and the judges' comparisons failing on a
corrupted answer and on corrupted state."""

import numpy as np
import pytest

from conftest import TINY
from reference import fixed_window as fw
from reference import gcra


def test_fixed_window_counts_each_window_from_zero():
    keys = np.array([1, 1, 2, 1, 1, 1])
    windows = np.array([10, 10, 10, 10, 11, 11])
    limits = np.array([2, 2, 0, 2, 2, 2])
    codes, rem, groups, counts = fw.decide_in_order(keys, windows, limits)
    assert codes.tolist() == [fw.OK, fw.OK, fw.OVER_LIMIT, fw.OVER_LIMIT, fw.OK, fw.OK]
    assert rem.tolist() == [1, 0, 0, 0, 1, 0]
    assert dict(zip(map(tuple, groups.tolist()), counts.tolist())) == {
        (1, 10): 3, (1, 11): 2, (2, 10): 1}
    codes, _, _, _ = fw.decide_in_order(keys, windows, limits, off_by_one=True)
    assert codes[3] == fw.OK


def _served(rng, limit, n=60):
    """One key's answers, decided at a random instant of each request."""
    send = np.sort(rng.random(n) * 4) + 1000
    recv = send + rng.exponential(0.1, n)
    decided = send + rng.random(n) * (recv - send)
    count, answers = {}, [None] * n
    for i in np.argsort(decided):
        w = int(decided[i])
        count[w] = count.get(w, 0) + 1
        k = count[w]
        answers[i] = (fw.OK, limit - k) if k <= limit else (fw.OVER_LIMIT, 0)
    return [(int(send[i]), int(recv[i]), *answers[i]) for i in range(n)], count


@pytest.mark.parametrize("seed", range(40))
def test_order_free_judge_accepts_any_server_order_and_rejects_corruption(seed):
    rng = np.random.default_rng(seed)
    limit = int(rng.integers(0, 12))
    answers, count = _served(rng, limit)
    assert fw.feasible(answers, limit, count)
    assert fw.feasible(answers, limit, {})
    held = dict(count)
    held[next(iter(count))] += 1
    assert not fw.feasible(answers, limit, held)
    j = int(rng.integers(len(answers)))
    a, b, code, rem = answers[j]
    bad = list(answers)
    bad[j] = (a, b, fw.OK, limit) if code == fw.OVER_LIMIT else (a, b, fw.OK, rem + 1)
    assert not fw.feasible(bad, limit, count)


def test_gcra_admits_the_limit_then_refills_one_cell_a_tenth():
    ref = gcra.Gcra(np.array([10, 0]), divider=1)
    codes, rem = ref.batch(np.zeros(12, dtype=np.int64), 1_700_000_000)
    assert codes.tolist() == [gcra.OK] * 10 + [gcra.OVER_LIMIT] * 2
    assert rem.tolist() == list(range(9, -1, -1)) + [0, 0]
    codes, _ = ref.batch(np.array([1, 1]), 1_700_000_000)
    assert codes.tolist() == [gcra.OVER_LIMIT] * 2
    assert (int(ref.sec[0]), int(ref.frac[0])) == (1_700_000_001, 0)
    codes, rem = ref.batch(np.zeros(11, dtype=np.int64), 1_700_000_001)
    assert codes.tolist() == [gcra.OK] * 10 + [gcra.OVER_LIMIT]
    codes, rem = ref.batch(np.zeros(1, dtype=np.int64), 1_700_000_005)
    assert (codes.tolist(), rem.tolist()) == ([gcra.OK], [9])
    assert int(ref.sec[1]) == 0 and int(ref.frac[1]) == 0


def test_gcra_control_in_bfloat16_drifts():
    f32 = gcra.Gcra(np.full(4, 10), divider=1)
    bf16 = gcra.Gcra(np.full(4, 10), divider=1, precision="bf16")
    rng = np.random.default_rng(3)
    for s in range(30):
        keys = rng.integers(0, 4, 7)
        f32.batch(keys, 1_700_000_000 + s)
        bf16.batch(keys, 1_700_000_000 + s)
    assert (f32.sec != bf16.sec).any() or (f32.frac != bf16.frac).any()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_judge_fails_a_corrupted_answer_and_corrupted_state(cell, monkeypatch):
    import harness

    observed = {}
    run_cell_driver = harness.part("drivers", harness.Cell(cell).traffic["driver"]).run

    def keep(*args, **kwargs):
        out = run_cell_driver(*args, **kwargs)
        observed.update(out["observed"])
        return out

    monkeypatch.setattr(harness.part("drivers", harness.Cell(cell).traffic["driver"]), "run", keep)
    from conftest import run_tiny

    assert run_tiny(cell, seed=2**36 + 1)["correct"]
    c = harness.Cell(cell, TINY[cell])
    clean = harness.judge(c, observed)
    assert all(v == 0 for v, _ in clean.values())

    bad = dict(observed)
    if "rpcs" in bad:
        rpcs = dict(bad["rpcs"])
        rpcs["code"] = rpcs["code"].copy()
        rpcs["code"][len(rpcs["code"]) // 2] = 3 - rpcs["code"][len(rpcs["code"]) // 2]
        bad["rpcs"] = rpcs
    else:
        bad["codes"] = bad["codes"].copy()
        bad["codes"][0] = 3 - bad["codes"][0]
    assert max(v for v, _ in harness.judge(c, bad).values()) > 0

    if "rpcs" in bad:
        bad = dict(observed)
        rpcs = dict(bad["rpcs"])
        rpcs["overall"] = rpcs["overall"].copy()
        rpcs["overall"][0] = 3 - rpcs["overall"][0]
        bad["rpcs"] = rpcs
        assert harness.judge(c, bad)["keys_wrong"][0] > 0

    bad = dict(observed)
    bad["state"] = bad["state"].copy()
    bad["state"][0, 2] += 1
    assert max(v for v, _ in harness.judge(c, bad).values()) > 0


def test_restamping_only_changed_digits_equals_a_full_stamp():
    import numpy as np

    from keyspace import KeySpace, stamp_window

    space = KeySpace({"count": 300, "zipf": 0.99, "blocked": "50.0.0.5"}, "d", "k", 2**33 + 1)
    ids = space.draw(np.random.default_rng(3), 500)
    blob, lens, at = space.pack(ids, 10)
    fresh = blob.copy()
    stamp_window(blob, at, 1_760_000_999)
    for old, new in ((1_760_000_999, 1_760_001_000), (1_760_001_000, 1_769_999_999)):
        stamp_window(blob, at, new, old)
        stamp_window(fresh, at, new)
        assert (blob == fresh).all()
    keys = bytes(blob).split(b"_1769999999")[:-1]
    assert len(keys) == len(ids)
    assert all(k.lstrip(b"_").startswith(b"d_k_") for k in keys)
