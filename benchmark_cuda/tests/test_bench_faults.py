"""With the timed path broken underneath, a whole run (the harness's look
for a card skipped) comes out not correct: a step that leaves its state
unchanged, half of each batch left out, and one answer of each chunk
altered where it is produced.  (The exchange between cards does not
exist in these one-card cells.)"""

import numpy as np
import pytest

from conftest import TINY, run_tiny


def _state_unchanged(monkeypatch):
    from ratelimit_tpu_torch.backends.engine import CounterEngine

    serve_on = CounterEngine._serve_on

    def frozen(self, stream, counts, *args):
        saved = counts.clone()
        counts, handle = serve_on(self, stream, counts, *args)
        counts.copy_(saved)
        return counts, handle

    monkeypatch.setattr(CounterEngine, "_serve_on", frozen)


def _half_left_out(monkeypatch):
    from ratelimit_tpu_torch.backends.engine import CounterEngine

    device_submit = CounterEngine._device_submit

    def halved(self, dedup, now):
        g = len(dedup.uniq_slots)
        dedup.totals = dedup.totals.copy()
        dedup.totals[g - g // 2:] = 0
        return device_submit(self, dedup, now)

    monkeypatch.setattr(CounterEngine, "_device_submit", halved)


def _answer_altered(monkeypatch):
    from ratelimit_tpu_torch.backends.engine import CounterEngine

    step_complete = CounterEngine.step_complete
    calls = {"n": 0}

    def altered(self, token):
        d = step_complete(self, token)
        if len(d.codes):
            k = calls["n"] % len(d.codes)
            d.codes = d.codes.copy()
            d.codes[k] = 3 - d.codes[k]  # OK <-> OVER_LIMIT
        calls["n"] += 1
        return d

    monkeypatch.setattr(CounterEngine, "step_complete", altered)


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_left_out": _half_left_out,
    "answer_altered": _answer_altered,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_tiny(cell, seed=2**35 + 5)
    assert not out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) > 0
    assert np.isfinite(out["metrics"]["decisions_per_s"]["value"])


def test_served_overall_code_flipped_is_not_correct(monkeypatch):
    from ratelimit_tpu_torch.server import grpc_server

    to_pb = grpc_server.response_to_pb
    calls = {"n": 0}

    def flipped(resp):
        out = to_pb(resp)
        calls["n"] += 1
        if calls["n"] % 50 == 0:
            out.overall_code = 3 - out.overall_code  # OK <-> OVER_LIMIT
        return out

    monkeypatch.setattr(grpc_server, "response_to_pb", flipped)
    out = run_tiny("fw_grpc_32c", seed=2**35 + 9)
    assert not out["correct"], out["checks"]
    assert out["checks"]["keys_wrong"]["value"] > 0
