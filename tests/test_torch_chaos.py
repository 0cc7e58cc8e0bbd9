"""The port's chaos smoke (scripts/torch_chaos_smoke.py) on the CPU:
scripts/chaos_smoke.py's controlled and uncontrolled legs and its
allow / deny matrix against ratelimit_tpu_torch, with the port's
DeviceFaultInjector hanging the engine's launch seam.  The script runs
once in a subprocess; each of its checks must pass."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECKS = (
    "quarantined_within_one_deadline",
    "controlled_p99_bounded",
    "controlled_probe_exact_limit",
    "fallback_stamped_in_flight_ring",
    "uncontrolled_stalls_and_errors",
    "failure_mode_matrix",
    "journal_quarantine_fallback_restart_in_order",
)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "result.json"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_chaos_smoke.py"),
         "--device", "cpu", "--out", str(out)],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.exists(), proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(out) as f:
        return proc.returncode, json.load(f), proc.stdout


def test_chaos_smoke_exits_zero_and_checks_all(chaos):
    rc, result, stdout = chaos
    assert rc == 0, stdout[-3000:]
    assert [c["name"] for c in result["checks"]] == list(CHECKS)
    assert result["device"] == "cpu"
    assert "chaos smoke OK" in stdout


@pytest.mark.parametrize("name", CHECKS)
def test_chaos_check_passes(chaos, name):
    _, result, _ = chaos
    got = {c["name"]: c for c in result["checks"]}[name]
    assert got["ok"], got["detail"]


def test_chaos_controlled_leg_reached_the_mirror_only_through_the_deadline(chaos):
    """The controlled leg's fallback answers come from the fault
    domain's hang quarantine: one hang fault, a warm restart, and no
    exception fault that a wrapper could have absorbed."""
    _, result, _ = chaos
    ctl = result["controlled"]
    assert ctl["faults"] == {"hang": 1, "exception": 0, "device_lost": 0}
    assert ctl["restarts"] == 1 and ctl["fallback_decisions"] > 0
    assert ctl["injected"] >= 1
    assert result["uncontrolled"]["faults"] is None
