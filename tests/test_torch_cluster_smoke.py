"""The port's cluster smoke (scripts/torch_cluster_smoke.py) on the CPU:
scripts/cluster_smoke.py's elastic-tier happy path against
ratelimit_tpu_torch -- joint enforcement through the router, a killed
replica ejected and failed over, the degraded local-cache answer, a
joining replica taking its keys' counters over the HTTP admin POSTs,
the journal of the whole episode and the proxy's /fleet.json.  The
script runs once in a subprocess; each of its checks must pass."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECKS = (
    "joint_limit",
    "killed_replica_ejected",
    "failover_served_its_keys",
    "circuit_states_exposed",
    "degraded_local_cache",
    "degraded_counters",
    "handoff_completed",
    "handoff_moved_keys",
    "moved_key_kept_its_window",
    "joiner_handoff_counters",
    "journal_in_order",
    "journal_monotone",
    "proxy_debug_events",
    "fleet_two_live_replicas",
    "fleet_slo_sections",
    "fleet_timeline_interleaves",
)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("cluster") / "result.json"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_cluster_smoke.py"),
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


def test_cluster_smoke_exits_zero_and_checks_all(smoke):
    rc, result, stdout = smoke
    assert rc == 0, stdout[-3000:]
    assert [c["name"] for c in result["checks"]] == list(CHECKS)
    assert result["device"] == "cpu" and result["engine_device"] == "cpu"
    assert "cluster smoke: all checks passed" in stdout


@pytest.mark.parametrize("name", CHECKS)
def test_cluster_smoke_check_passes(smoke, name):
    _, result, _ = smoke
    got = {c["name"]: c for c in result["checks"]}[name]
    assert got["ok"], got["detail"]


def test_cluster_smoke_moved_every_key_it_exported(smoke):
    """The handoff imported (or merged) every key the old owners
    exported, with no error: the joiner's counters are whole."""
    _, result, _ = smoke
    h = result["handoff"]
    assert h["errors"] == [] and h["imported"] + h["merged"] == h["moved_keys"] > 0
    assert h["old"] == ["r1", "r2"] and h["new"] == ["r1", "r2", "r3"]
