"""Each cell runs end to end at a tiny size on the CPU's plain path, is
judged correct, and reports its metrics; the control put in the
program's place comes out wrong."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_correct_and_control_fails(cell):
    import harness

    out = run_tiny(cell, control=True)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert any(c["value"] > 0 for c in out["control"].values()), out["control"]
    wanted = {m["name"] for m in harness.Cell(cell).metrics(traced=False)}
    assert set(out["metrics"]) == wanted
    assert "setup_s" in wanted and len(wanted) >= 2
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    # What the host's clock gives per layer (a tail at capacity among it)
    # is recorded, not judged.
    for m in harness.Cell(cell).metrics(traced=True):
        if m["source"] == "host_clock":
            assert out["recorded"][m["name"]]["value"] > 0, m["name"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run_reports_host_side_layers(cell):
    import harness

    out = run_tiny(cell, seed=2**40 + 3, trace=True)
    assert out["correct"], out["checks"]
    # No profiler reading on the CPU: the device metrics are left out,
    # never reported as 0; every other per-layer metric of the cell is read.
    assert "device_idle_pct" not in out["metrics"]
    host_side = {m["name"] for m in harness.Cell(cell).metrics(traced=True)
                 if m["source"] != "device_trace"}
    assert set(out["metrics"]) == host_side


def test_every_cell_of_the_benchmark_has_a_tiny_twin():
    import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = harness.with_held(json.load(f))
    assert {w["name"] for w in spec["workloads"]} == set(TINY)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "fw_engine_4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "fw_engine_4096",
         "--seed", str(2**32 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
