"""A new cell goes in as new files and new entries only: in a copy of the
benchmark, one more workload entry and its tiny twin make the cell tests
and the twin test pass, with no file that was there changed.  Tiny twins
are read strictly, and every cell's driver observes what its judge reads
(the contract in ``conftest.py``'s docstring)."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import BENCH, ROOT, TINY, read_tiny

NEW_CELL = {"name": "fw_engine_4096_copy", "config": "edge_per_ip_fw", "traffic": "engine_4096",
            "chips": 1, "why": "a copy of fw_engine_4096 under another name"}


def snapshot(top) -> dict:
    """{path relative to `top`: bytes} of every file under it, bytecode aside."""
    files = {}
    for folder, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in names:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, top)] = f.read()
    return files


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark_cuda",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy2(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = snapshot(copy)

    spec = json.loads(before["BENCHMARK.json"])
    spec["workloads"].append(NEW_CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(spec, indent=1) + "\n")
    twin = os.path.join("benchmark_cuda", "tests", "tiny", NEW_CELL["name"] + ".json")
    (copy / twin).write_text(json.dumps(TINY["fw_engine_4096"], indent=1) + "\n")

    ini = tmp_path / "pytest.ini"
    ini.write_text("[pytest]\n")
    tests = "benchmark_cuda/tests/"
    ids = [
        f"{tests}test_bench_cells.py::test_cell_runs_correct_and_control_fails[{NEW_CELL['name']}]",
        f"{tests}test_bench_cells.py::test_traced_run_reports_host_side_layers[{NEW_CELL['name']}]",
        f"{tests}test_bench_cells.py::test_every_cell_of_the_benchmark_has_a_tiny_twin",
        f"{tests}test_bench_layout.py::test_every_part_of_a_cell_is_there[{NEW_CELL['name']}]",
    ]
    # The program is imported from this checkout; the benchmark, from the copy.
    path = [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-c", str(ini),
         "--rootdir", str(copy), *ids],
        cwd=copy, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert f"{len(ids)} passed" in proc.stdout, proc.stdout[-2000:]

    after = snapshot(copy)
    assert set(after) - set(before) == {twin}
    for name, data in before.items():
        if name != "BENCHMARK.json":
            assert after[name] == data, name
    grown = json.loads(after["BENCHMARK.json"])
    assert grown["workloads"][-1] == NEW_CELL
    grown["workloads"].pop()
    assert grown == json.loads(before["BENCHMARK.json"])


@pytest.mark.parametrize("name, text", [
    pytest.param("cell.json", "{not json", id="not_json"),
    pytest.param("cell.json", "[1, 2]", id="not_an_object"),
    pytest.param("cell.json", "{}", id="empty"),
    pytest.param("cell.json", '{"keys.count": 2048}', id="neither_config_nor_traffic"),
    pytest.param("cell.json", '{"config": 2048}', id="no_path"),
    pytest.param("cell.txt", '{"config.keys.count": 2048}', id="not_json_named"),
])
def test_a_malformed_tiny_twin_is_an_error(tmp_path, name, text):
    (tmp_path / "good.json").write_text('{"config.keys.count": 2048, "traffic.lanes": 256}')
    assert read_tiny(str(tmp_path)) == {"good": {"config.keys.count": 2048, "traffic.lanes": 256}}
    (tmp_path / name).write_text(text)
    with pytest.raises(ValueError, match=name):
        read_tiny(str(tmp_path))


def test_a_folder_among_the_tiny_twins_is_an_error(tmp_path):
    (tmp_path / "cell.json").mkdir()
    with pytest.raises(ValueError, match="cell.json"):
        read_tiny(str(tmp_path))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_driver_observes_what_its_judge_reads(cell):
    import harness

    c = harness.Cell(cell, TINY[cell])
    driver = harness.part("drivers", c.traffic["driver"])
    obs = driver.run(c, seed=2**37 + 5, seconds=1.0, trace=False, device="cpu",
                     started=time.time())["observed"]
    assert os.path.isfile(os.path.join(BENCH, "reference", obs["algorithm"] + ".py"))
    assert int(obs["unit"]) > 0 and np.asarray(obs["limits"]).ndim == 1
    state = obs["state"]
    assert state.dtype == np.int64 and state.ndim == 2 and state.shape[1] == 3
    assert len(state) > 0
    if "codes" in obs:
        assert obs["codes"].ndim == 1 and len(obs["codes"]) > 0
        assert obs["remaining"].shape == obs["codes"].shape
        assert len(obs["now"]) == len(obs["chunk_pool"]) > 0
        for key in ("pool", "sample_idx", "sampled", "lease"):
            assert key in obs, key
    if "rpcs" in obs:
        columns = ("id", "t_send", "t_recv", "lat_us", "overall", "code", "remaining", "err")
        assert set(columns) <= set(obs["rpcs"])
        assert len({len(obs["rpcs"][k]) for k in columns}) == 1 and len(obs["rpcs"]["id"]) > 0
    # The judge reads exactly this and finds the program right.
    assert all(v == 0 for v, _ in harness.judge(c, obs).values())
