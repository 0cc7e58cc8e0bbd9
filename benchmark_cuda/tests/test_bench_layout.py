"""Every cell that BENCHMARK.json or held.json names has each part the
harness finds by name, and every name an entry gives leads to an entry.
Fast: no cell runs."""

import json
import os

import pytest

from conftest import BENCH, HERE, ROOT

import harness


def spec() -> dict:
    return harness.with_held(harness.read_json(os.path.join(ROOT, "BENCHMARK.json")))


CELLS = sorted(w["name"] for w in spec()["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_of_a_cell_is_there(cell):
    c = harness.Cell(cell)
    configs = {e["name"]: e for e in c.spec["configs"]}
    assert os.path.isfile(os.path.join(ROOT, configs[c.workload["config"]]["file"]))
    assert os.path.isfile(os.path.join(BENCH, "traffic", c.workload["traffic"] + ".json"))
    driver = c.traffic["driver"]
    assert os.path.isfile(os.path.join(BENCH, "drivers", driver + ".py")), driver
    assert os.path.isfile(os.path.join(BENCH, "judge", driver + ".py")), driver
    algorithm = c.config["algorithm"]
    assert os.path.isfile(os.path.join(BENCH, "reference", algorithm + ".py")), algorithm
    untraced, traced = c.metrics(traced=False), c.metrics(traced=True)
    assert "setup_s" in {m["name"] for m in untraced} and len(untraced) >= 2
    assert traced
    for m in untraced + traced:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    assert os.path.isfile(os.path.join(HERE, "tiny", cell + ".json"))


def test_every_name_an_entry_gives_leads_to_an_entry():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[key]]
        assert len(names) == len(set(names)), key
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    for m in s["per_layer"]:
        assert m["moves"] in e2e, m["name"]
    assert {w["config"] for w in s["workloads"]} == {c["name"] for c in s["configs"]}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        assert os.path.relpath(BENCH, ROOT) in json.load(f)["paths"]
