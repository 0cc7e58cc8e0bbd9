"""The benchmark's core: finds a cell's configuration, traffic mix,
driver, reference and metric readers by the names in BENCHMARK.json,
runs the cell once, judges it and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

- ``configs/<config>.json`` (the path BENCHMARK.json gives): the
  deployment, its rules, its settings and its address space;
- ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``driver`` that runs it (``drivers/<driver>.py``);
- ``reference/<algorithm>.py``: the plain reference of the
  configuration's algorithm, and ``judge/<driver>.py`` the comparison of
  what a driver saw against it;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning
  the value, or None where the run has nothing to read;
- ``held.json``: cells (with their configurations and metrics) that run
  by name but that BENCHMARK.json does not list yet.

So a later cell, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names the run may not hold once its window has
#: closed: JAX and the JAX package (compared as whole names, so the
#: port ``ratelimit_tpu_torch`` is not one of them).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ratelimit_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (from
    /proc/self/stat), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def load_module(path: str, name: str):
    """Import the file at `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def part(kind: str, name: str):
    """benchmark_cuda/<kind>/<name>.py, imported once."""
    mod_name = f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    return load_module(os.path.join(HERE, kind, f"{name}.py"), mod_name)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def with_held(spec: dict) -> dict:
    """BENCHMARK.json's spec with the configurations, cells and metrics of
    held.json (cells whose parts are here but which BENCHMARK.json does
    not list) after its own; a held metric that BENCHMARK.json names too
    adds its ``workloads`` to that entry."""
    held = read_json(os.path.join(HERE, "held.json"))
    out = dict(spec)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [dict(e) for e in spec[key]]
        by_name = {e["name"]: e for e in entries}
        for e in held.get(key, []):
            if e["name"] not in by_name:
                entries.append(e)
            elif "workloads" in e:
                by_name[e["name"]]["workloads"] = by_name[e["name"]]["workloads"] + e["workloads"]
        out[key] = entries
    return out


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names."""

    def __init__(self, name: str, overrides: dict = None):
        self.spec = with_held(read_json(os.path.join(ROOT, "BENCHMARK.json")))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = read_json(os.path.join(ROOT, configs[self.workload["config"]]["file"]))
        self.traffic = read_json(
            os.path.join(HERE, "traffic", f"{self.workload['traffic']}.json")
        )
        for key, value in (overrides or {}).items():
            # Tests shrink a cell: "config.keys.count" -> config["keys"]["count"].
            where, *path = key.split(".")
            node = getattr(self, where)
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = value
        # A traffic mix may set its own address space and skew.
        self.keys = dict(self.config["keys"], **self.traffic.get("keys", {}))

    def metrics(self, traced: bool) -> list:
        """The metric entries this cell reports: the end-to-end ones with
        --trace 0, the per-layer ones with --trace 1."""
        e2e = self.spec["end_to_end"]
        mine = [m["name"] for m in e2e if self.name in m.get("workloads", [self.name])]
        if not traced:
            return [m for m in e2e if m["name"] in mine]
        return [
            m
            for m in self.spec["per_layer"]
            if self.name in m.get("workloads", [self.name] if m["moves"] in mine else [])
        ]


def judge(cell: Cell, obs: dict, control: bool = False) -> dict:
    """{check: (value, limit)} of the cell's comparison with its
    reference (with `control`, of the control put in the program's
    place)."""
    return part("judge", cell.traffic["driver"]).judge(obs, control=control)


def forbidden_loaded() -> list:
    """Forbidden top-level modules present in sys.modules."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    overrides: dict = None,
    control: bool = False,
    started: float = None,
) -> dict:
    """Run one cell once and return its result object (the last line)."""
    started = process_start() if started is None else started
    cell = Cell(name, overrides)
    driver = part("drivers", cell.traffic["driver"])
    run = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device, started=started)
    metrics = {}
    for m in cell.metrics(trace):
        value = part("metrics", m["name"]).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"{name}: end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    obs = run["observed"]
    checks = judge(cell, obs)
    out = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": int(run["attempted"]),
        "failed": int(run["failed"]),
        "metrics": metrics,
        "device": run["device"],
    }
    if trace and run.get("breakdown"):
        out["breakdown"] = run["breakdown"]
    if not trace:
        # The per-layer metrics the host's clock gives (a tail at
        # capacity) are recorded in the untraced run too, not judged.
        recorded = {}
        for m in cell.metrics(True):
            value = part("metrics", m["name"]).read(run) if m["source"] == "host_clock" else None
            if value is not None:
                recorded[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if recorded:
            out["recorded"] = recorded
    if control:
        out["control"] = {k: {"value": v, "limit": lim} for k, (v, lim) in judge(
            cell, obs, control=True).items()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
