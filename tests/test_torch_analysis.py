"""The port's static analyzer (ratelimit_tpu_torch.analysis) against
the JAX package's, and on its own rules and tree.

- every rule the two packages share, run through both analyzers on the
  JAX package's fixtures (tests/lint_fixtures/, read only), gives the
  same (rule, path, line) multiset;
- the torch twins (torch-host-sync, torch-dtype-discipline) fire on
  their seeded fixtures (tests/torch_lint_fixtures/) and nowhere else;
- the committed port tree is clean against its own baseline, which
  holds only hot-path-cost entries;
- the whole-program index sees the port's thread spawners and pools.
"""

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ratelimit_tpu.analysis import engine as jax_engine
from ratelimit_tpu.analysis import rules as jax_rules
from ratelimit_tpu.analysis.concurrency import (
    make_concurrency_rules as jax_concurrency,
)
from ratelimit_tpu.analysis.contracts import make_contract_rules as jax_contracts
from ratelimit_tpu.analysis.hotpath import make_hotpath_rules as jax_hotpath
from ratelimit_tpu.analysis.native_abi import make_native_abi_rules as jax_abi
from ratelimit_tpu_torch.analysis import engine, rules
from ratelimit_tpu_torch.analysis.__main__ import main as cli_main
from ratelimit_tpu_torch.analysis.baseline import (
    load_baseline,
    new_findings,
    write_baseline,
)
from ratelimit_tpu_torch.analysis.concurrency import make_concurrency_rules
from ratelimit_tpu_torch.analysis.contracts import make_contract_rules
from ratelimit_tpu_torch.analysis.hotpath import make_hotpath_rules
from ratelimit_tpu_torch.analysis.native_abi import make_native_abi_rules
from ratelimit_tpu_torch.analysis.project import ProjectIndex, module_name_for

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURES = REPO / "tests" / "torch_lint_fixtures"
PORT = REPO / "ratelimit_tpu_torch"

# -- shared rules on the same input ------------------------------------------

#: Per-file rules both packages carry, by class name.
SHARED_FILE_RULES = (
    "LockDisciplineRule",
    "EnvDisciplineRule",
    "TimingDisciplineRule",
    "MetricsDisciplineRule",
)
SHARED_FILE_IDS = (
    "lock-discipline",
    "env-discipline",
    "timing-discipline",
    "metrics-discipline",
)
#: Whole-program rules both packages carry.
SHARED_PROJECT_IDS = (
    "lock-order-cycle",
    "blocking-under-lock",
    "shared-state",
    "bounded-wait",
    "hot-path-cost",
    "dtype-pack-contract",
    "native-abi-contract",
)

#: One analysis input each: the top-level fixture files, the ops/
#: files, and every project fixture package.
JAX_INPUTS = ["files", "ops"] + sorted(
    p.name for p in (JAX_FIXTURES / "project").iterdir() if p.is_dir()
)


def _paths(name):
    if name == "files":
        return sorted(str(p) for p in JAX_FIXTURES.glob("*.py"))
    if name == "ops":
        return [str(JAX_FIXTURES / "ops")]
    return [str(JAX_FIXTURES / "project" / name)]


def _key(findings):
    return collections.Counter(
        (f.rule_id, os.path.relpath(f.path, REPO), f.line) for f in findings
    )


_CACHE = {}


def _both(name):
    """(JAX findings, port findings) for one input, shared rules only."""
    if name not in _CACHE:
        paths = _paths(name)
        jax, _ = jax_engine.analyze_paths(
            paths,
            rules=[getattr(jax_rules, c)() for c in SHARED_FILE_RULES],
            project_rules=jax_concurrency()
            + jax_contracts()
            + jax_hotpath()
            + jax_abi(),
        )
        port, _ = engine.analyze_paths(
            paths,
            rules=[getattr(rules, c)() for c in SHARED_FILE_RULES],
            project_rules=make_concurrency_rules()
            + make_contract_rules()
            + make_hotpath_rules()
            + make_native_abi_rules(),
        )
        _CACHE[name] = (jax, port)
    return _CACHE[name]


@pytest.mark.parametrize("rule", SHARED_FILE_IDS + SHARED_PROJECT_IDS)
@pytest.mark.parametrize("name", JAX_INPUTS)
def test_shared_rule_parity_on_jax_fixtures(name, rule):
    jax, port = _both(name)
    want = _key(f for f in jax if f.rule_id == rule)
    got = _key(f for f in port if f.rule_id == rule)
    assert got == want


@pytest.mark.parametrize("rule", SHARED_FILE_IDS + SHARED_PROJECT_IDS)
def test_parity_is_not_vacuous(rule):
    """Every shared rule fires on some JAX fixture, so the parity above
    compares real findings."""
    assert any(
        f.rule_id == rule for name in JAX_INPUTS for f in _both(name)[0]
    ), rule


# -- the rule pack -------------------------------------------------------------


def test_rule_pack_ids():
    file_ids = [r.id for r in rules.DEFAULT_RULES]
    project_ids = [r.id for r in rules.DEFAULT_PROJECT_RULES]
    assert file_ids == [
        "lock-discipline",
        "env-discipline",
        "torch-dtype-discipline",
        "timing-discipline",
        "metrics-discipline",
    ]
    assert sorted(project_ids) == sorted(SHARED_PROJECT_IDS + ("torch-host-sync",))
    assert len(file_ids) + len(project_ids) == 13
    assert not {"jax-host-sync", "dtype-discipline"} & set(file_ids + project_ids)


def test_cli_list_rules_and_unknown_select(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "torch-host-sync:" in out and "torch-dtype-discipline:" in out
    assert "jax-host-sync" not in out
    assert len(out.strip().splitlines()) == 13
    assert cli_main(["--select", "jax-host-sync", str(FIXTURES / "clean")]) == 2


# -- torch-host-sync -----------------------------------------------------------


def _port(paths, file_rules=(), project_rules=()):
    findings, _ = engine.analyze_paths(
        [str(p) for p in paths],
        rules=list(file_rules),
        project_rules=list(project_rules),
    )
    return findings


def test_torch_host_sync_seeded_positives():
    findings = _port([FIXTURES / "host_sync"], project_rules=[rules.TorchHostSyncRule()])
    assert all(f.path.endswith("engine.py") for f in findings)
    # .item(), .cpu(), torch.cuda.synchronize(), current_stream()
    # .synchronize(), an event's .synchronize(), a tensor's .tolist()
    # and .numpy() -- and not numpy's .tolist(), a pinned host
    # tensor's .numpy(), the suppressed line or the unreachable one.
    assert [f.line for f in findings] == [15, 16, 17, 18, 21, 22, 23]
    msgs = " | ".join(f.message for f in findings)
    assert "torch.cuda.current_stream().synchronize()" in msgs
    assert "done.synchronize()" in msgs
    assert "reachable from host_sync.service:Service.should_rate_limit" in msgs


def test_torch_host_sync_on_the_port_is_one_suppressed_wait():
    """The port's only host wait on the request path is the completer's
    event wait in CounterEngine._fetch, suppressed with its reason."""
    src = (PORT / "backends" / "engine.py").read_text().splitlines()
    [line] = [s for s in src if "st.event.synchronize()" in s]
    assert "tpu-lint: disable=torch-host-sync -- " in line
    findings = _port([PORT], project_rules=[rules.TorchHostSyncRule()])
    assert findings == [], [f.text() for f in findings]


# -- torch-dtype-discipline ----------------------------------------------------


def test_torch_dtype_discipline_seeded_positives():
    findings = _port(
        [FIXTURES / "ops", FIXTURES / "host"],
        file_rules=[rules.TorchDtypeDisciplineRule()],
    )
    assert all(f.path.endswith("ops/dtype_violation.py") for f in findings)
    # five factories without dtype=, four bare-literal scatters
    assert [f.line for f in findings] == [9, 10, 11, 12, 13, 21, 22, 23, 24]
    assert sum("without dtype=" in f.message for f in findings) == 5


def test_torch_dtype_discipline_clean_on_the_port():
    findings = _port([PORT], file_rules=[rules.TorchDtypeDisciplineRule()])
    assert findings == [], [f.text() for f in findings]


# -- the clean fixture -----------------------------------------------------------


def test_clean_fixture_has_no_findings():
    findings, n = engine.analyze_paths([str(FIXTURES / "clean")])
    assert findings == [], [f.text() for f in findings]
    assert n == 5


# -- the committed tree against its baseline -------------------------------------


def test_port_tree_clean_against_its_baseline():
    """The twin of the JAX package's test_full_tree_clean_and_fast: the
    port's tree yields nothing beyond its committed hot-path-cost
    ratchet, with no dead entries, well inside 10 s."""
    t0 = time.monotonic()
    findings, n_files = engine.analyze_paths([str(PORT)])
    elapsed = time.monotonic() - t0
    doc = load_baseline()
    fresh = new_findings(findings, doc)
    assert fresh == [], [f.text() for f in fresh]
    assert {f.rule_id for f in findings} <= {"hot-path-cost"}
    assert {e["rule"] for e in doc["findings"]} == {"hot-path-cost"}
    assert len(findings) == len(doc["findings"])
    assert all(e["path"].startswith("ratelimit_tpu_torch/") for e in doc["findings"])
    assert n_files > 90
    assert elapsed < 10.0, f"analyzer took {elapsed:.1f}s"


def test_cli_fail_on_new_exits_zero_on_the_port():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ratelimit_tpu_torch.analysis", "--fail-on-new",
         "--format=json"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["count"] == 0 and doc["baselined"] == len(load_baseline()["findings"])
    assert doc["files_checked"] > 90  # the default path is the port


def test_cli_fails_on_a_new_finding(tmp_path, capsys):
    base = str(tmp_path / "baseline.json")
    assert cli_main(["--write-baseline", "--baseline", base,
                     str(FIXTURES / "clean")]) == 0
    capsys.readouterr()
    assert cli_main(["--fail-on-new", "--baseline", base,
                     str(FIXTURES / "host_sync")]) == 1
    assert "torch-host-sync" in capsys.readouterr().out


def test_baseline_round_trip_and_multiset(tmp_path):
    f = engine.Finding("r", "ratelimit_tpu_torch/x.py", 3, 0, "m")
    moved = engine.Finding("r", "ratelimit_tpu_torch/x.py", 99, 0, "m")
    p = tmp_path / "b.json"
    write_baseline([f], str(p))
    doc = load_baseline(str(p))
    assert new_findings([moved], doc) == []  # the line is no identity
    assert new_findings([f, moved], doc) == [moved]
    assert load_baseline(str(tmp_path / "absent.json"))["findings"] == []


# -- the whole-program index on the port -----------------------------------------


@pytest.fixture(scope="module")
def port_index():
    ctxs = []
    for f in engine.iter_python_files([str(PORT)]):
        ctx = engine.build_context(f, Path(f).read_text(encoding="utf-8"))
        assert not isinstance(ctx, engine.Finding), f
        ctxs.append(ctx)
    return ProjectIndex(ctxs)


def test_module_names_are_the_ports():
    assert (
        module_name_for(str(PORT / "backends" / "dispatcher.py"))
        == "ratelimit_tpu_torch.backends.dispatcher"
    )


@pytest.mark.parametrize(
    "root",
    [
        "ratelimit_tpu_torch.backends.dispatcher:BatchDispatcher._collect_loop",
        "ratelimit_tpu_torch.backends.dispatcher:BatchDispatcher._complete_loop",
        "ratelimit_tpu_torch.backends.fault_domain:DeviceFaultDomain._loop",
        "ratelimit_tpu_torch.backends.checkpoint:CheckpointManager._loop",
        "ratelimit_tpu_torch.observability.detectors:AnomalyDetectors._loop",
        "ratelimit_tpu_torch.observability.timeseries:TimeSeriesStore._loop",
        "ratelimit_tpu_torch.cluster.proxy:RouterHolder._run_handoff",
    ],
)
def test_port_thread_spawners_are_roots(port_index, root):
    assert root in {r.fn.qualname for r in port_index.thread_roots}


@pytest.mark.parametrize(
    "module",
    ["ratelimit_tpu_torch.server.grpc_server", "ratelimit_tpu_torch.cluster.proxy"],
)
def test_port_pools_are_seen(port_index, module):
    assert port_index.modules[module].has_pool


def test_hot_path_roots_include_the_dispatcher_loops(port_index):
    from ratelimit_tpu_torch.analysis.hotpath import HOT_PATH_ROOTS

    assert {"_collect_loop", "_complete_loop"} <= HOT_PATH_ROOTS
    names = {fn.name for fn in port_index.functions.values()}
    assert {"should_rate_limit", "do_limit", "do_limit_resolved"} <= names
