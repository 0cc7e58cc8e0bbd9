"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port, ``ratelimit_tpu_torch``, begins
with the JAX package's name and is not it), nor reads the JAX package's
benchmarks; the reference imports nothing of the port either."""

import ast
import os
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "ratelimit_tpu"}


def _sources(sub=""):
    root = os.path.join(BENCH, sub)
    for dirpath, _dirs, files in os.walk(root):
        if "tests" in os.path.relpath(dirpath, BENCH).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_harness_imports_neither_jax_nor_the_jax_package():
    for path in _sources():
        assert not _top_level_imports(path) & FORBIDDEN, path
        assert "benchmarks/" not in open(path).read(), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert not _top_level_imports(path) & (FORBIDDEN | {"ratelimit_tpu_torch", "torch"}), path


@pytest.mark.parametrize("loaded, flagged", [
    (["ratelimit_tpu_torch", "ratelimit_tpu_torch.kernels"], []),
    (["ratelimit_tpu.models"], ["ratelimit_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["jax_helpers", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(loaded, flagged, monkeypatch):
    import harness

    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in harness.forbidden_loaded() if m in {n.split(".")[0] for n in loaded}] == flagged


def test_a_cell_run_leaves_no_forbidden_module():
    import harness
    from conftest import run_tiny

    run_tiny("fw_engine_4096", seconds=1.0)
    assert harness.forbidden_loaded() == []
