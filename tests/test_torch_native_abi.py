"""The port's native-abi-contract: its C parser on the CUDA sources,
the SIGNATURES table form against csrc/*.cu, the slot table's ctypes
table against native/*.cpp plus csrc/slot_release.cpp, parity with the
JAX rule on the JAX package's .cpp fixtures, seeded drifts in fixtures
and in a copy of the real table, and one CUDA constant pinned."""

import collections
import ctypes
import os
import shutil
from pathlib import Path

import pytest

from ratelimit_tpu.analysis.engine import analyze_paths as jax_analyze
from ratelimit_tpu.analysis.native_abi import make_native_abi_rules as jax_abi
from ratelimit_tpu_torch import kernels
from ratelimit_tpu_torch.analysis.cparse import parse_source, parse_sources
from ratelimit_tpu_torch.analysis.engine import analyze_paths, build_context
from ratelimit_tpu_torch.analysis.native_abi import (
    find_native_sources,
    make_native_abi_rules,
    parse_binding_module,
    parse_signature_table,
)
from ratelimit_tpu_torch.analysis.project import ProjectIndex
from ratelimit_tpu_torch.backends import native_slot_table as nst

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ratelimit_tpu_torch"
JAX_FIXTURES = REPO / "tests" / "lint_fixtures" / "project"
FIXTURES = REPO / "tests" / "torch_lint_fixtures"
CUDA_SOURCES = sorted((PORT / "csrc").glob("*.cu"))


def abi(paths):
    findings, _ = analyze_paths(
        [str(p) for p in paths], rules=[], project_rules=make_native_abi_rules()
    )
    return findings


def module_of(path):
    index = ProjectIndex([build_context(str(path), Path(path).read_text())])
    [mod] = index.modules.values()
    return mod


# -- the C parser on CUDA ------------------------------------------------------


def test_cparse_cuda_one_shot_and_multiword_scalars():
    model = parse_source(
        "k.cu",
        text="""
constexpr long long kBlocks = 2048;
constexpr unsigned long long kBig = 0xFFull;
__global__ void body(uint32_t* t, long long n) {}
extern "C" int rl_a(void* t, long long n, const void* p, int k, void* s) {
  body<<<1, 32, 0, static_cast<cudaStream_t>(s)>>>(nullptr, n);
  return 0;
}
extern "C" int rl_b(void* host, void** device) { return 0; }
extern "C" unsigned long long rl_c(unsigned long long x, unsigned int y);
""",
    )
    assert set(model.functions) == {"rl_a", "rl_b", "rl_c"}
    assert model.constants == {"kBlocks": 2048, "kBig": 0xFF}
    a = model.functions["rl_a"]
    assert a.ret.describe() == "int32_t"
    assert [p.ctype.describe() for p in a.params] == [
        "void*", "int64_t", "void*", "int32_t", "void*"
    ]
    assert [p.name for p in a.params] == ["t", "n", "p", "k", "s"]
    b = model.functions["rl_b"]
    assert [p.ctype.describe() for p in b.params] == ["void*", "void*"]
    c = model.functions["rl_c"]
    assert c.ret.describe() == "uint64_t"
    assert [p.ctype.describe() for p in c.params] == ["uint64_t", "uint32_t"]


@pytest.mark.parametrize("src", CUDA_SOURCES, ids=lambda p: p.name)
def test_every_cuda_entry_parses_fully(src):
    model = parse_source(str(src))
    assert model.functions, src
    for fn in model.functions.values():
        assert fn.ret.describe() == "int32_t", fn.name
        for p in fn.params:
            assert p.ctype.kind != "unknown", (fn.name, p)


def test_cuda_exports_are_the_signatures_keys():
    model = parse_sources([str(p) for p in CUDA_SOURCES])
    assert set(model.functions) == set(kernels.SIGNATURES)
    assert len(model.functions) == 13


def test_max_lanes_pinned_to_the_cuda_constant():
    """The lane rule's cap in Python equals the by-value launchers'
    struct size in CUDA (csrc/by_value.cuh)."""
    from ratelimit_tpu_torch.models.fixed_window import MAX_LANES

    consts = parse_source(str(PORT / "csrc" / "by_value.cuh")).constants
    assert consts["kMaxLanes"] == MAX_LANES == 128


# -- the SIGNATURES table form ---------------------------------------------------


def test_signature_table_reads_all_thirteen_entries():
    table = parse_signature_table(module_of(PORT / "kernels.py"))
    assert table is not None
    assert set(table.decls) == set(kernels.SIGNATURES)
    assert table.sources == kernels.SOURCES
    for sym, (lib, argtypes) in kernels.SIGNATURES.items():
        assert table.libraries[sym] == lib
        # alias resolution and the *_GENERAL_STEP splat give the live
        # table's ctypes types, in order (a POINTER(...) reads as
        # c_void_p: any pointer fits a C pointer parameter)
        parsed = [getattr(ctypes, n) for n in table.decls[sym].argtypes]
        assert len(parsed) == len(argtypes), sym
        for got, want in zip(parsed, argtypes):
            assert got is want or (
                got is ctypes.c_void_p and issubclass(want, ctypes._Pointer)
            ), (sym, got, want)
        assert table.decls[sym].restype == "c_int"


def test_port_tree_abi_clean():
    findings = abi([PORT])
    assert findings == [], [f.text() for f in findings]


def test_seeded_table_drifts_are_caught():
    findings = abi([FIXTURES / "sigabi"])
    assert all(f.path.endswith("sigabi/kernels.py") for f in findings)
    msgs = [f.message for f in findings]
    assert len(msgs) == 5, msgs
    assert any(
        "rl_step: argtypes[1] is c_int32" in m and "num_slots" in m and "int64_t" in m
        for m in msgs
    ), msgs
    assert any("rl_decide: argtypes declares 5" in m and "takes 6" in m for m in msgs)
    assert any("declares rl_missing but no extern" in m for m in msgs)
    assert any("rl_undeclared" in m and "no ctypes argtypes" in m for m in msgs)
    assert any("rl_orphan" in m and "SOURCES does not name" in m for m in msgs)


def test_clean_table_fixture():
    assert abi([FIXTURES / "sigabi_ok"]) == []


def _copy_port_table(tmp_path):
    pkg = tmp_path / "port"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    shutil.copy(PORT / "kernels.py", pkg / "kernels.py")
    for src in CUDA_SOURCES:
        shutil.copy(src, pkg / "csrc" / src.name)
    return pkg


@pytest.mark.parametrize(
    "old, new, expect",
    [
        # a slot count narrowed to 32 bits
        (
            '"rl_fw_unique_step": (\n        "fixed_window",\n'
            "        [_VP, _I64,",
            '"rl_fw_unique_step": (\n        "fixed_window",\n'
            "        [_VP, _I32,",
            "rl_fw_unique_step: argtypes[1] is c_int",
        ),
        # a parameter dropped from the general step's shared tail
        (
            "_GENERAL_STEP = [_VP, _VP, _VP, _VP, _VP, _F32,",
            "_GENERAL_STEP = [_VP, _VP, _VP, _VP, _F32,",
            "rl_fw_general_step: argtypes declares 14",
        ),
        # a float where the kernel takes an int
        (
            '"rl_per_slot_inclusive_prefix": ("prefix", [_VP, _VP, _VP, _I32, _VP])',
            '"rl_per_slot_inclusive_prefix": ("prefix", [_VP, _VP, _VP, _F32, _VP])',
            "rl_per_slot_inclusive_prefix: argtypes[3] is c_float",
        ),
    ],
    ids=["width", "arity", "kind"],
)
def test_drift_in_a_copy_of_the_real_table(tmp_path, old, new, expect):
    pkg = _copy_port_table(tmp_path)
    assert abi([pkg]) == []  # the copy is clean before the edit
    src = (pkg / "kernels.py").read_text()
    assert old in src
    (pkg / "kernels.py").write_text(src.replace(old, new, 1))
    msgs = [f.message for f in abi([pkg])]
    assert any(expect in m for m in msgs), msgs


def test_renamed_cuda_entry_in_a_copy(tmp_path):
    pkg = _copy_port_table(tmp_path)
    cu = pkg / "csrc" / "algorithms.cu"
    cu.write_text(cu.read_text().replace("rl_gcra_serve_step_lanes(", "rl_gcra_lanes(", 1))
    msgs = [f.message for f in abi([pkg])]
    assert any("declares rl_gcra_serve_step_lanes but no extern" in m for m in msgs)
    assert any("rl_gcra_lanes" in m and "no ctypes argtypes" in m for m in msgs)


# -- the slot table's ctypes table ---------------------------------------------------


def test_slot_table_sources_union_native_and_csrc():
    srcs = [os.path.relpath(p, REPO) for p in find_native_sources(
        str(PORT / "backends" / "native_slot_table.py"))]
    assert "ratelimit_tpu_torch/csrc/slot_release.cpp" in srcs
    assert "native/slot_table.cpp" in srcs and "native/decide.cpp" in srcs
    assert not [s for s in srcs if s.endswith((".cu", ".cuh"))]


def test_slot_table_binding_sees_every_sk_symbol():
    binding = parse_binding_module(module_of(PORT / "backends" / "native_slot_table.py"))
    declared = {s for s, d in binding.decls.items() if d.argtypes is not None}
    assert declared == nst.expected_symbols()
    assert "sk_release_batch" in declared
    model = parse_sources(find_native_sources(str(PORT / "backends" / "native_slot_table.py")))
    assert set(model.functions) == declared


# -- parity with the JAX rule on its .cpp fixtures --------------------------------------


@pytest.mark.parametrize("name", ["nativeabi", "nativeabi_ok", "nativeabi_suppressed"])
def test_native_abi_parity_on_jax_fixtures(name):
    def key(findings):
        return collections.Counter(
            (f.rule_id, os.path.relpath(f.path, REPO), f.line) for f in findings
        )

    path = str(JAX_FIXTURES / name)
    jax, _ = jax_analyze([path], rules=[], project_rules=jax_abi())
    assert key(abi([path])) == key(jax)
