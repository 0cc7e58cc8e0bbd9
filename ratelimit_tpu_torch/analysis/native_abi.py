"""`native-abi-contract`: the Python<->C boundary checker.

The port declares, in ctypes, what it believes two ``extern "C"``
surfaces look like: backends/native_slot_table.py for the host slot
table (native/*.cpp and csrc/slot_release.cpp) and the ``SIGNATURES``
table of kernels.py for the CUDA kernels' launchers (csrc/*.cu).
Nothing on a machine without a card verifies the second belief at
all.  A drifted argtype width, a forgotten
``restype`` (ctypes then defaults to a 32-bit int and truncates
pointers and int64s), or a call into a symbol the .so no longer
exports is a silent segfault or silent corruption — the worst failure
class on the serving path.  This rule makes each of those a lint
finding (extending the dtype-pack-contract fold across the
language boundary):

1. **symbol set** — every ``extern "C"`` function must have a ctypes
   ``argtypes`` declaration, and every declared symbol must exist in
   the sources (a removed/renamed export is caught before the first
   dlopen);
2. **arity** — len(argtypes) == the C parameter count;
3. **width/kind per parameter** — C pointers may be declared
   ``c_void_p`` (the raw-address marshaling convention) or any ctypes
   pointer; C scalars must match width and kind (``int64_t`` ==
   c_int64/c_uint64, ``float`` == c_float, ...);
4. **restype** — required for every non-void C function, must match
   width/kind; a void function must not declare a value restype;
5. **call-site dtype widths** — an array created in the binding module
   with a known numpy dtype and passed (via the ``_ptr(...)`` raw-
   address helper) to a C pointer parameter must have the pointee's
   element width (`np.int32` buffer into a ``uint64_t*`` parameter is
   an out-of-bounds write the moment n > 0) — the same layout-pin
   discipline the dtype-pack-contract rule applies to LANE_DTYPE /
   FLIGHT_DTYPE, extended to the FFI call sites.

All findings anchor in the *binding module* (the .py side), so the
engine's line-suppression machinery applies unchanged; messages name
the C site (file:line) for navigation.

Binding modules are discovered structurally, in two forms:

- **attribute form**: any indexed module that assigns
  ``<lib>.<symbol>.argtypes``.  Its C sources are the C/C++ files of
  the module's own directory (fixtures put the C file next to the
  binding), else the union of the first ``native/`` and the first
  ``csrc/`` directory holding ``*.cpp``/``*.cc``/``*.c`` among up to
  three ancestors -- the port compiles native/slot_table.cpp and
  csrc/slot_release.cpp into one library.
- **table form**: a module-level ``SIGNATURES = {name: (library,
  [argtypes])}`` dict beside a ``SOURCES = {library: file}`` dict
  (kernels.py).  Aliases (``_VP``, ``_I64``) resolve through the
  module's assignments and list splats (``*_GENERAL_STEP``) expand;
  the restype is the one the module's loop over ``SIGNATURES.items()``
  assigns.  Each library's entries are checked against
  ``csrc/<SOURCES[library]>`` alone: name, arity, and width and kind
  per parameter.

Port of ratelimit_tpu/analysis/native_abi.py.
"""

from __future__ import annotations

import ast
import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cparse import C_GLOBS, CUDA_GLOBS, CModel, CType, parse_source, parse_sources
from .engine import Finding
from .project import ModuleInfo, ProjectIndex, ProjectRule

# -- ctypes-side model -------------------------------------------------------

#: ctypes name -> (kind, width, signed); pointers carry width 0 (the
#: raw-address convention erases the pointee type on the Python side).
_CTYPES: Dict[str, Tuple[str, int, bool]] = {
    "c_bool": ("int", 1, False),
    "c_char": ("int", 1, True),
    "c_byte": ("int", 1, True),
    "c_ubyte": ("int", 1, False),
    "c_int8": ("int", 1, True),
    "c_uint8": ("int", 1, False),
    "c_int16": ("int", 2, True),
    "c_uint16": ("int", 2, False),
    "c_short": ("int", 2, True),
    "c_ushort": ("int", 2, False),
    "c_int": ("int", 4, True),
    "c_uint": ("int", 4, False),
    "c_int32": ("int", 4, True),
    "c_uint32": ("int", 4, False),
    "c_int64": ("int", 8, True),
    "c_uint64": ("int", 8, False),
    "c_longlong": ("int", 8, True),
    "c_ulonglong": ("int", 8, False),
    "c_size_t": ("int", 8, False),
    "c_ssize_t": ("int", 8, True),
    "c_float": ("float", 4, True),
    "c_double": ("float", 8, True),
    "c_void_p": ("pointer", 0, False),
    "c_char_p": ("pointer", 0, False),
}


@dataclass
class CTypesDecl:
    """The binding module's declaration for one exported symbol."""

    symbol: str
    argtypes: Optional[List[str]] = None  # ctypes names; None = unset
    restype: Optional[str] = None  # ctypes name | "void" | None = unset
    argtypes_line: int = 1
    restype_line: int = 1


@dataclass
class CallSiteArg:
    """One ``lib.sym(...)`` positional argument whose numpy dtype the
    binding module makes statically visible."""

    symbol: str
    index: int
    dtype: str  # numpy dtype name, e.g. "int64"
    line: int


@dataclass
class BindingModel:
    module: ModuleInfo
    decls: Dict[str, CTypesDecl] = field(default_factory=dict)
    call_args: List[CallSiteArg] = field(default_factory=list)
    anchor_line: int = 1  # first argtypes assignment: symbol-set anchor


#: numpy dtype name -> element byte width (np.bool_ stores one byte —
#: compatible with a uint8_t* out-parameter).
_NP_WIDTHS: Dict[str, int] = {
    "bool_": 1,
    "uint8": 1,
    "int8": 1,
    "uint16": 2,
    "int16": 2,
    "uint32": 4,
    "int32": 4,
    "uint64": 8,
    "int64": 8,
    "float32": 4,
    "float64": 8,
}


def _ctypes_name(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """Resolve an expression to a ctypes type name: ``ctypes.c_int64``,
    a local alias bound from one, ``None`` (void), or unresolvable."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Attribute) and node.attr in _CTYPES:
        return node.attr
    if isinstance(node, ast.Name):
        if node.id in _CTYPES:
            return node.id
        return env.get(node.id)
    if isinstance(node, ast.Call):
        # POINTER(...) / CFUNCTYPE(...): a typed pointer — fine for any
        # C pointer parameter.
        fname = ""
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        if fname in ("POINTER", "CFUNCTYPE"):
            return "c_void_p"
    return None


def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
    """name -> ctypes name for simple aliases, including tuple form
    (``i64, vp = ctypes.c_int64, ctypes.c_void_p``) at any scope."""
    env: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs: List[Tuple[ast.AST, ast.AST]] = []
        if isinstance(tgt, ast.Name):
            pairs.append((tgt, val))
        elif (
            isinstance(tgt, ast.Tuple)
            and isinstance(val, ast.Tuple)
            and len(tgt.elts) == len(val.elts)
        ):
            pairs.extend(zip(tgt.elts, val.elts))
        for t, v in pairs:
            if isinstance(t, ast.Name):
                resolved = _ctypes_name(v, env)
                if resolved and resolved != "void":
                    env[t.id] = resolved
    return env


def _np_dtype_name(node: ast.AST) -> Optional[str]:
    """``np.int64`` / ``numpy.uint32`` / ``"int64"`` -> dtype name."""
    if isinstance(node, ast.Attribute) and node.attr in _NP_WIDTHS:
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _NP_WIDTHS else None
    return None


#: numpy constructors whose dtype argument pins the element width:
#: name -> positional index of dtype (after the first argument).
_NP_CTORS = {
    "empty": 1,
    "zeros": 1,
    "ones": 1,
    "asarray": 1,
    "ascontiguousarray": 1,
    "frombuffer": 1,
    "fromiter": 1,
    "full": 2,
    "array": 1,
}


def _array_dtype(node: ast.AST) -> Optional[str]:
    """dtype name when `node` is a numpy constructor call with a
    statically visible dtype."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else ""
    )
    if name not in _NP_CTORS:
        return None
    for kw in node.keywords:
        if kw.arg == "dtype":
            return _np_dtype_name(kw.value)
    idx = _NP_CTORS[name]
    if len(node.args) > idx:
        return _np_dtype_name(node.args[idx])
    return None


class _BindingVisitor(ast.NodeVisitor):
    """One walk over the binding module collecting the ctypes table
    and the statically-typed FFI call-site arguments."""

    def __init__(self, env: Dict[str, str]):
        self.env = env
        self.decls: Dict[str, CTypesDecl] = {}
        self.call_args: List[CallSiteArg] = []
        self.anchor_line: Optional[int] = None
        # per enclosing function: local array name -> dtype name
        self._dtype_scope: List[Dict[str, str]] = [{}]

    # -- declarations ------------------------------------------------

    def _decl(self, symbol: str) -> CTypesDecl:
        return self.decls.setdefault(symbol, CTypesDecl(symbol))

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1:
            tgt = node.targets[0]
            # <lib expr>.<symbol>.(argtypes|restype) = ...
            if (
                isinstance(tgt, ast.Attribute)
                and tgt.attr in ("argtypes", "restype")
                and isinstance(tgt.value, ast.Attribute)
            ):
                symbol = tgt.value.attr
                decl = self._decl(symbol)
                if tgt.attr == "argtypes":
                    if self.anchor_line is None:
                        self.anchor_line = node.lineno
                    decl.argtypes_line = node.lineno
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        decl.argtypes = [
                            _ctypes_name(e, self.env) or "?"
                            for e in node.value.elts
                        ]
                else:
                    decl.restype_line = node.lineno
                    decl.restype = _ctypes_name(node.value, self.env)
            # local array binding: name = np.empty(..., dtype=np.X)
            if isinstance(tgt, ast.Name):
                dt = _array_dtype(node.value)
                if dt:
                    self._dtype_scope[-1][tgt.id] = dt
                elif tgt.id in self._dtype_scope[-1]:
                    del self._dtype_scope[-1][tgt.id]  # rebound opaquely
        self.generic_visit(node)

    # -- call sites ---------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._dtype_scope.append({})
        self.generic_visit(node)
        self._dtype_scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "_lib"
            or isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id in ("lib", "_lib")
        ):
            symbol = fn.attr
            if symbol in self.decls or symbol.startswith(("sk_", "rl_")):
                for i, arg in enumerate(node.args):
                    dt = self._arg_dtype(arg)
                    if dt is not None:
                        self.call_args.append(
                            CallSiteArg(symbol, i, dt, node.lineno)
                        )
        self.generic_visit(node)

    def _arg_dtype(self, arg: ast.AST) -> Optional[str]:
        """dtype of an argument of the form ``_ptr(x)`` /
        ``self._ptr(x)`` where x's dtype is visible in this scope, or
        a direct constructor call ``_ptr(np.empty(.., np.X))``."""
        if not (isinstance(arg, ast.Call) and len(arg.args) == 1):
            return None
        fn = arg.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        if name != "_ptr":
            return None
        inner = arg.args[0]
        direct = _array_dtype(inner)
        if direct:
            return direct
        if isinstance(inner, ast.Name):
            return self._dtype_scope[-1].get(inner.id)
        return None


def parse_binding_module(mod: ModuleInfo) -> Optional[BindingModel]:
    """BindingModel when `mod` declares a ctypes signature table."""
    env = _collect_aliases(mod.tree)
    v = _BindingVisitor(env)
    v.visit(mod.tree)
    if not any(d.argtypes is not None for d in v.decls.values()):
        return None
    return BindingModel(
        module=mod,
        decls=v.decls,
        call_args=v.call_args,
        anchor_line=v.anchor_line or 1,
    )


# -- C source discovery ------------------------------------------------------


def _glob_all(directory: str, patterns) -> List[str]:
    hits: List[str] = []
    for pat in patterns:
        hits.extend(glob.glob(os.path.join(directory, pat)))
    return sorted(hits)


def _ancestor_dir(module_path: str, sub: str, patterns) -> Optional[str]:
    """The first ``<ancestor>/<sub>`` holding a file of `patterns`,
    among the module's own directory and up to three ancestors."""
    d = os.path.dirname(os.path.abspath(module_path))
    for _ in range(4):
        cand = os.path.join(d, sub)
        if _glob_all(cand, patterns):
            return cand
        d = os.path.dirname(d)
    return None


def find_native_sources(module_path: str) -> List[str]:
    """C sources for an attribute-form binding module: the C, C++ and
    CUDA files of its own directory, else the union of the first
    ``native/`` and the first ``csrc/`` holding C or C++ files beside
    the module or up to three ancestors (in-tree:
    ratelimit_tpu_torch/backends -> <repo>/native +
    ratelimit_tpu_torch/csrc).  The ``.cu`` files of ``csrc/`` belong
    to the SIGNATURES table, not to this library."""
    own = _glob_all(os.path.dirname(os.path.abspath(module_path)), C_GLOBS + CUDA_GLOBS)
    if own:
        return own
    found: List[str] = []
    for sub in ("native", "csrc"):
        d = _ancestor_dir(module_path, sub, C_GLOBS)
        if d is not None:
            found.extend(_glob_all(d, C_GLOBS))
    return sorted(found)


# -- the SIGNATURES table form -----------------------------------------------


@dataclass
class SignatureTable:
    """A module's ``SIGNATURES`` table, split by library."""

    module: ModuleInfo
    sources: Dict[str, str]  # library -> source file name (SOURCES)
    libraries: Dict[str, str] = field(default_factory=dict)  # sym -> lib
    decls: Dict[str, CTypesDecl] = field(default_factory=dict)
    anchor_line: int = 1


def _module_assign(tree: ast.Module, name: str) -> Optional[ast.Assign]:
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            return node
    return None


def _expand_argtypes(
    node: ast.AST, env: Dict[str, str], lists: Dict[str, ast.List]
) -> Optional[List[str]]:
    """ctypes names of a list literal, splats of module-level lists
    expanded; None when the list cannot be read."""
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    out: List[str] = []
    for e in node.elts:
        if isinstance(e, ast.Starred):
            inner = (
                lists.get(e.value.id) if isinstance(e.value, ast.Name) else None
            )
            sub = (
                _expand_argtypes(inner, env, lists) if inner is not None else None
            )
            if sub is None:
                return None
            out.extend(sub)
        else:
            out.append(_ctypes_name(e, env) or "?")
    return out


def _loop_restype(tree: ast.Module, env: Dict[str, str]):
    """(restype, line) that a loop over ``SIGNATURES.items()`` assigns
    to each bound function, or (None, 1) when there is none."""
    for loop in ast.walk(tree):
        if not isinstance(loop, ast.For):
            continue
        it = loop.iter
        if isinstance(it, ast.Call):
            it = it.func.value if isinstance(it.func, ast.Attribute) else it
        if not (isinstance(it, ast.Name) and it.id == "SIGNATURES"):
            continue
        for node in ast.walk(loop):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "restype"
            ):
                return _ctypes_name(node.value, env), node.lineno
    return None, 1


def parse_signature_table(mod: ModuleInfo) -> Optional[SignatureTable]:
    """SignatureTable when `mod` declares ``SIGNATURES`` and ``SOURCES``
    as dict literals at module level."""
    sig = _module_assign(mod.tree, "SIGNATURES")
    src = _module_assign(mod.tree, "SOURCES")
    if sig is None or src is None:
        return None
    if not (isinstance(sig.value, ast.Dict) and isinstance(src.value, ast.Dict)):
        return None
    sources = {
        k.value: v.value
        for k, v in zip(src.value.keys, src.value.values)
        if isinstance(k, ast.Constant)
        and isinstance(v, ast.Constant)
        and isinstance(k.value, str)
        and isinstance(v.value, str)
    }
    env = _collect_aliases(mod.tree)
    lists = {
        node.targets[0].id: node.value
        for node in mod.tree.body
        if isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and isinstance(node.value, ast.List)
    }
    restype, restype_line = _loop_restype(mod.tree, env)
    table = SignatureTable(module=mod, sources=sources, anchor_line=sig.lineno)
    for k, v in zip(sig.value.keys, sig.value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        line = k.lineno
        lib = None
        argtypes = None
        if (
            isinstance(v, ast.Tuple)
            and len(v.elts) == 2
            and isinstance(v.elts[0], ast.Constant)
        ):
            lib = v.elts[0].value
            argtypes = _expand_argtypes(v.elts[1], env, lists)
        table.libraries[k.value] = lib
        table.decls[k.value] = CTypesDecl(
            symbol=k.value,
            argtypes=argtypes if argtypes is not None else ["?"],
            restype=restype,
            argtypes_line=line,
            restype_line=restype_line,
        )
    return table


def find_cuda_dir(module_path: str) -> Optional[str]:
    """The ``csrc/`` directory holding a table-form module's sources:
    beside the module or beside up to three ancestors."""
    return _ancestor_dir(module_path, "csrc", CUDA_GLOBS + C_GLOBS)


# -- the rule ----------------------------------------------------------------


def _compatible(c: CType, ctname: str) -> bool:
    kind, width, _signed = _CTYPES.get(ctname, ("?", -1, False))
    if c.is_pointer:
        return kind == "pointer"
    if kind == "pointer":
        return False
    # scalar: same kind and width; signedness is a marshaling no-op
    return kind == c.kind and width == c.width


def _rel(path: str) -> str:
    try:
        return os.path.relpath(path)
    except ValueError:  # pragma: no cover - cross-drive on windows
        return path


class NativeAbiContractRule(ProjectRule):
    """Cross-language ABI drift at the ctypes boundary."""

    id = "native-abi-contract"
    description = (
        "extern-C signature vs ctypes argtypes/restype/dtype drift"
    )

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        findings: List[Finding] = []
        for mod in index.modules.values():
            table = parse_signature_table(mod)
            if table is not None:
                findings.extend(self._check_table(table))
            binding = parse_binding_module(mod)
            if binding is None:
                continue
            srcs = find_native_sources(mod.path)
            if not srcs:
                continue  # no sources to check against (binary-only)
            cmodel = parse_sources(srcs)
            findings.extend(self._check(binding, cmodel))
        return findings

    def _check_table(self, table: SignatureTable) -> List[Finding]:
        """Each library's SIGNATURES entries against its own source."""
        out: List[Finding] = []
        path = table.module.path
        csrc = find_cuda_dir(path)
        for sym, lib in sorted(table.libraries.items(), key=lambda kv: kv[0]):
            if lib not in table.sources:
                out.append(
                    Finding(
                        self.id,
                        path,
                        table.decls[sym].argtypes_line,
                        0,
                        f"SIGNATURES binds {sym} to library {lib!r}, "
                        "which SOURCES does not name: the symbol is "
                        "looked up in no library",
                    )
                )
        for lib, fname in sorted(table.sources.items()):
            src = os.path.join(csrc, fname) if csrc else None
            if src is None or not os.path.exists(src):
                out.append(
                    Finding(
                        self.id,
                        path,
                        table.anchor_line,
                        0,
                        f"SOURCES names {fname} for library {lib!r} but "
                        "no such file exists under csrc/",
                    )
                )
                continue
            sub = BindingModel(
                module=table.module,
                decls={
                    s: d
                    for s, d in table.decls.items()
                    if table.libraries.get(s) == lib
                },
                anchor_line=table.anchor_line,
            )
            out.extend(self._check(sub, parse_source(src)))
        return out

    def _check(
        self, binding: BindingModel, cmodel: CModel
    ) -> List[Finding]:
        out: List[Finding] = []
        path = binding.module.path

        def report(line: int, message: str) -> None:
            out.append(
                Finding(
                    rule_id=self.id,
                    path=path,
                    line=line,
                    col=0,
                    message=message,
                )
            )

        declared = {
            s for s, d in binding.decls.items() if d.argtypes is not None
        }
        exported = set(cmodel.functions)

        for sym in sorted(exported - declared):
            fn = cmodel.functions[sym]
            report(
                binding.anchor_line,
                f"extern \"C\" symbol {sym} "
                f"({_rel(fn.path)}:{fn.line}) has no ctypes argtypes "
                "declaration: an undeclared call marshals every "
                "argument as a 32-bit default",
            )
        for sym in sorted(declared - exported):
            d = binding.decls[sym]
            report(
                d.argtypes_line,
                f"ctypes declares {sym} but no extern \"C\" function "
                "of that name exists in "
                f"{', '.join(_rel(p) for p in cmodel.paths)}: removed "
                "or renamed export (load would fail or bind a stale "
                "symbol)",
            )

        for sym in sorted(declared & exported):
            d = binding.decls[sym]
            fn = cmodel.functions[sym]
            assert d.argtypes is not None
            if len(d.argtypes) != len(fn.params):
                report(
                    d.argtypes_line,
                    f"{sym}: argtypes declares {len(d.argtypes)} "
                    f"parameter(s) but the C signature "
                    f"({_rel(fn.path)}:{fn.line}) takes "
                    f"{len(fn.params)} — every argument after the "
                    "mismatch lands in the wrong register",
                )
            else:
                for i, (ctname, param) in enumerate(
                    zip(d.argtypes, fn.params)
                ):
                    if param.ctype.kind == "unknown":
                        continue  # lexer punt: never guess
                    if not _compatible(param.ctype, ctname):
                        pname = param.name or f"#{i}"
                        report(
                            d.argtypes_line,
                            f"{sym}: argtypes[{i}] is {ctname} but C "
                            f"parameter {pname} "
                            f"({_rel(fn.path)}:{fn.line}) is "
                            f"{param.ctype.describe()} — width/kind "
                            "drift corrupts the argument registers",
                        )
            self._check_restype(report, d, fn)

        # call-site dtype widths vs pointee widths
        for ca in binding.call_args:
            fn = cmodel.functions.get(ca.symbol)
            if fn is None or ca.index >= len(fn.params):
                continue
            c = fn.params[ca.index].ctype
            if not c.is_pointer or c.kind in ("void", "unknown"):
                continue
            got = _NP_WIDTHS.get(ca.dtype)
            if got is not None and got != c.width:
                pname = fn.params[ca.index].name or f"#{ca.index}"
                report(
                    ca.line,
                    f"{ca.symbol}: argument {ca.index} is a "
                    f"np.{ca.dtype} buffer ({got}-byte elements) but "
                    f"C parameter {pname} "
                    f"({_rel(fn.path)}:{fn.line}) is "
                    f"{c.describe()} — element width mismatch "
                    "reads/writes out of bounds",
                )
        return out

    @staticmethod
    def _check_restype(report, d: CTypesDecl, fn) -> None:
        returns_void = fn.ret.kind == "void" and not fn.ret.is_pointer
        if returns_void:
            if d.restype not in (None, "void"):
                report(
                    d.restype_line,
                    f"{d.symbol}: restype {d.restype} declared but the "
                    f"C function ({_rel(fn.path)}:{fn.line}) returns "
                    "void — the read value is garbage",
                )
            elif d.restype is None:
                report(
                    d.argtypes_line,
                    f"{d.symbol}: C function returns void but restype "
                    "is never set — ctypes defaults to c_int and "
                    "reads a stale register; set restype = None",
                )
            return
        if d.restype in (None, "void"):
            report(
                d.argtypes_line,
                f"{d.symbol}: C function "
                f"({_rel(fn.path)}:{fn.line}) returns "
                f"{fn.ret.describe()} but restype is "
                f"{'never set' if d.restype is None else 'None'} — "
                "ctypes' default c_int truncates 64-bit returns",
            )
            return
        if not _compatible(fn.ret, d.restype):
            report(
                d.restype_line,
                f"{d.symbol}: restype {d.restype} but the C function "
                f"({_rel(fn.path)}:{fn.line}) returns "
                f"{fn.ret.describe()} — width/kind drift",
            )


def make_native_abi_rules() -> List[ProjectRule]:
    return [NativeAbiContractRule()]
