"""Kernel/layout contract checker (``dtype-pack-contract``).

The serving path round-trips bytes through three independent layout
authorities that nothing at runtime cross-checks:

- structured numpy dtypes (``LANE_DTYPE`` in backends/dispatcher.py,
  ``FLIGHT_DTYPE`` in observability/flight.py, checkpoint state rows);
- ``struct`` pack formats derived from them (the flight recorder
  stamps whole rows via ``struct.Struct("<%dq" % len(FLIGHT_DTYPE.
  names)).pack_into``);
- the kernels' dtype discipline (u32/i32 lanes, f32 math, no f64 on
  the device path — docs/ALGORITHMS.md).

When the lane record widened from 24 to 32 bytes, nothing but convention
kept every pack site in step.  This rule makes the convention a lint
invariant:

1. every struct format string DERIVED from a declared dtype (the
   ``% len(D.names)`` / ``D.itemsize`` idioms) must match that dtype
   field-for-field (struct char per field, total size == itemsize);
2. every declared structured dtype must be naturally aligned with an
   8-byte-multiple itemsize (the native library and device transfer
   paths parse these buffers as C structs);
3. no f64 on the device path: ``np.float64``/``torch.float64``/
   ``np.double``/``torch.double``/``"float64"``/``"<f8"`` inside ops/,
   models/, parallel/ (f32 math is the kernel contract; f64 silently
   doubles transfer width and the CUDA kernels take f32 and u32/i32
   lanes).

Port of ratelimit_tpu/analysis/contracts.py; the port's ``LANE_DTYPE``
(backends/dispatcher.py) and ``FLIGHT_DTYPE`` (observability/flight.py)
are the declarations it folds.
"""

from __future__ import annotations

import ast
import struct as _struct
from typing import Dict, List, Optional, Sequence, Tuple

from .engine import Finding
from .project import ModuleInfo, ProjectIndex, ProjectRule, dotted

# numpy type spec -> (struct char, byte size).  Only fixed-width specs
# the repo's device-visible layouts may legally use.
_NUMPY_TO_STRUCT: Dict[str, Tuple[str, int]] = {
    "<i8": ("q", 8), "i8": ("q", 8), "int64": ("q", 8),
    "np.int64": ("q", 8), "numpy.int64": ("q", 8),
    "<u8": ("Q", 8), "u8": ("Q", 8), "uint64": ("Q", 8),
    "np.uint64": ("Q", 8), "numpy.uint64": ("Q", 8),
    "<i4": ("i", 4), "i4": ("i", 4), "int32": ("i", 4),
    "np.int32": ("i", 4), "numpy.int32": ("i", 4),
    "<u4": ("I", 4), "u4": ("I", 4), "uint32": ("I", 4),
    "np.uint32": ("I", 4), "numpy.uint32": ("I", 4),
    "<i2": ("h", 2), "i2": ("h", 2), "int16": ("h", 2),
    "<u2": ("H", 2), "u2": ("H", 2), "uint16": ("H", 2),
    "|i1": ("b", 1), "i1": ("b", 1), "int8": ("b", 1),
    "|u1": ("B", 1), "u1": ("B", 1), "uint8": ("B", 1),
    "np.uint8": ("B", 1), "numpy.uint8": ("B", 1),
    "<f4": ("f", 4), "f4": ("f", 4), "float32": ("f", 4),
    "np.float32": ("f", 4), "numpy.float32": ("f", 4),
    "<f8": ("d", 8), "f8": ("d", 8), "float64": ("d", 8),
    "np.float64": ("d", 8), "numpy.float64": ("d", 8),
}

_F64_DOTTED = {"np.float64", "numpy.float64", "np.double", "numpy.double",
               "torch.float64", "torch.double"}
_F64_STRINGS = {"float64", "<f8", "f8", "double"}
_DEVICE_PATH_FRAGMENTS = ("/ops/", "/models/", "/parallel/")


class DtypeDecl:
    """One statically-declared structured dtype."""

    __slots__ = ("name", "module", "node", "fields", "itemsize", "offsets")

    def __init__(self, name, module, node, fields):
        self.name: str = name
        self.module: ModuleInfo = module
        self.node = node
        self.fields: List[Tuple[str, str, int]] = fields  # (name, char, size)
        self.itemsize = sum(sz for _, _, sz in fields)
        off = 0
        self.offsets: Dict[str, int] = {}
        for fname, _, sz in fields:
            self.offsets[fname] = off
            off += sz

    @property
    def struct_chars(self) -> str:
        return "".join(ch for _, ch, _ in self.fields)


def _spec_of(node: ast.AST) -> Optional[str]:
    """The numpy type spec of one field's second element."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    d = dotted(node)
    return d


def parse_dtype_decls(mod: ModuleInfo) -> List[DtypeDecl]:
    """``NAME = np.dtype([("f", "<i8"), ...])`` module-level literals.
    Declarations using align=True, shapes, or unknown type specs are
    skipped (we only check what we can model exactly)."""
    out: List[DtypeDecl] = []
    for node in mod.tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and dotted(node.value.func) in ("np.dtype", "numpy.dtype")
            and node.value.args
            and isinstance(node.value.args[0], ast.List)
        ):
            continue
        if any(kw.arg == "align" for kw in node.value.keywords):
            continue
        fields: List[Tuple[str, str, int]] = []
        ok = True
        for elt in node.value.args[0].elts:
            if not (
                isinstance(elt, ast.Tuple) and len(elt.elts) == 2
            ):
                ok = False
                break
            fname_node, spec_node = elt.elts
            if not (
                isinstance(fname_node, ast.Constant)
                and isinstance(fname_node.value, str)
            ):
                ok = False
                break
            spec = _spec_of(spec_node)
            mapped = _NUMPY_TO_STRUCT.get(spec) if spec else None
            if mapped is None:
                ok = False
                break
            fields.append((fname_node.value, mapped[0], mapped[1]))
        if ok and fields:
            out.append(
                DtypeDecl(node.targets[0].id, mod, node, fields)
            )
    return out


def _expand_format(fmt: str) -> Optional[str]:
    """'<10q' -> 'qqqqqqqqqq'; None for formats we cannot model
    (strings, padding with s/x are not layout-equivalent here)."""
    chars = []
    num = ""
    for ch in fmt:
        if ch in "<>=!@":
            continue
        if ch.isdigit():
            num += ch
            continue
        if ch in "qQiIhHbBfd":
            chars.append(ch * (int(num) if num else 1))
            num = ""
        elif ch == " ":
            num = ""
        else:
            return None
    return "".join(chars)


class _FmtRef:
    """A struct format expression linked to a dtype declaration."""

    __slots__ = ("node", "fmt", "dtype_name")

    def __init__(self, node, fmt, dtype_name):
        self.node = node
        self.fmt: Optional[str] = fmt  # folded format string, or None
        self.dtype_name: str = dtype_name


def _len_names_target(node: ast.AST) -> Optional[str]:
    """'D' for a `len(D.names)` expression, else None."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "len"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Attribute)
        and node.args[0].attr == "names"
    ):
        return dotted(node.args[0].value)
    return None


def find_format_refs(mod: ModuleInfo, known: Dict[str, DtypeDecl]):
    """struct format expressions in `mod` that reference a known
    dtype (the `% len(D.names)` idiom).  `known` maps the LOCAL name
    (declared or imported) to the declaration."""
    refs: List[_FmtRef] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func)
        if callee not in (
            "struct.Struct",
            "struct.pack",
            "struct.pack_into",
            "struct.unpack",
            "struct.unpack_from",
        ) or not node.args:
            continue
        fmt_expr = node.args[0]
        if isinstance(fmt_expr, ast.BinOp) and isinstance(
            fmt_expr.op, ast.Mod
        ):
            if not (
                isinstance(fmt_expr.left, ast.Constant)
                and isinstance(fmt_expr.left.value, str)
            ):
                continue
            right = fmt_expr.right
            operands = (
                list(right.elts) if isinstance(right, ast.Tuple) else [right]
            )
            targets = [_len_names_target(o) for o in operands]
            if any(t is None for t in targets):
                continue
            decls = [known.get(t) for t in targets]
            if any(d is None for d in decls):
                continue
            try:
                folded = fmt_expr.left.value % tuple(
                    len(d.fields) for d in decls
                )
            except (TypeError, ValueError):
                folded = None
            # Keyed by the local name, as `known` is (an import may
            # alias the declaration).
            refs.append(_FmtRef(node, folded, targets[0]))
    return refs


class DtypePackContractRule(ProjectRule):
    """See the module docstring."""

    id = "dtype-pack-contract"
    description = (
        "struct pack format / structured dtype / kernel dtype drift"
    )

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        findings: List[Finding] = []
        decls_by_module: Dict[str, Dict[str, DtypeDecl]] = {}
        all_decls: Dict[str, DtypeDecl] = {}
        for mod in index.modules.values():
            for decl in parse_dtype_decls(mod):
                decls_by_module.setdefault(mod.name, {})[decl.name] = decl
                all_decls[f"{mod.name}:{decl.name}"] = decl
                findings.extend(self._check_layout(decl))

        for mod in index.modules.values():
            known = dict(decls_by_module.get(mod.name, {}))
            # imported dtype names resolve to their declaring module
            for alias, imp in mod.imports.items():
                if imp[0] != "symbol":
                    continue
                target = index.find_module(imp[1])
                if target is None:
                    continue
                decl = decls_by_module.get(target.name, {}).get(imp[2])
                if decl is not None:
                    known[alias] = decl
            if known:
                for ref in find_format_refs(mod, known):
                    findings.extend(
                        self._check_format(mod, ref, known)
                    )
            if any(
                f in mod.path.replace("\\", "/")
                for f in _DEVICE_PATH_FRAGMENTS
            ):
                findings.extend(self._check_device_f64(mod))
        return findings

    # -- checks -----------------------------------------------------------

    def _check_layout(self, decl: DtypeDecl) -> List[Finding]:
        out: List[Finding] = []
        for fname, _ch, size in decl.fields:
            off = decl.offsets[fname]
            if off % size != 0:
                out.append(
                    self._finding(
                        decl.module,
                        decl.node,
                        f"{decl.name}.{fname} sits at offset {off}, "
                        f"not aligned to its {size}-byte width — the "
                        "native/device consumers parse this layout as "
                        "a C struct (reorder fields or pad explicitly)",
                    )
                )
        if decl.itemsize % 8 != 0:
            out.append(
                self._finding(
                    decl.module,
                    decl.node,
                    f"{decl.name} itemsize {decl.itemsize} is not a "
                    "multiple of 8: rows tear across 64-bit word "
                    "boundaries in concatenated buffers",
                )
            )
        return out

    def _check_format(
        self, mod: ModuleInfo, ref: _FmtRef, known: Dict[str, DtypeDecl]
    ) -> List[Finding]:
        decl = known[ref.dtype_name]
        if ref.fmt is None:
            return [
                self._finding(
                    mod,
                    ref.node,
                    f"could not fold the struct format derived from "
                    f"{decl.name} — keep the format a simple "
                    "'%d'-count interpolation so the contract checker "
                    "can verify it",
                )
            ]
        expanded = _expand_format(ref.fmt)
        expected = decl.struct_chars
        if expanded is None:
            return [
                self._finding(
                    mod,
                    ref.node,
                    f"struct format {ref.fmt!r} derived from "
                    f"{decl.name} uses characters outside the "
                    "fixed-width int/float set; cannot verify against "
                    "the dtype layout",
                )
            ]
        if expanded != expected:
            return [
                self._finding(
                    mod,
                    ref.node,
                    f"struct format {ref.fmt!r} (fields "
                    f"'{expanded}') does not match {decl.name} "
                    f"(fields '{expected}', itemsize "
                    f"{decl.itemsize}): packed rows would tear — "
                    "update the format or the dtype together",
                )
            ]
        # belt-and-braces: folded calcsize vs itemsize
        if _struct.calcsize("<" + expanded) != decl.itemsize:
            return [
                self._finding(  # pragma: no cover - defense in depth
                    mod,
                    ref.node,
                    f"struct format {ref.fmt!r} size "
                    f"{_struct.calcsize('<' + expanded)} != "
                    f"{decl.name} itemsize {decl.itemsize}",
                )
            ]
        return []

    def _check_device_f64(self, mod: ModuleInfo) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                d = dotted(node)
                if d in _F64_DOTTED:
                    out.append(
                        self._finding(
                            mod,
                            node,
                            f"{d} on the device path: kernels are "
                            "u32/i32 lanes with f32 math (the CUDA "
                            "kernels' arguments); f64 doubles "
                            "transfer width and breaks the contract",
                        )
                    )
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if (
                    isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                    and v.value in _F64_STRINGS
                ):
                    out.append(
                        self._finding(
                            mod,
                            v,
                            f"dtype={v.value!r} on the device path: "
                            "no f64 in kernel code (f32 contract)",
                        )
                    )
        return out

    def _finding(self, mod: ModuleInfo, node: ast.AST, msg: str) -> Finding:
        return Finding(
            rule_id=self.id,
            path=mod.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=msg,
        )


def make_contract_rules() -> List[ProjectRule]:
    return [DtypePackContractRule()]
