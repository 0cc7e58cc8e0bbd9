"""Clang-free C/C++/CUDA signature extraction for the native boundary.

The port crosses into C at two places, both through ctypes: the host
slot table (csrc/slot_table.cpp and native/decide.cpp, bound in
backends/native_slot_table.py) and the CUDA kernels' launchers
(csrc/*.cu, bound through the ``SIGNATURES`` table of kernels.py).  A
width or arity mismatch there is a silent segfault or a silent
corruption on the card, not an exception.  This module is the C side
of the `native-abi-contract` rule: a small tokenizer (regex lexer +
brace matching, no clang, no nvcc) that extracts, from each
translation unit:

- every function declared or defined inside an ``extern "C"`` block
  (or via a one-shot ``extern "C" <decl>``): name, return type, and
  the parameter list with element widths;
- integer layout constants (``constexpr <int type> kName = <int>;``,
  ``long long`` included), so tests can pin values like the u32
  saturation ceiling or the by-value launch's lane cap.

The type model is deliberately tiny — the ABI at this boundary is
fixed-width scalars and raw pointers; anything the lexer cannot
classify parses as kind="unknown" and the rule skips it rather than
guessing (under-approximate, like the call graph: a missed check costs
recall, a fabricated one costs a false positive).

Port of ratelimit_tpu/analysis/cparse.py, extended for the CUDA
sources: the ``*.cu`` / ``*.cuh`` globs, multi-word scalars
(``long long``, ``unsigned long long``, ...) that every kernel launcher
takes for its slot count, and the one-shot ``extern "C" int f(...)``
definitions the ``.cu`` files use.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# -- type model --------------------------------------------------------------

#: base C type name -> (kind, width_bytes, signed)
_SCALARS: Dict[str, Tuple[str, int, bool]] = {
    "void": ("void", 0, False),
    "bool": ("int", 1, False),
    "char": ("int", 1, True),
    "int8_t": ("int", 1, True),
    "uint8_t": ("int", 1, False),
    "int16_t": ("int", 2, True),
    "uint16_t": ("int", 2, False),
    "short": ("int", 2, True),
    "int": ("int", 4, True),
    "unsigned": ("int", 4, False),
    "int32_t": ("int", 4, True),
    "uint32_t": ("int", 4, False),
    "int64_t": ("int", 8, True),
    "uint64_t": ("int", 8, False),
    "size_t": ("int", 8, False),
    "float": ("float", 4, True),
    "double": ("float", 8, True),
    # multi-word scalars (LP64: long is 8 bytes, as on the card's host)
    "unsigned int": ("int", 4, False),
    "signed char": ("int", 1, True),
    "unsigned char": ("int", 1, False),
    "unsigned short": ("int", 2, False),
    "long": ("int", 8, True),
    "unsigned long": ("int", 8, False),
    "long long": ("int", 8, True),
    "unsigned long long": ("int", 8, False),
    "long long int": ("int", 8, True),
    "unsigned long long int": ("int", 8, False),
}

#: Every word that may appear in a scalar type name: a trailing
#: identifier outside this set is the parameter's name.
_TYPE_WORDS = {w for k in _SCALARS for w in k.split()}

#: File patterns of C/C++ translation units and of CUDA sources.
C_GLOBS = ("*.cpp", "*.cc", "*.c")
CUDA_GLOBS = ("*.cu", "*.cuh")


@dataclass(frozen=True)
class CType:
    """One parameter or return type: a scalar or a pointer to one."""

    kind: str  # "void" | "int" | "float" | "pointer" | "unknown"
    width: int = 0  # scalar byte width; for pointers, the POINTEE width
    signed: bool = False
    is_pointer: bool = False

    def describe(self) -> str:
        if self.kind == "void" and not self.is_pointer:
            return "void"
        if self.is_pointer:
            if self.kind == "void":
                return "void*"
            sign = "" if self.signed else "u"
            base = (
                f"{sign}int{self.width * 8}_t"
                if self.kind == "int"
                else ("float" if self.width == 4 else "double")
            )
            return f"{base}*"
        if self.kind == "float":
            return "float" if self.width == 4 else "double"
        if self.kind == "int":
            sign = "" if self.signed else "u"
            return f"{sign}int{self.width * 8}_t"
        return "?"


@dataclass(frozen=True)
class CParam:
    name: str  # "" when unnamed
    ctype: CType


@dataclass
class CFunction:
    name: str
    ret: CType
    params: List[CParam]
    path: str
    line: int


@dataclass
class CModel:
    """Everything extracted from one set of C/C++ sources."""

    functions: Dict[str, CFunction] = field(default_factory=dict)
    constants: Dict[str, int] = field(default_factory=dict)
    paths: List[str] = field(default_factory=list)


# -- lexing helpers ----------------------------------------------------------

_LINE_COMMENT = re.compile(r"//[^\n]*")
_BLOCK_COMMENT = re.compile(r"/\*.*?\*/", re.S)
_STRING = re.compile(r'"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'')


def _blank_keep_newlines(m: re.Match) -> str:
    s = m.group(0)
    if s == '"C"':  # keep linkage markers findable after stripping
        return s
    return re.sub(r"[^\n]", " ", s)


def strip_comments(text: str) -> str:
    """Blank out comments and string/char literals, preserving every
    newline so downstream offsets map to real line numbers."""
    text = _BLOCK_COMMENT.sub(_blank_keep_newlines, text)
    text = _LINE_COMMENT.sub(_blank_keep_newlines, text)
    text = _STRING.sub(_blank_keep_newlines, text)
    return text


def _match_brace(text: str, open_idx: int) -> int:
    """Index just past the brace matching text[open_idx] == '{'."""
    depth = 0
    for i in range(open_idx, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


_EXTERN_C = re.compile(r'extern\s+"C"\s*(\{)?')


def extern_c_regions(text: str) -> List[Tuple[int, int]]:
    """(start, end) character spans of code with C linkage: the inside
    of each ``extern "C" { ... }`` block, or the single declaration
    following ``extern "C"`` with no brace."""
    regions: List[Tuple[int, int]] = []
    for m in _EXTERN_C.finditer(text):
        if m.group(1):  # block form
            open_idx = m.end() - 1
            regions.append((m.end(), _match_brace(text, open_idx) - 1))
        else:  # one-shot: up to the end of the declaration/definition
            semi = text.find(";", m.end())
            brace = text.find("{", m.end())
            if brace != -1 and (semi == -1 or brace < semi):
                regions.append((m.end(), _match_brace(text, brace)))
            elif semi != -1:
                regions.append((m.end(), semi + 1))
    return regions


_TYPE_QUALIFIERS = {
    "const", "volatile", "restrict", "struct", "enum", "static", "inline",
}
# identifier-or-star token stream for one parameter / return type
_TOKEN = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\*")


def parse_type_tokens(tokens: List[str]) -> Tuple[CType, str]:
    """(type, param_name) from a token list like
    ``['const', 'uint8_t', '*', 'key_blob']``.  The name is the final
    identifier when it is not part of the type; '' when unnamed."""
    tokens = [t for t in tokens if t not in _TYPE_QUALIFIERS]
    if not tokens:
        return CType("unknown"), ""
    stars = tokens.count("*")
    idents = [t for t in tokens if t != "*"]
    name = ""
    # A trailing identifier that is no type word is the parameter name;
    # the words before it name the scalar ("unsigned long long").
    if len(idents) >= 2 and idents[-1] not in _TYPE_WORDS:
        name = idents[-1]
        idents = idents[:-1]
    base = " ".join(idents)
    if base not in _SCALARS:
        return CType("unknown", is_pointer=stars > 0), name
    kind, width, signed = _SCALARS[base]
    if stars:
        return CType(kind, width, signed, is_pointer=True), name
    return CType(kind, width, signed), name


def _split_params(raw: str) -> List[str]:
    """Split a parameter list on top-level commas."""
    parts, depth, cur = [], 0, []
    for c in raw:
        if c in "(<[":
            depth += 1
        elif c in ")>]":
            depth -= 1
        if c == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


# A function signature at linkage scope: type tokens (one or more words,
# "unsigned long long"), name, '(' ... ')' then '{' (definition) or ';'
# (declaration).
_FUNC = re.compile(
    r"(?P<ret>(?:const\s+)?(?:[A-Za-z_][A-Za-z0-9_]*\s+)*"
    r"[A-Za-z_][A-Za-z0-9_]*(?:\s|\*)+)"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*\(",
)

_CONSTEXPR = re.compile(
    r"constexpr\s+(?:[A-Za-z_][A-Za-z0-9_]*\s+)*"
    r"(?P<name>k[A-Za-z0-9_]+)\s*=\s*(?P<val>0[xX][0-9a-fA-F]+|\d+)"
    r"(?:u|U|l|L)*\s*;"
)


def parse_source(path: str, text: Optional[str] = None) -> CModel:
    """Parse one C/C++ source file into a CModel."""
    if text is None:
        with open(path, encoding="utf-8", errors="replace") as f:
            text = f.read()
    model = CModel(paths=[path])
    clean = strip_comments(text)

    for m in _CONSTEXPR.finditer(clean):
        model.constants[m.group("name")] = int(m.group("val"), 0)

    for start, end in extern_c_regions(clean):
        region = clean[start:end]
        depth = 0
        pos = 0
        while pos < len(region):
            c = region[pos]
            if c == "{":
                depth += 1
                pos += 1
                continue
            if c == "}":
                depth -= 1
                pos += 1
                continue
            if depth != 0:
                pos += 1
                continue
            m = _FUNC.match(region, pos)
            if m is None:
                pos += 1
                continue
            # find the matching ')' of the parameter list
            pdepth = 1
            i = m.end()
            while i < len(region) and pdepth:
                if region[i] == "(":
                    pdepth += 1
                elif region[i] == ")":
                    pdepth -= 1
                i += 1
            raw_params = region[m.end() : i - 1]
            # must be a function (body or prototype), not a call
            tail = region[i:].lstrip()
            if not tail.startswith(("{", ";")):
                pos = m.end()
                continue
            ret_type, _ = parse_type_tokens(_TOKEN.findall(m.group("ret")))
            params = []
            for praw in _split_params(raw_params):
                ptype, pname = parse_type_tokens(_TOKEN.findall(praw))
                params.append(CParam(pname, ptype))
            if len(params) == 1 and params[0].ctype.kind == "void" and (
                not params[0].ctype.is_pointer
            ):
                params = []  # f(void)
            line = clean.count("\n", 0, start + m.start(0)) + 1
            fn = CFunction(m.group("name"), ret_type, params, path, line)
            model.functions.setdefault(fn.name, fn)
            pos = i
    return model


def parse_sources(paths: List[str]) -> CModel:
    """Union model over several translation units (first decl wins on
    a duplicate name — the linker would reject a conflicting pair)."""
    out = CModel()
    for p in sorted(paths):
        sub = parse_source(p)
        out.paths.append(p)
        out.constants.update(sub.constants)
        for name, fn in sub.functions.items():
            out.functions.setdefault(name, fn)
    return out
