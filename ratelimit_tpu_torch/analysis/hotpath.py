"""`hot-path-cost`: per-request interpreter hazards on the serving
path, ratcheted by the committed baseline.

ROADMAP item 1 moves the host front half into C; this rule is the
guard that the *Python* half of the request path can only get
cheaper.  Using the under-approximate call graph's reachability from
the request-path roots (`should_rate_limit` / `do_limit` /
`do_limit_resolved` and the dispatcher collector/completer bodies),
it flags the classic interpreter costs that profiles keep finding in
per-descriptor code:

- **closure per request** — a ``lambda`` or nested ``def`` evaluated
  inside a hot function allocates a code/closure pair every call;
- **string formatting per iteration** — an f-string, ``%``-format, or
  ``str.format`` inside a per-descriptor loop builds garbage every
  lane;
- **throwaway container per iteration** — a comprehension or
  list/dict/set display inside a hot loop allocates per lane what one
  vectorized pass (or a reused buffer) does per batch;
- **repeated attribute loads** — the same ``a.b.c`` chain loaded 3+
  times inside one hot loop; each load is a dict probe the loop pays
  per lane (hoist to a local).

The point is the *ratchet*, not zero findings: the current host path
is baselined in analysis/baseline.json, `--fail-on-new` fails only on
growth, and every fix shrinks the committed list.  A hazard that is
deliberate (cold error path, once-per-batch loop the graph cannot
distinguish) carries a justified
``# tpu-lint: disable=hot-path-cost -- why``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .concurrency import REQUEST_PATH_ROOTS
from .engine import Finding
from .project import FunctionInfo, ProjectIndex, ProjectRule

#: The request path proper (REQUEST_PATH_ROOTS) plus the dispatcher
#: collector/completer loop bodies — they run once per device batch
#: with RPCs parked on the result, so their per-item work is
#: request-path work too.
HOT_PATH_ROOTS = frozenset(REQUEST_PATH_ROOTS) | {
    "_collect_loop",
    "_complete_loop",
}


def _loop_ancestor(parents: List[ast.AST]) -> Optional[ast.AST]:
    """Innermost For/While strictly inside the function body."""
    for p in reversed(parents):
        if isinstance(p, (ast.For, ast.AsyncFor, ast.While)):
            return p
    return None


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name for a pure Name/Attribute load chain (``self.x.y``),
    else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name) or not parts:
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_format_call(node: ast.Call) -> bool:
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "format"
        and isinstance(node.func.value, ast.Constant)
        and isinstance(node.func.value.value, str)
    )


def _is_str_mod(node: ast.BinOp) -> bool:
    if not isinstance(node.op, ast.Mod):
        return False
    left = node.left
    if isinstance(left, ast.Constant) and isinstance(left.value, str):
        return True
    return isinstance(left, ast.JoinedStr)


class _FnScan:
    """One walk over a hot function's own body (nested functions are
    flagged at their definition and not descended into — they have
    their own FunctionInfo if the graph can reach them)."""

    def __init__(self, fn: FunctionInfo):
        self.fn = fn
        self.hazards: List[Tuple[ast.AST, str]] = []
        # (loop node id, chain) -> [count, first line]
        self._loads: Dict[Tuple[int, str], List[int]] = {}
        self._loop_lines: Dict[int, int] = {}

    def run(self) -> List[Tuple[ast.AST, str]]:
        body = self.fn.node.body
        for stmt in body:
            self._walk(stmt, [])
        for (loop_id, chain), (count, first) in sorted(
            self._loads.items(), key=lambda kv: (kv[1][1], kv[0][1])
        ):
            if count >= 3:
                anchor = ast.Constant(value=None)
                anchor.lineno = first
                anchor.col_offset = 0
                self.hazards.append(
                    (
                        anchor,
                        f"attribute chain `{chain}` is loaded {count}x "
                        "inside one hot loop (line "
                        f"{self._loop_lines[loop_id]}): each load is a "
                        "dict probe per lane — hoist it to a local "
                        "before the loop",
                    )
                )
        return self.hazards

    def _walk(self, node: ast.AST, parents: List[ast.AST]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.hazards.append(
                (
                    node,
                    f"nested function `{node.name}` is defined per "
                    "call: the closure/code pair is allocated every "
                    "request — hoist it to module/class scope",
                )
            )
            return  # its body is someone else's FunctionInfo
        if isinstance(node, ast.Lambda):
            self.hazards.append(
                (
                    node,
                    "lambda constructed per call on the request path "
                    "— hoist it (or use a bound method / operator.*)",
                )
            )
            return
        loop = _loop_ancestor(parents)
        if loop is not None:
            self._in_loop(node, loop)
            if isinstance(node, ast.Attribute) and _attr_chain(node):
                return  # counted as one chain; don't count sub-chains
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # the iterable evaluates ONCE, before the first iteration:
            # scan it without this loop in scope
            self._walk(node.iter, parents)
            parents.append(node)
            for part in node.body + node.orelse:
                self._walk(part, parents)
            parents.pop()
            return
        parents.append(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child, parents)
        parents.pop()

    def _in_loop(self, node: ast.AST, loop: ast.AST) -> None:
        if isinstance(node, ast.JoinedStr):
            self.hazards.append(
                (
                    node,
                    "f-string built per iteration of a hot loop — "
                    "format once per batch or only on the error path",
                )
            )
        elif isinstance(node, ast.BinOp) and _is_str_mod(node):
            self.hazards.append(
                (
                    node,
                    "%-format per iteration of a hot loop — format "
                    "once per batch or only on the error path",
                )
            )
        elif isinstance(node, ast.Call) and _is_format_call(node):
            self.hazards.append(
                (
                    node,
                    "str.format per iteration of a hot loop — format "
                    "once per batch or only on the error path",
                )
            )
        elif isinstance(
            node, (ast.ListComp, ast.SetComp, ast.DictComp)
        ):
            kind = type(node).__name__.replace("Comp", "").lower()
            self.hazards.append(
                (
                    node,
                    f"{kind} comprehension allocated per iteration of "
                    "a hot loop — build once per batch or reuse a "
                    "buffer",
                )
            )
        elif isinstance(node, ast.Attribute) and isinstance(
            node.ctx, ast.Load
        ):
            chain = _attr_chain(node)
            # only count full chains (not sub-chains of one another):
            # the walk visits outermost Attribute first; sub-attributes
            # are skipped by recording against the outermost spelling.
            if chain and chain.count(".") >= 1:
                key = (id(loop), chain)
                slot = self._loads.get(key)
                if slot is None:
                    self._loads[key] = [1, node.lineno]
                    self._loop_lines[id(loop)] = loop.lineno
                else:
                    slot[0] += 1


class HotPathCostRule(ProjectRule):
    """Interpreter-cost hazards reachable from the request path."""

    id = "hot-path-cost"
    description = (
        "per-request interpreter hazard (closure/format/alloc/attr "
        "loads) reachable from the request path"
    )

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        roots = [
            fn
            for fn in index.functions.values()
            if fn.name in HOT_PATH_ROOTS
        ]
        reach: Dict[FunctionInfo, str] = {}
        for root in sorted(roots, key=lambda f: f.qualname):
            for fn in index.reachable(root, escapes=False):
                reach.setdefault(fn, root.qualname)
        findings: List[Finding] = []
        for fn in sorted(reach, key=lambda f: (f.module.path, f.qualname)):
            via = reach[fn]
            for node, hazard in _FnScan(fn).run():
                findings.append(
                    Finding(
                        rule_id=self.id,
                        path=fn.module.path,
                        line=getattr(node, "lineno", 1),
                        col=getattr(node, "col_offset", 0),
                        message=(
                            f"{hazard} [in {fn.qualname}, reachable "
                            f"from {via}]"
                        ),
                    )
                )
        return findings


def make_hotpath_rules() -> List[ProjectRule]:
    return [HotPathCostRule()]
