"""AST-walking lint framework (the `go vet` analog for this repo).

One engine walk per file: the engine parses the source, extracts
``# tpu-lint: disable=...`` suppressions from the token stream, then
performs a single parent-tracking AST walk, dispatching every node to
each rule that declared interest in its type.  Rules accumulate
findings; the engine filters suppressed ones and hands the rest to a
text or JSON reporter.

Rule protocol (subclass :class:`Rule`):

- ``id`` / ``description``: stable rule identity (suppression key).
- ``interests``: tuple of ``ast.AST`` subclasses the rule wants
  dispatched (empty tuple = every node).
- ``begin_file(ctx)``: per-file setup (pre-passes over ``ctx.tree``).
- ``visit(node, parents, ctx)``: called once per interesting node;
  ``parents`` is the ancestor chain, outermost first.
- ``end_file(ctx)``: whole-file checks after the walk.
- ``report(...)``: record a finding (collected by the engine).

Suppressions:

- ``# tpu-lint: disable=rule-a,rule-b`` on the FINDING'S line (or the
  line a multi-line statement starts on) suppresses those rules there.
- ``# tpu-lint: disable-file=rule-a`` anywhere suppresses the rule for
  the whole file.
- ``all`` is accepted in either form.

Every suppression should carry a justification in the same comment,
e.g. ``# tpu-lint: disable=lock-discipline -- collector-owned``.
"""

from __future__ import annotations

import ast
import io
import json
import re
import sys
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Type

_SUPPRESS_RE = re.compile(
    r"#\s*tpu-lint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule_id: str
    path: str
    line: int
    col: int
    message: str

    def text(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id}: {self.message}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclass
class FileContext:
    """Everything a rule may want about the file under analysis."""

    path: str
    source: str
    tree: ast.Module
    # line number -> set of rule ids suppressed on that line
    line_suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    # rule ids suppressed for the whole file
    file_suppressions: Set[str] = field(default_factory=set)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if {"all", rule_id} & self.file_suppressions:
            return True
        on_line = self.line_suppressions.get(line, ())
        return "all" in on_line or rule_id in on_line


class Rule:
    """Base class for one lint check; see the module docstring for the
    dispatch protocol."""

    id: str = ""
    description: str = ""
    # AST node types this rule wants dispatched; () = all nodes.
    interests: Tuple[Type[ast.AST], ...] = ()

    def __init__(self) -> None:
        self._findings: List[Finding] = []

    # -- per-file lifecycle (engine-driven) ------------------------------

    def begin_file(self, ctx: FileContext) -> None:  # pragma: no cover
        pass

    def visit(
        self, node: ast.AST, parents: Sequence[ast.AST], ctx: FileContext
    ) -> None:  # pragma: no cover
        pass

    def end_file(self, ctx: FileContext) -> None:  # pragma: no cover
        pass

    # -- finding sink ----------------------------------------------------

    def report(
        self, ctx: FileContext, node: ast.AST, message: str
    ) -> None:
        self._findings.append(
            Finding(
                rule_id=self.id,
                path=ctx.path,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0),
                message=message,
            )
        )

    def take_findings(self) -> List[Finding]:
        out, self._findings = self._findings, []
        return out


def _extract_suppressions(
    source: str,
) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Parse tpu-lint suppression comments from the token stream (not
    a line regex: a '# tpu-lint:' inside a string literal must not
    suppress anything)."""
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            kind, raw = m.group(1), m.group(2)
            # The rule list ends at a '--' justification separator;
            # within each comma-separated piece only the first word is
            # the rule id (anything after is commentary).
            raw = raw.split("--", 1)[0]
            rules = {
                piece.split()[0]
                for piece in raw.split(",")
                if piece.split()
            }
            if kind == "disable-file":
                whole_file |= rules
            else:
                per_line.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass  # syntax trouble surfaces via ast.parse instead
    return per_line, whole_file


class AnalysisEngine:
    """Run a rule pack over files; collect unsuppressed findings."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)
        ids = [r.id for r in self.rules]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate rule ids: {ids}")

    def check_source(self, path: str, source: str) -> List[Finding]:
        ctx = build_context(path, source)
        if isinstance(ctx, Finding):
            return [ctx]
        return self.check_ctx(ctx)

    def check_ctx(self, ctx: FileContext) -> List[Finding]:
        """Run the file rules over a pre-parsed context (the whole-
        program pass parses each file exactly once and shares the
        tree with the ProjectIndex)."""
        for rule in self.rules:
            rule.begin_file(ctx)

        # Single parent-tracking walk, dispatching to interested rules.
        by_interest: List[Tuple[Rule, Tuple[Type[ast.AST], ...]]] = [
            (r, r.interests) for r in self.rules
        ]
        parents: List[ast.AST] = []

        def walk(node: ast.AST) -> None:
            for rule, interests in by_interest:
                if not interests or isinstance(node, interests):
                    rule.visit(node, parents, ctx)
            parents.append(node)
            for child in ast.iter_child_nodes(node):
                walk(child)
            parents.pop()

        walk(ctx.tree)

        findings: List[Finding] = []
        for rule in self.rules:
            rule.end_file(ctx)
            findings.extend(rule.take_findings())

        kept = [
            f for f in findings if not ctx.is_suppressed(f.rule_id, f.line)
        ]
        kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
        return kept

    def check_file(self, path: str) -> List[Finding]:
        source = Path(path).read_text(encoding="utf-8")
        return self.check_source(str(path), source)


def build_context(path: str, source: str):
    """Parse one file into a FileContext, or a parse-error Finding."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return Finding(
            rule_id="parse-error",
            path=path,
            line=e.lineno or 1,
            col=e.offset or 0,
            message=f"could not parse: {e.msg}",
        )
    per_line, whole_file = _extract_suppressions(source)
    return FileContext(
        path=path,
        source=source,
        tree=tree,
        line_suppressions=per_line,
        file_suppressions=whole_file,
    )


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted .py file list; generated
    protobuf modules (`*_pb2.py`) are mechanical output and skipped."""
    out: List[str] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(
                str(f)
                for f in sorted(path.rglob("*.py"))
                if not f.name.endswith("_pb2.py")
            )
        elif path.suffix == ".py":
            out.append(str(path))
    return out


def analyze_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    project_rules: Optional[Sequence] = None,
) -> Tuple[List[Finding], int]:
    """The v2 whole-program pass: parse every file ONCE, run the file
    rules per context, build the ProjectIndex and run the project
    rules over it, then apply suppressions uniformly.  Returns
    (findings, files_checked); raises ValueError for empty path sets
    (the CLI maps it to exit 2)."""
    from .project import ProjectIndex, ProjectRule  # local: keep engine light
    from .rules import DEFAULT_RULES, DEFAULT_PROJECT_RULES

    files = iter_python_files(paths)
    if not files:
        raise ValueError(f"no python files under {list(paths)}")
    engine = AnalysisEngine(rules if rules is not None else DEFAULT_RULES)
    if project_rules is None:
        project_rules = DEFAULT_PROJECT_RULES
    pids = [r.id for r in project_rules]
    if len(set(pids)) != len(pids):
        raise ValueError(f"duplicate project rule ids: {pids}")

    findings: List[Finding] = []
    ctxs = []
    for f in files:
        source = Path(f).read_text(encoding="utf-8")
        ctx = build_context(str(f), source)
        if isinstance(ctx, Finding):
            findings.append(ctx)
            continue
        ctxs.append(ctx)
        findings.extend(engine.check_ctx(ctx))

    if project_rules and ctxs:
        index = ProjectIndex(ctxs)
        ctx_by_path = index.ctx_by_path
        for rule in project_rules:
            assert isinstance(rule, ProjectRule)
            for f in rule.check_project(index):
                ctx = ctx_by_path.get(f.path)
                if ctx is not None and ctx.is_suppressed(
                    f.rule_id, f.line
                ):
                    continue
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return findings, len(files)


def run_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    fmt: str = "text",
    out=None,
    project_rules: Optional[Sequence] = None,
    baseline: Optional[dict] = None,
    fail_on_new: bool = False,
) -> int:
    """Lint `paths`; print findings in `fmt`; return the exit code
    (0 = clean, 1 = findings, 2 = usage error).

    With ``fail_on_new`` a committed ``baseline`` (analysis/
    baseline.py) filters KNOWN findings: the exit code and the report
    reflect only findings absent from the baseline, so CI gates on
    regressions while a pre-existing backlog burns down
    (docs/STATIC_ANALYSIS.md)."""
    out = out or sys.stdout
    try:
        findings, n_files = analyze_paths(
            paths, rules=rules, project_rules=project_rules
        )
    except ValueError as e:
        print(f"tpu-lint: {e}", file=sys.stderr)
        return 2

    known_count = 0
    if fail_on_new:
        from .baseline import new_findings

        kept = new_findings(findings, baseline or {})
        known_count = len(findings) - len(kept)
        findings = kept

    if fmt == "json":
        json.dump(
            {
                "files_checked": n_files,
                "count": len(findings),
                "baselined": known_count,
                "findings": [f.as_dict() for f in findings],
            },
            out,
            indent=2,
        )
        out.write("\n")
    else:
        for f in findings:
            print(f.text(), file=out)
        suffix = (
            f" ({known_count} known finding(s) suppressed by baseline)"
            if known_count
            else ""
        )
        print(
            f"tpu-lint: {len(findings)} finding(s) in {n_files} "
            f"file(s){suffix}",
            file=out,
        )
    return 1 if findings else 0
