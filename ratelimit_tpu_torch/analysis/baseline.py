"""Finding baseline: ratchet CI on NEW findings only.

``python -m ratelimit_tpu_torch.analysis --fail-on-new`` compares the
current findings against a committed baseline
(``ratelimit_tpu_torch/analysis/baseline.json``) and fails only when a
finding is NOT in it — so a rule can land before its whole backlog is
fixed, and the backlog can only shrink (the classic lint-ratchet
workflow).

Baseline identity is ``(rule, path, message)`` — deliberately NOT the
line number, so unrelated edits that shift a known finding down the
file do not re-flag it.  Identity is multiset-valued: if a file gains
a SECOND instance of a known finding, the extra instance is new.

``--write-baseline`` regenerates the file from the current tree;
review the diff like any other code change (a grown baseline is a
conscious decision, never an accident).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .engine import Finding

#: The committed default baseline, next to this module.
DEFAULT_BASELINE_PATH = Path(__file__).with_name("baseline.json")

#: Repo root (the directory holding the ratelimit_tpu_torch package): the
#: anchor that makes baseline paths invocation-point independent.
_REPO_ROOT = Path(__file__).resolve().parents[2]


def _norm_path(path: str) -> str:
    """Separator- and anchor-normalized path: absolute paths under
    the repo root collapse to the repo-relative form the committed
    baseline stores, so `--fail-on-new` matches no matter what cwd or
    path spelling the analyzer was invoked with."""
    s = path.replace("\\", "/")
    p = Path(s)
    if p.is_absolute():
        try:
            s = p.resolve().relative_to(_REPO_ROOT).as_posix()
        except ValueError:
            pass
    return s


def _key(rule: str, path: str, message: str) -> tuple:
    return (rule, _norm_path(path), message)


def load_baseline(path: Optional[str] = None) -> dict:
    """The parsed baseline document; an absent file is an empty
    baseline (every finding is new), a malformed one is an error —
    silently ignoring a corrupt baseline would un-gate CI."""
    p = Path(path) if path else DEFAULT_BASELINE_PATH
    if not p.exists():
        return {"version": 1, "findings": []}
    doc = json.loads(p.read_text(encoding="utf-8"))
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"malformed baseline: {p}")
    return doc


def baseline_counter(doc: dict) -> Counter:
    return Counter(
        _key(f["rule"], f["path"], f["message"])
        for f in doc.get("findings", ())
    )


def new_findings(
    findings: Sequence[Finding], baseline_doc: dict
) -> List[Finding]:
    """Findings not covered by the baseline (multiset semantics)."""
    budget = baseline_counter(baseline_doc)
    out: List[Finding] = []
    for f in findings:
        k = _key(f.rule_id, f.path, f.message)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            out.append(f)
    return out


def write_baseline(
    findings: Sequence[Finding], path: Optional[str] = None
) -> str:
    """Serialize `findings` as the new baseline; returns the path.
    Lines are recorded for human review but ignored by matching."""
    p = Path(path) if path else DEFAULT_BASELINE_PATH
    doc = {
        "version": 1,
        "findings": [
            {
                "rule": f.rule_id,
                "path": _norm_path(f.path),
                "line": f.line,
                "message": f.message,
            }
            for f in sorted(
                findings, key=lambda f: (f.rule_id, f.path, f.line)
            )
        ],
    }
    p.write_text(json.dumps(doc, indent=2) + "\n", encoding="utf-8")
    return str(p)
