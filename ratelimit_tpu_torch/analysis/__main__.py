"""CLI: ``python -m ratelimit_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error — so
a CI step gates directly on the return status.

Baseline workflow: ``--fail-on-new`` compares against the committed
``ratelimit_tpu_torch/analysis/baseline.json`` and fails
only on findings absent from it; ``--write-baseline`` regenerates the
file after a deliberate triage.
"""

from __future__ import annotations

import argparse
import sys

from .engine import analyze_paths, run_paths
from .rules import DEFAULT_PROJECT_RULES, DEFAULT_RULES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ratelimit_tpu_torch.analysis",
        description=(
            "tpu-lint for the PyTorch/CUDA port: whole-program "
            "concurrency analysis, kernel and CUDA ABI contract "
            "checking, torch host-sync hygiene"
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        default=["ratelimit_tpu_torch"],
        help="files or directories to lint (default: ratelimit_tpu_torch)",
    )
    p.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="report format (default: text)",
    )
    p.add_argument(
        "--select",
        default="",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule pack and exit",
    )
    p.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=(
            "baseline file for --fail-on-new / --write-baseline "
            "(default: the committed ratelimit_tpu_torch/analysis/baseline.json)"
        ),
    )
    p.add_argument(
        "--fail-on-new",
        action="store_true",
        help=(
            "fail only on findings NOT in the baseline (the CI "
            "ratchet; known findings are reported as suppressed)"
        ),
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="regenerate the baseline from the current findings and exit 0",
    )
    args = p.parse_args(argv)

    if args.list_rules:
        for rule in list(DEFAULT_RULES) + list(DEFAULT_PROJECT_RULES):
            print(f"{rule.id}: {rule.description}")
        return 0

    rules = DEFAULT_RULES
    project_rules = DEFAULT_PROJECT_RULES
    if args.select:
        wanted = {r.strip() for r in args.select.split(",") if r.strip()}
        known = {r.id for r in rules} | {r.id for r in project_rules}
        unknown = wanted - known
        if unknown:
            print(
                f"tpu-lint: unknown rule id(s): {sorted(unknown)} "
                f"(known: {sorted(known)})",
                file=sys.stderr,
            )
            return 2
        rules = [r for r in rules if r.id in wanted]
        project_rules = [r for r in project_rules if r.id in wanted]

    if args.write_baseline:
        from .baseline import write_baseline

        try:
            findings, n_files = analyze_paths(
                args.paths, rules=rules, project_rules=project_rules
            )
        except ValueError as e:
            print(f"tpu-lint: {e}", file=sys.stderr)
            return 2
        path = write_baseline(findings, args.baseline)
        print(
            f"tpu-lint: wrote {len(findings)} finding(s) from "
            f"{n_files} file(s) to {path}"
        )
        return 0

    baseline_doc = None
    if args.fail_on_new:
        from .baseline import load_baseline

        try:
            baseline_doc = load_baseline(args.baseline)
        except (ValueError, OSError) as e:
            print(f"tpu-lint: bad baseline: {e}", file=sys.stderr)
            return 2

    return run_paths(
        args.paths,
        rules=rules,
        fmt=args.format,
        project_rules=project_rules,
        baseline=baseline_doc,
        fail_on_new=args.fail_on_new,
    )


if __name__ == "__main__":
    sys.exit(main())
