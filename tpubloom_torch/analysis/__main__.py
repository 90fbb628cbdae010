"""Unified whole-system invariant check for the port.

``python -m tpubloom_torch.analysis [--json]`` is the one entry point
for the static half of the port's correctness tooling: it runs

* the full static tree lint of ``tpubloom_torch/``
  (:mod:`tpubloom_torch.analysis.lint` — all checks, tree mode on), and
* the lock-ORDER manifest diff
  (:mod:`tpubloom_torch.analysis.lock_order`)
  over every collected ``lockcheck-*.json`` runtime report it can find
  (``--reports`` paths, else ``$TPUBLOOM_LOCK_CHECK_DIR``),

and folds both into ONE exit code: 0 = the tree is clean AND every
observed runtime acquisition edge is declared; 1 = anything, anywhere,
drifted.

Report collection is OPTIONAL by design: with no reports given and no
``$TPUBLOOM_LOCK_CHECK_DIR``, the check runs the static half alone
(the common local invocation). An explicitly given but unreadable
report path IS a finding — a CI wiring rot must not look like a pass.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional

from tpubloom_torch.analysis import lint, lock_order


def _collect_report_paths(reports: Optional[list]) -> tuple:
    """(paths, explicit): expand files/dirs; ``explicit`` is True when
    the operator passed ``--reports`` AT ALL — including with zero
    values (the classic ``--reports $DIR`` with ``$DIR`` unset CI
    wiring rot), so an empty expansion is a finding."""
    explicit = reports is not None
    reports = list(reports or ())
    if not explicit:
        env_dir = os.environ.get("TPUBLOOM_LOCK_CHECK_DIR", "")
        reports = [env_dir] if env_dir else []
    paths: list = []
    for p in reports:
        if os.path.isdir(p):
            paths.extend(sorted(glob.glob(os.path.join(p, "lockcheck-*.json"))))
        elif p and (explicit or os.path.exists(p)):
            # a merely-INHERITED env dir that does not exist yet is not
            # a finding (no run has collected anything); an explicitly
            # named missing path is — see the module docstring
            paths.append(p)
    return paths, explicit


def run(
    lint_paths: Optional[list] = None,
    reports: Optional[list] = None,
    repo_root: Optional[str] = None,
) -> dict:
    """Library entry: ``{"lint": [...], "lock_order": [...],
    "reports_checked": N}`` — finding lists empty on a clean system."""
    repo_root = repo_root or lint._repo_root()
    targets = lint_paths or [os.path.join(repo_root, lint.PACKAGE)]
    config = lint.LintConfig(repo_root=repo_root)
    lint_findings = lint.lint_paths(targets, config)

    # None = not requested (env fallback); [] = requested with nothing
    # to expand, which IS a finding
    paths, explicit = _collect_report_paths(reports)
    lock_findings: list = []
    if explicit and not paths:
        lock_findings.append(
            {
                "kind": "no-reports",
                "message": "report paths given but no lockcheck-*.json "
                "found — the runtime gate did not actually run",
            }
        )
    n_reports = 0
    for path in paths:
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            lock_findings.append(
                {"kind": "unreadable-report", "message": f"{path}: {e}"}
            )
            continue
        n_reports += 1
        for v in report.get("violations", ()):
            lock_findings.append(
                {
                    "kind": f"runtime-{v.get('kind', 'violation')}",
                    "message": v.get("message", ""),
                    "report": path,
                }
            )
        for finding in lock_order.check_report(report):
            lock_findings.append({**finding, "report": path})
    return {
        "lint": [f.to_dict() for f in lint_findings],
        "lock_order": lock_findings,
        "reports_checked": n_reports,
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.analysis",
        description="unified invariant analyzer: static tree lint + "
        "lock-order manifest diff over collected runtime reports, one "
        "exit code",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to lint (default: the tpubloom_torch package)",
    )
    parser.add_argument(
        "--reports", nargs="*", default=None, metavar="PATH",
        help="lockcheck-*.json reports or directories of them (default: "
        "$TPUBLOOM_LOCK_CHECK_DIR when set; omitted entirely otherwise)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)
    result = run(lint_paths=args.paths or None, reports=args.reports)
    findings = result["lint"] + result["lock_order"]
    if args.as_json:
        print(json.dumps(result, indent=2))
    else:
        for f in result["lint"]:
            print(f"{f['path']}:{f['line']}: [{f['check']}] {f['message']}")
        for f in result["lock_order"]:
            print(
                f"[{f['kind']}] {f['message']}"
                + (f"  ({f['report']})" if "report" in f else "")
            )
        print(
            f"tpubloom_torch.analysis: {len(findings)} finding(s) "
            f"({len(result['lint'])} static, {len(result['lock_order'])} "
            f"lock-order) across {result['reports_checked']} runtime "
            f"report(s)"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
