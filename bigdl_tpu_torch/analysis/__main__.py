"""The port's lint CLI — run its rules over the port.

Ports scripts/graftlint.py (the JAX package's CLI), placed in the
package so that it runs where the package does, the card's machine
included, with nothing but the standard library:

    python -m bigdl_tpu_torch.analysis                  # the port, text
    python -m bigdl_tpu_torch.analysis --format json    # machine-readable
    python -m bigdl_tpu_torch.analysis bigdl_tpu_torch/ops  # subtree
    python -m bigdl_tpu_torch.analysis --no-baseline    # ignore allowlist
    python -m bigdl_tpu_torch.analysis --list-rules

The JAX CLI's `--format sarif`, `--rules`, `--changed-only` and
`--write-baseline` are left out: nothing of the port calls them.

With no paths it lints `bigdl_tpu_torch/` and `chip_smoke.py` under
`--root` (default: the checkout this package lies in).

Exit codes: 0 clean (modulo baseline), 1 findings (or stale baseline
entries — the baseline may only shrink, so an entry matching nothing
is itself an error), 2 usage/parse trouble.

Two-pass engine: per-file rules check each file alone; cross-module
ProjectRules (event-kind-contract, metric-family-contract,
lock-discipline) check a ProjectContext built once from the whole
tree. A path-subset run skips project rules: a subset cannot answer
cross-module questions.
"""

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

from __future__ import annotations

import argparse
import json
import os
import sys

from bigdl_tpu_torch.analysis import (BASELINE_PATH, RULES,
                                      apply_baseline, iter_python_files,
                                      load_baseline, run_lint)
from bigdl_tpu_torch.analysis.engine import _ensure_rules_loaded

# the checkout this package lies in
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _resolve_paths(root: str, args_paths):
    """CLI path args (abs or repo-relative files/dirs) → repo-relative
    .py file list; None means the default full tree."""
    if not args_paths:
        return None
    out = []
    for p in args_paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        if os.path.isdir(full):
            out.extend(iter_python_files(root, roots=(rel,)))
        elif full.endswith(".py") and os.path.isfile(full):
            out.append(rel)
        else:
            # ValueError -> main's exit code 2 (usage trouble)
            raise ValueError(f"not a python file or directory: {p}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the full tree)")
    ap.add_argument("--root", default=_ROOT,
                    help="repo root (default: the checkout this "
                         "package lies in)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {BASELINE_PATH})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    if args.list_rules:
        _ensure_rules_loaded()
        for name in sorted(RULES):
            r = RULES[name]
            print(f"{name:30s} {r.severity:8s} {r.description}")
        return 0

    try:
        findings = run_lint(root, paths=_resolve_paths(root, args.paths))
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, BASELINE_PATH)
    stale = []
    if not args.no_baseline:
        baseline = load_baseline(baseline_path)
        findings, stale = apply_baseline(findings, baseline)
        if args.paths:
            # a path subset cannot see every finding, so absent ones
            # are not evidence an entry is stale — only the full
            # default run enforces shrink-only
            stale = []

    if args.format == "json":
        print(json.dumps({
            "findings": [f.as_dict() for f in findings],
            "stale_baseline": [vars(e) for e in stale],
            "counts": {
                "error": sum(f.severity == "error" for f in findings),
                "warning": sum(f.severity == "warning"
                               for f in findings),
            },
        }, indent=2))
    else:
        for f in findings:
            print(f.text())
        for e in stale:
            print(f"{baseline_path}: stale baseline entry "
                  f"({e.rule} @ {e.path} x{e.count}) — the finding is "
                  f"fixed; DELETE the entry (baseline only shrinks)")
        if findings or stale:
            ne = sum(f.severity == "error" for f in findings)
            nw = len(findings) - ne
            print(f"graftlint: {ne} error(s), {nw} warning(s), "
                  f"{len(stale)} stale baseline entr(ies)")
        else:
            print("graftlint: clean")
    return 1 if (findings or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
