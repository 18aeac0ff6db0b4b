"""The port's static analysis: an AST lint of its own contracts.

Ports bigdl_tpu/analysis/ (graftlint) with the nine rules that do not
concern JAX tracing. `engine` holds the machinery (Rule/ProjectRule
registry, suppressions, baseline, the two-pass run); `project` the
shared single-parse ProjectContext behind the cross-module rules;
`astutil` the generic AST helpers; `rules/` the checks; `__main__` the
CLI (`python -m bigdl_tpu_torch.analysis`, the counterpart of
scripts/graftlint.py). Pure stdlib: it runs where neither JAX nor a
card is.
"""

from bigdl_tpu_torch.analysis.engine import (  # noqa: F401
    BaselineEntry, Finding, ProjectRule, Rule, RULES, apply_baseline,
    format_baseline, iter_python_files, lint_file, lint_source,
    load_baseline, parse_baseline, register, run_lint,
)

BASELINE_PATH = "bigdl_tpu_torch/analysis/baseline.toml"
