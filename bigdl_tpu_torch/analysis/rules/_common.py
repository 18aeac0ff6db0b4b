"""Shared AST helpers for the port's lint rules — re-exported from
`bigdl_tpu_torch.analysis.astutil` (ports
bigdl_tpu/analysis/rules/_common.py; the helpers live outside this
package so the ProjectContext can import them without triggering the
rules package __init__, a cycle)."""

from bigdl_tpu_torch.analysis.astutil import (  # noqa: F401
    call_name, dotted, functions, last_segment,
)
