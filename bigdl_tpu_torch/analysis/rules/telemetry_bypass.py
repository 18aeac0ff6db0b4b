"""telemetry-bypass — the port reports through `bigdl_tpu_torch.obs` and
logging, never `print()`.

Ports bigdl_tpu/analysis/rules/telemetry_bypass.py. Metrics, events and
spans go through `bigdl_tpu_torch.obs`, human-readable diagnostics
through the `bigdl_tpu_torch.*` loggers. A stray `print()` in library
code bypasses the BIGDL_OBS kill switch, the event log, and every
consumer parsing stdout (chip_smoke's JSON lines). Scope is the
package: `chip_smoke.py` and a module's `__main__` CLI own their
stdout (a CLI's prints carry an inline suppression that says so).
"""

from __future__ import annotations

import ast

from bigdl_tpu_torch.analysis.engine import Rule, register
from bigdl_tpu_torch.analysis.rules._common import call_name

_WRITES = {"sys.stdout.write", "sys.stderr.write"}


@register
class TelemetryBypass(Rule):
    name = "telemetry-bypass"
    severity = "error"
    description = ("print()/direct stdout writes in core — route "
                   "through logging or bigdl_tpu_torch.obs")
    scope = ("bigdl_tpu_torch/",)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name == "print":
                yield self.finding(
                    ctx, node,
                    "print() in core bypasses the obs plane and the "
                    "BIGDL_OBS kill switch — use "
                    "logging.getLogger('bigdl_tpu_torch.*') for "
                    "diagnostics or bigdl_tpu_torch.obs for telemetry")
            elif name in _WRITES:
                yield self.finding(
                    ctx, node,
                    f"{name} in core — use logging or bigdl_tpu_torch.obs")
