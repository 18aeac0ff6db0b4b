"""tf-import-in-core — TensorFlow is a test oracle, never a dependency
of the port.

Ports bigdl_tpu/analysis/rules/tf_import_in_core.py. The port reads
and writes TensorFlow graphs through its own protobuf codec
(`bigdl_tpu_torch/utils/protowire.py`, `utils/tf/`); a TensorFlow
import would drag a second ML runtime into every user process, and the
card's machine has none.
"""

from __future__ import annotations

import ast

from bigdl_tpu_torch.analysis.engine import Rule, register


@register
class TfImportInCore(Rule):
    name = "tf-import-in-core"
    severity = "error"
    description = "core must not import TensorFlow (test oracle only)"
    scope = ("bigdl_tpu_torch/",)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                if m == "tensorflow" or m.startswith("tensorflow."):
                    yield self.finding(
                        ctx, node,
                        f"import of {m!r} in core — TensorFlow is a "
                        f"test oracle only; interop goes through the "
                        f"port's own codec (bigdl_tpu_torch/utils/tf)")
