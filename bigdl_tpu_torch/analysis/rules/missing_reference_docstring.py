"""missing-reference-docstring — every file of the port names the JAX
file it ports.

Ports bigdl_tpu/analysis/rules/missing_reference_docstring.py to the
port's own convention. The JAX package's rule holds each `nn/` layer
class to a `reference: nn/Xxx.scala` citation of the framework it was
modelled on; the port's traceability link is one step shorter: each
module's docstring names the file of the JAX package it ports
(`bigdl_tpu/<path>`, or the `scripts/<name>.py` or
`examples/<name>.py` it carries into the package), which is how a reader finds the reference a parity test
holds it to. A module with no counterpart says so ("No JAX
counterpart: <why>", or "No single JAX counterpart"). The docstring is
the module's first statement; a file without one is a finding at its
first line.
"""

from __future__ import annotations

import ast
import re

from bigdl_tpu_torch.analysis.engine import Rule, register

_OK_DOC = re.compile(
    r"bigdl_tpu/[\w./]*|(?:scripts|examples)/\w+\.py"
    r"|no\s+(?:\w+\s+)?JAX\s+counterpart",
    re.IGNORECASE)


@register
class MissingReferenceDocstring(Rule):
    name = "missing-reference-docstring"
    severity = "warning"
    description = ("port module whose docstring names no JAX file "
                   "(`bigdl_tpu/...`, `scripts/...`, `examples/...`) "
                   "and no `No JAX "
                   "counterpart`")
    scope = ("bigdl_tpu_torch/",)

    def check(self, ctx):
        doc = ast.get_docstring(ctx.tree)
        if doc is not None and _OK_DOC.search(doc):
            return
        node = ctx.tree.body[0] if doc is not None else ctx.tree
        yield self.finding(
            ctx, node,
            "module docstring names no JAX file — add the "
            "`bigdl_tpu/<path>.py` it ports, or `No JAX counterpart: "
            "<why>`")
