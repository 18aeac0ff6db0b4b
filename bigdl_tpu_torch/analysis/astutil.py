"""Shared AST helpers for the port's lint rules and its ProjectContext.

Ports bigdl_tpu/analysis/astutil.py, less its jit-decoration helpers:
the rules that read jit roots and static arguments (retrace-hazard,
trace-env-read, donation-flow) concern JAX tracing and have no port.
Lives outside `analysis/rules/` so `analysis/project.py` can use the
helpers without importing the rules package (whose __init__ imports
every rule module, several of which import project — a cycle).
`rules/_common.py` re-exports them for the rule modules."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """'os.environ.get' for a Name/Attribute chain, None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def last_segment(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n
