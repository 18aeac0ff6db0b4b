"""Table — heterogeneous, 1-indexed activity container.

A copy of bigdl_tpu/utils/table.py (reference: utils/Table.scala#Table
and the `T()` factory) without its pytree registration, the file's only
use of JAX: the port's trees are plain nested dicts
(models/convert.tree_map), and a Table is one. Multi-input and
multi-output modules (ConcatTable, the table ops) pass Tables; plain
tuples and lists are accepted wherever a table is expected.
"""

from __future__ import annotations


class Table(dict):
    """Dict with 1-indexed integer convenience access.

    ``T(a, b, c)`` builds ``Table({1: a, 2: b, 3: c})`` mirroring the
    reference's ``T()`` factory (utils/Table.scala#T.apply).
    """

    def insert(self, value):
        self[len(self) + 1] = value
        return self

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self.items())
        return f"Table({inner})"


def sort_key(k):
    """Order dict keys numerically first, then strings — `repr` ordering
    would put 10 before 2 and permute tables with >= 10 entries."""
    return (isinstance(k, str), k)


def T(*args, **kwargs) -> Table:
    """Build a Table: positional args become 1-indexed entries."""
    t = Table()
    for v in args:
        t.insert(v)
    for k, v in kwargs.items():
        t[k] = v
    return t
