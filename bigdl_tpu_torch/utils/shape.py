"""Shape helper.

Ports bigdl_tpu/utils/shape.py (reference: utils/Shape.scala).
"""

from __future__ import annotations


class Shape(tuple):
    """An immutable shape tuple. ``Shape(1, 28, 28)`` or ``Shape((1, 28, 28))``."""

    def __new__(cls, *dims):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        return super().__new__(cls, dims)

    @property
    def rank(self) -> int:
        return len(self)

    def numel(self) -> int:
        n = 1
        for d in self:
            n *= int(d)
        return n
