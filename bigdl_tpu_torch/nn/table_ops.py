"""Table (multi-activity) arithmetic, routing and reduce layers.

Ports bigdl_tpu/nn/table_ops.py (reference: nn/CAddTable.scala,
nn/CMulTable.scala, nn/CSubTable.scala, nn/CDivTable.scala,
nn/CMaxTable.scala, nn/CMinTable.scala, nn/JoinTable.scala,
nn/SplitTable.scala, nn/SelectTable.scala, nn/FlattenTable.scala,
nn/MM.scala, nn/MV.scala, nn/DotProduct.scala, nn/CosineDistance.scala,
nn/Sum.scala, nn/Mean.scala, nn/Max.scala, nn/Min.scala). A table input
is a `utils.table.Table` (any dict) or a sequence; a dict's elements
are read in `sort_key` order (integer keys numerically, then strings),
as the JAX package reads a Table, so `SelectTable`/`JoinTable` pick and
join the same elements. For the reduce family, `dimension` is 1-based
as in the reference, negative counts from the end; with `n_input_dims`
> 0 an input of one more dim has a leading batch dim, which shifts the
axis by one. `Max`/`Min` share the gradient among tied extremes, as
JAX's reductions do (`torch.amax`/`amin`). CosineDistance floors each
norm at 1e-12.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import T, Table, sort_key


def _elems(input) -> list:
    if isinstance(input, dict):
        return [input[k] for k in sorted(input.keys(), key=sort_key)]
    return list(input)


class _TableReduce(Module):
    def _op(self, a, b):
        raise NotImplementedError

    def apply(self, variables, input, training=False, rng=None):
        elems = _elems(input)
        out = elems[0]
        for e in elems[1:]:
            out = self._op(out, e)
        return out, variables["state"]


class CAddTable(_TableReduce):
    def __init__(self, inplace: bool = False, name: Optional[str] = None):
        super().__init__(name=name)

    def _op(self, a, b):
        return a + b


class CMulTable(_TableReduce):
    def _op(self, a, b):
        return a * b


class CSubTable(_TableReduce):
    def _op(self, a, b):
        return a - b


class CDivTable(_TableReduce):
    def _op(self, a, b):
        return a / b


class CMaxTable(_TableReduce):
    def _op(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_TableReduce):
    def _op(self, a, b):
        return torch.minimum(a, b)


class JoinTable(Module):
    """Concatenate the table's elements along `dimension` (1-based;
    with `n_input_dims` > 0 a batched input shifts it past the batch
    dim) (reference: nn/JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def apply(self, variables, input, training=False, rng=None):
        elems = _elems(input)
        ax = self.dimension - 1
        if self.n_input_dims > 0 and elems[0].ndim == self.n_input_dims + 1:
            ax += 1
        return torch.cat(elems, dim=ax), variables["state"]


class SplitTable(Module):
    """Split a tensor along a dim into a Table of slices (reference:
    nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def apply(self, variables, x, training=False, rng=None):
        ax = self.dimension - 1
        if self.n_input_dims > 0 and x.ndim == self.n_input_dims + 1:
            ax += 1
        return T(*torch.unbind(x, dim=ax)), variables["state"]


class SelectTable(Module):
    """The i-th (1-based, negative from the end) table element
    (reference: nn/SelectTable.scala)."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.index = index

    def apply(self, variables, input, training=False, rng=None):
        elems = _elems(input)
        idx = self.index - 1 if self.index > 0 else len(elems) + self.index
        return elems[idx], variables["state"]


class FlattenTable(Module):
    """Flatten nested tables into one Table (reference:
    nn/FlattenTable.scala)."""

    def apply(self, variables, input, training=False, rng=None):
        out = Table()

        def rec(v):
            if isinstance(v, (dict, list, tuple)):
                for e in _elems(v):
                    rec(e)
            else:
                out.insert(v)

        rec(input)
        return out, variables["state"]


class MM(Module):
    """Batch matrix-matrix product of a 2-table (reference: nn/MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.trans_a, self.trans_b = trans_a, trans_b

    def apply(self, variables, input, training=False, rng=None):
        a, b = _elems(input)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b), variables["state"]


class MV(Module):
    """Batch matrix-vector product of a 2-table (reference: nn/MV.scala)."""

    def __init__(self, trans: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.trans = trans

    def apply(self, variables, input, training=False, rng=None):
        m, v = _elems(input)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v), variables["state"]


class DotProduct(Module):
    """Row-wise dot product of a 2-table (reference: nn/DotProduct.scala)."""

    def apply(self, variables, input, training=False, rng=None):
        a, b = _elems(input)
        return (a * b).sum(dim=-1), variables["state"]


class CosineDistance(Module):
    """Row-wise cosine similarity of a 2-table (reference:
    nn/CosineDistance.scala)."""

    def apply(self, variables, input, training=False, rng=None):
        a, b = _elems(input)
        na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=1e-12)
        nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        return (a * b).sum(dim=-1) / (na * nb), variables["state"]


class _AxisReduce(Module):

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True, name: Optional[str] = None):
        super().__init__(name=name)
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def _op(self, x, ax, keepdim):
        raise NotImplementedError

    def apply(self, variables, x, training=False, rng=None):
        ax = self.dimension - 1 if self.dimension > 0 \
            else x.ndim + self.dimension
        if self.n_input_dims > 0 and x.ndim == self.n_input_dims + 1:
            ax += 1
        return self._op(x, ax, not self.squeeze), variables["state"]


class Sum(_AxisReduce):
    def _op(self, x, ax, keepdim):
        return torch.sum(x, dim=ax, keepdim=keepdim)


class Mean(_AxisReduce):
    def _op(self, x, ax, keepdim):
        return torch.mean(x, dim=ax, keepdim=keepdim)


class Max(_AxisReduce):
    def _op(self, x, ax, keepdim):
        return torch.amax(x, dim=ax, keepdim=keepdim)


class Min(_AxisReduce):
    def _op(self, x, ax, keepdim):
        return torch.amin(x, dim=ax, keepdim=keepdim)
