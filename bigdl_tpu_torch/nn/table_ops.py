"""Table operations: the reduce family.

Ports `_AxisReduce`, `Sum`, `Mean`, `Max` and `Min` from
bigdl_tpu/nn/table_ops.py (reference: nn/Sum.scala, nn/Mean.scala,
nn/Max.scala, nn/Min.scala). `dimension` is 1-based as in the
reference, negative counts from the end; with `n_input_dims` > 0 an
input of one more dim has a leading batch dim, which shifts the axis
by one. `Max`/`Min` share the gradient among tied extremes, as JAX's
reductions do (`torch.amax`/`amin`). The rest of the file (JoinTable,
CAddTable and the other table layers) waits for the slices that use it
(ROADMAP.md queue A.4).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


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
