"""Shape-manipulation and identity layers.

Ports bigdl_tpu/nn/reshape.py (reference: nn/Reshape.scala,
nn/View.scala, nn/Squeeze.scala, nn/Unsqueeze.scala, nn/Select.scala,
nn/Narrow.scala, nn/Transpose.scala, nn/Contiguous.scala,
nn/Identity.scala, nn/Echo.scala, nn/Padding.scala,
nn/SpatialZeroPadding.scala, nn/AddConstant.scala, nn/MulConstant.scala,
nn/Replicate.scala, nn/Masking.scala, nn/GradientReversal.scala) and the
`SpaceToDepth` stem layer.

Dimension arguments keep the reference's conventions: Reshape/View
sizes exclude the batch; Select/Squeeze/Narrow/Transpose dims are
1-based over the full tensor, negative allowed. Activations are NHWC,
so `Reshape` flattens in H, W, C order as the JAX package does.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module

logger = logging.getLogger("bigdl_tpu_torch.nn")


def _axis(dim: int, ndim: int) -> int:
    """1-based (possibly negative) reference dim → 0-based axis."""
    return dim - 1 if dim > 0 else ndim + dim


class Reshape(Module):
    """Reshape non-batch dims (reference: nn/Reshape.scala; `size`
    excludes batch unless batch_mode is False)."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = True,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def apply(self, variables, x, training=False, rng=None):
        if self.batch_mode is False:
            return x.reshape(self.size), variables["state"]
        return x.reshape((x.shape[0],) + self.size), variables["state"]


class View(Reshape):
    """Alias of Reshape (reference: nn/View.scala; -1 wildcard)."""

    def __init__(self, *size, name: Optional[str] = None):
        if len(size) == 1 and isinstance(size[0], (tuple, list)):
            size = tuple(size[0])
        super().__init__(size, batch_mode=True, name=name)


class Squeeze(Module):
    def __init__(self, dim: Optional[int] = None, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim = dim

    def apply(self, variables, x, training=False, rng=None):
        if self.dim is None:
            return torch.squeeze(x), variables["state"]
        return torch.squeeze(x, _axis(self.dim, x.ndim)), variables["state"]


class Unsqueeze(Module):
    def __init__(self, pos: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.pos = pos

    def apply(self, variables, x, training=False, rng=None):
        return torch.unsqueeze(x, self.pos - 1), variables["state"]


class Select(Module):
    """Select an index along a dim, removing it (reference:
    nn/Select.scala; 1-based dim and index, negative allowed)."""

    def __init__(self, dim: int, index: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim = dim
        self.index = index

    def apply(self, variables, x, training=False, rng=None):
        ax = _axis(self.dim, x.ndim)
        idx = self.index - 1 if self.index > 0 else x.shape[ax] + self.index
        return torch.select(x, ax, idx), variables["state"]


class Narrow(Module):
    """Slice `length` elements from `offset` along dim (reference:
    nn/Narrow.scala)."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.dim, self.offset, self.length = dim, offset, length

    def apply(self, variables, x, training=False, rng=None):
        ax = _axis(self.dim, x.ndim)
        start = self.offset - 1
        length = self.length if self.length > 0 \
            else x.shape[ax] - start + self.length + 1
        return torch.narrow(x, ax, start, length), variables["state"]


class Transpose(Module):
    """Swap listed dim pairs (reference: nn/Transpose.scala; 1-based)."""

    def __init__(self, permutations: Sequence[Sequence[int]],
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.permutations = [tuple(p) for p in permutations]

    def apply(self, variables, x, training=False, rng=None):
        perm = list(range(x.ndim))
        for d1, d2 in self.permutations:
            a1, a2 = _axis(d1, x.ndim), _axis(d2, x.ndim)
            perm[a1], perm[a2] = perm[a2], perm[a1]
        return x.permute(perm), variables["state"]


class Contiguous(Module):
    """A contiguous copy where the input is a strided view (reference:
    nn/Contiguous.scala); the values pass through unchanged."""

    def apply(self, variables, x, training=False, rng=None):
        return x.contiguous(), variables["state"]


class Identity(Module):
    def apply(self, variables, x, training=False, rng=None):
        return x, variables["state"]


class Echo(Module):
    """Identity that logs its input's shape and dtype through the
    `bigdl_tpu_torch.nn` logger (reference: nn/Echo.scala)."""

    def apply(self, variables, x, training=False, rng=None):
        logger.info("[%s] shape=%s dtype=%s", self.name,
                    getattr(x, "shape", None), getattr(x, "dtype", None))
        return x, variables["state"]


class SpatialZeroPadding(Module):
    """Zero-pad H/W of NHWC input (reference: nn/SpatialZeroPadding.scala)."""

    def __init__(self, pad_left: int, pad_right: Optional[int] = None,
                 pad_top: Optional[int] = None,
                 pad_bottom: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.pad_left = pad_left
        self.pad_right = pad_right if pad_right is not None else pad_left
        self.pad_top = pad_top if pad_top is not None else pad_left
        self.pad_bottom = pad_bottom if pad_bottom is not None else pad_left

    def apply(self, variables, x, training=False, rng=None):
        y = F.pad(x, (0, 0, self.pad_left, self.pad_right,
                      self.pad_top, self.pad_bottom))
        return y, variables["state"]


class Padding(Module):
    """Pad `pad` entries along dim, before it when negative (reference:
    nn/Padding.scala)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim, self.pad = dim, pad
        self.n_input_dim, self.value = n_input_dim, value

    def apply(self, variables, x, training=False, rng=None):
        ax = _axis(self.dim, self.n_input_dim)
        if x.ndim == self.n_input_dim + 1:  # batched
            ax += 1
        pads = [0, 0] * (x.ndim - ax)       # F.pad lists the last axis first
        pads[-2:] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, pads, value=self.value), variables["state"]


class AddConstant(Module):
    """x + c (reference: nn/AddConstant.scala)."""

    def __init__(self, constant_scalar: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.constant_scalar = constant_scalar

    def apply(self, variables, x, training=False, rng=None):
        return x + self.constant_scalar, variables["state"]


class MulConstant(Module):
    """x * c (reference: nn/MulConstant.scala)."""

    def __init__(self, scalar: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.scalar = scalar

    def apply(self, variables, x, training=False, rng=None):
        return x * self.scalar, variables["state"]


class Replicate(Module):
    """Insert a new dim of size n_features at (1-based) dim (reference:
    nn/Replicate.scala)."""

    def __init__(self, n_features: int, dim: int = 1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.n_features = n_features
        self.dim = dim

    def apply(self, variables, x, training=False, rng=None):
        y = torch.unsqueeze(x, self.dim - 1)
        reps = [1] * y.ndim
        reps[self.dim - 1] = self.n_features
        return y.repeat(reps), variables["state"]


class Masking(Module):
    """Zero every timestep equal to mask_value across features
    (reference: nn/Masking.scala; keras Masking)."""

    def __init__(self, mask_value: float = 0.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.mask_value = mask_value

    def apply(self, variables, x, training=False, rng=None):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x)), variables["state"]


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g * ctx.lam, None


class GradientReversal(Module):
    """Identity forward, -lambda·grad backward (reference:
    nn/GradientReversal.scala — domain-adversarial training)."""

    def __init__(self, the_lambda: float = 1.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.the_lambda = the_lambda

    def apply(self, variables, x, training=False, rng=None):
        return _Reverse.apply(x, self.the_lambda), variables["state"]


class SpaceToDepth(Module):
    """(N, H, W, C) → (N, H/b, W/b, C·b²): move b×b spatial blocks into
    channels, in the JAX package's (row, column, channel) order. No
    reference counterpart: the stem idiom of `models/resnet.py`
    `stem="s2d"` (a 4×4 conv over 12 channels on half the grid in place
    of the 7×7/stride-2 conv over 3)."""

    def __init__(self, block_size: int = 2, name: Optional[str] = None):
        super().__init__(name=name)
        self.block_size = block_size

    def apply(self, variables, x, training=False, rng=None):
        b = self.block_size
        n, h, w, c = x.shape
        if h % b or w % b:
            raise ValueError(f"spatial dims {(h, w)} not divisible by "
                             f"block_size {b}")
        y = x.reshape(n, h // b, b, w // b, b, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b,
                                                b * b * c)
        return y, variables["state"]
