"""Spatial and temporal pooling.

Ports bigdl_tpu/nn/pooling.py (reference: nn/SpatialMaxPooling.scala,
nn/SpatialAveragePooling.scala, nn/TemporalMaxPooling.scala). NHWC
layout.

The JAX package pools with `lax.reduce_window` over explicit pads:
ceil mode extends only the bottom and right edges, so that the last
partial window is included, and the average divides by kh·kw over that
extension too (count_include_pad). Torch's own `ceil_mode` drops windows
that start in the padding and leaves the extension out of the divisor,
so the port pads explicitly (−inf for max, 0 for the sum) and then
pools without padding, the JAX way. The NHWC tensor is pooled through
its channels-last NCHW view (`permute`, no copy).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def _same_pad(size, k, s):
    out = -(-size // s)
    total = max(0, (out - 1) * s + k - size)
    return total // 2, total - total // 2


def _pool_padding(pad_h, pad_w, ceil_mode, in_h, in_w, kh, kw, sh, sw
                  ) -> List[Tuple[int, int]]:
    """[(top, bottom), (left, right)], as the JAX package computes them."""
    if pad_w == -1:  # reference semantics: -1 → TF-style SAME padding
        return [_same_pad(in_h, kh, sh), _same_pad(in_w, kw, sw)]
    pads = [(pad_h, pad_h), (pad_w, pad_w)]
    if ceil_mode:
        # extend bottom/right so the last partial window is included
        def extra(size, k, s, p):
            out_ceil = -(-(size + 2 * p - k) // s) + 1
            needed = (out_ceil - 1) * s + k - (size + 2 * p)
            return max(0, needed)
        pads[0] = (pad_h, pad_h + extra(in_h, kh, sh, pad_h))
        pads[1] = (pad_w, pad_w + extra(in_w, kw, sw, pad_w))
    return pads


def _pad_nchw(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    """The NHWC input padded on H and W, as its channels-last NCHW view."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb), value=value)
    return x.permute(0, 3, 1, 2)


class _SpatialPool(Module):
    """Shared constructor (reference arg order kW, kH, dW, dH, padW, padH)."""

    def __init__(self, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: Optional[int] = None,
                 stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: Optional[int] = None,
                 ceil_mode: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h if kernel_h is not None else kernel_w
        self.stride_w = stride_w if stride_w is not None else self.kernel_w
        self.stride_h = stride_h if stride_h is not None else self.kernel_h
        self.pad_w = pad_w
        self.pad_h = pad_h if pad_h is not None else pad_w
        self.ceil_mode = ceil_mode

    def ceil(self):
        self.ceil_mode = True
        self._record_mutation("ceil")
        return self

    def _pads(self, x):
        return _pool_padding(self.pad_h, self.pad_w, self.ceil_mode,
                             x.shape[1], x.shape[2],
                             self.kernel_h, self.kernel_w,
                             self.stride_h, self.stride_w)

    @property
    def _window(self):
        return dict(kernel_size=(self.kernel_h, self.kernel_w),
                    stride=(self.stride_h, self.stride_w))


class SpatialMaxPooling(_SpatialPool):
    """Max pool (reference: nn/SpatialMaxPooling.scala)."""

    def apply(self, variables, x, training=False, rng=None):
        y = F.max_pool2d(_pad_nchw(x, self._pads(x), float("-inf")),
                         **self._window)
        return y.permute(0, 2, 3, 1), variables["state"]


class SpatialAveragePooling(_SpatialPool):
    """Average pool (reference: nn/SpatialAveragePooling.scala;
    count_include_pad defaults to true, as in the reference; `divide`
    False returns the window sums)."""

    def __init__(self, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: Optional[int] = None,
                 stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: Optional[int] = None,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, name: Optional[str] = None):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w,
                         pad_h, ceil_mode, name=name)
        self.count_include_pad = count_include_pad
        self.divide = divide

    def apply(self, variables, x, training=False, rng=None):
        pads = self._pads(x)
        xp = _pad_nchw(x, pads, 0.0)
        if self.divide and self.count_include_pad:
            # the window sum over kh·kw, padded entries counted
            y = F.avg_pool2d(xp, **self._window)
            return y.permute(0, 2, 3, 1), variables["state"]
        s = F.avg_pool2d(xp, divisor_override=1,
                         **self._window).permute(0, 2, 3, 1)
        if not self.divide:
            return s, variables["state"]
        ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool2d(_pad_nchw(ones, pads, 0.0), divisor_override=1,
                           **self._window).permute(0, 2, 3, 1)
        return s / torch.clamp_min(cnt, 1.0), variables["state"]


class TemporalMaxPooling(Module):
    """1-D max pooling over (batch, time, frame) input (reference:
    nn/TemporalMaxPooling.scala — kW, dW). `kernel_w=-1` pools over the
    whole time axis (the text classifier's global max pool)."""

    def __init__(self, kernel_w: int, stride_w: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.kernel_w = kernel_w
        self.stride_w = stride_w if stride_w is not None else kernel_w

    def apply(self, variables, x, training=False, rng=None):
        kw = x.shape[1] if self.kernel_w == -1 else self.kernel_w
        sw = x.shape[1] if self.kernel_w == -1 else self.stride_w
        y = F.max_pool1d(x.permute(0, 2, 1), kw, sw)
        return y.permute(0, 2, 1), variables["state"]
