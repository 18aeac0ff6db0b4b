"""Volumetric (3-D) convolution and pooling.

Ports bigdl_tpu/nn/volumetric.py (reference:
nn/VolumetricConvolution.scala, nn/VolumetricMaxPooling.scala,
nn/VolumetricAveragePooling.scala; argument order kT, kW, kH, dT, dW,
dH, padT, padW, padH). The JAX package's layouts are kept: NDHWC
activations, DHWIO kernels. As nn/conv.py does in 2-D, the NDHWC
tensor goes to `F.conv3d` as its channels-last NCDHW view (cuDNN on the
card) and comes back the same way; `pad_w == -1` is TF-style SAME
padding, applied with `F.pad` first. The JAX package runs these as
`lax.conv_general_dilated` / `lax.reduce_window` outside any Pallas
kernel; the port's are the library calls. Pooling pads explicitly
(-inf for max, 0 for the sum) and then pools without padding, so the
average divides by kT kH kW everywhere, as the JAX window sum does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import _same_pads
from bigdl_tpu_torch.nn.initialization import (InitializationMethod, Xavier,
                                               Zeros)
from bigdl_tpu_torch.nn.module import Module


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1)


class VolumetricConvolution(Module):
    """3-D convolution over (N, D, H, W, C) input with a DHWIO weight."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t, self.d_w, self.d_h = d_t, d_w, d_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.with_bias = with_bias
        self.w_init = w_init or Xavier()
        self.b_init = b_init or Zeros()

    def init_params(self, generator=None):
        taps = self.k_t * self.k_h * self.k_w
        fans = dict(fan_in=self.n_input_plane * taps,
                    fan_out=self.n_output_plane * taps)
        p = {"weight": self.w_init(
            generator, (self.k_t, self.k_h, self.k_w, self.n_input_plane,
                        self.n_output_plane), **fans)}
        if self.with_bias:
            p["bias"] = self.b_init(generator, (self.n_output_plane,),
                                    **fans)
        return p

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        strides = (self.d_t, self.d_h, self.d_w)
        if self.pad_w == -1:
            (tl, th), (hl, hh), (wl, wh) = (
                _same_pads(size, k, s) for size, k, s in zip(
                    x.shape[1:4], (self.k_t, self.k_h, self.k_w), strides))
            x = F.pad(x, (0, 0, wl, wh, hl, hh, tl, th))
            padding = (0, 0, 0)
        else:
            padding = (self.pad_t, self.pad_h, self.pad_w)
        y = F.conv3d(_ncdhw(x), p["weight"].permute(4, 3, 0, 1, 2),
                     stride=strides, padding=padding)
        y = _ndhwc(y)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


class _VolumetricPool(Module):
    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t = d_t if d_t is not None else k_t
        self.d_w = d_w if d_w is not None else k_w
        self.d_h = d_h if d_h is not None else k_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h

    def _padded(self, x: torch.Tensor, value: float) -> torch.Tensor:
        """The NDHWC input padded on D, H and W, as its NCDHW view."""
        pads = (0, 0, self.pad_w, self.pad_w, self.pad_h, self.pad_h,
                self.pad_t, self.pad_t)
        if any(pads):
            x = F.pad(x, pads, value=value)
        return _ncdhw(x)

    def _window(self):
        return ((self.k_t, self.k_h, self.k_w),
                (self.d_t, self.d_h, self.d_w))


class VolumetricMaxPooling(_VolumetricPool):
    def apply(self, variables, x, training=False, rng=None):
        k, s = self._window()
        y = F.max_pool3d(self._padded(x, float("-inf")), k, s)
        return _ndhwc(y), variables["state"]


class VolumetricAveragePooling(_VolumetricPool):
    def apply(self, variables, x, training=False, rng=None):
        k, s = self._window()
        y = F.avg_pool3d(self._padded(x, 0.0), k, s)
        return _ndhwc(y), variables["state"]
