"""Spatial and temporal convolution layers.

Ports bigdl_tpu/nn/conv.py (reference: nn/SpatialConvolution.scala,
nn/SpatialShareConvolution.scala, nn/SpatialDilatedConvolution.scala,
nn/SpatialFullConvolution.scala, nn/TemporalConvolution.scala).
Constructor argument order mirrors the reference: (nIn, nOut, kW, kH,
dW, dH, padW, padH, nGroup).

The JAX package's layouts are kept: activations NHWC, conv weights
HWIO (transposed conv: HWOI), so weights carry across unchanged
(models/convert.py). `F.conv2d` takes NCHW/OIHW shapes: the NHWC
activation is handed over as `x.permute(0, 3, 1, 2)`, a view with
channels-last strides that cuDNN reads without a copy, and the result
comes back the same way. The weight view `w.permute(3, 2, 0, 1)` is not
channels-last strided, so cuDNN may relayout it at each call.

The JAX package runs these as `lax.conv_general_dilated` outside any
Pallas kernel; the port's counterpart is the library call (cuDNN on the
card). `F.conv2d` pads symmetrically and never negatively, so the
SAME padding of `pad_w == -1`, the (low, high) tuples of the s2d stem
and negative pads (which crop) are applied with an explicit `F.pad`
first.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod, Xavier,
                                               Zeros)
from bigdl_tpu_torch.nn.module import Module


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF-style SAME padding of one axis (XLA's `padtype_to_pads` over
    the dilated kernel extent)."""
    out = -(-size // s)
    total = max(0, (out - 1) * s + d * (k - 1) + 1 - size)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor,
                 stride: Tuple[int, int],
                 pads: Sequence[Tuple[int, int]],
                 dilation: Tuple[int, int] = (1, 1),
                 groups: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO weight and explicit ((top, bottom), (left,
    right)) padding: symmetric non-negative pads go to `F.conv2d`,
    others through `F.pad` on the NHWC input first (a negative pad
    crops, as `lax.conv_general_dilated` does)."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr and pt >= 0 and pl >= 0:
        padding = (pt, pl)
    else:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        padding = (0, 0)
    y = F.conv2d(_nchw(x), w_hwio.permute(3, 2, 0, 1), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return _nhwc(y)


class SpatialConvolution(Module):
    """2-D convolution over NHWC input with an HWIO weight (reference:
    nn/SpatialConvolution.scala)."""

    def __init__(
        self,
        n_input_plane: int,
        n_output_plane: int,
        kernel_w: int,
        kernel_h: Optional[int] = None,
        stride_w: int = 1,
        stride_h: Optional[int] = None,
        pad_w=0,
        pad_h=None,
        n_group: int = 1,
        with_bias: bool = True,
        w_init: Optional[InitializationMethod] = None,
        b_init: Optional[InitializationMethod] = None,
        name: Optional[str] = None,
    ):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h if kernel_h is not None else kernel_w
        self.stride_w = stride_w
        self.stride_h = stride_h if stride_h is not None else stride_w
        self.pad_w = pad_w
        self.pad_h = pad_h if pad_h is not None else pad_w
        self.n_group = n_group
        self.with_bias = with_bias
        self.w_init = w_init or Xavier()
        self.b_init = b_init or Zeros()
        self.dilation_w = self.dilation_h = 1

    def init_params(self, generator=None):
        in_per_group = self.n_input_plane // self.n_group
        fan_in = in_per_group * self.kernel_h * self.kernel_w
        fan_out = (self.n_output_plane // self.n_group) \
            * self.kernel_h * self.kernel_w
        p = {"weight": self.w_init(
            generator, (self.kernel_h, self.kernel_w, in_per_group,
                        self.n_output_plane),
            fan_in=fan_in, fan_out=fan_out)}
        if self.with_bias:
            p["bias"] = self.b_init(generator, (self.n_output_plane,),
                                    fan_in=fan_in, fan_out=fan_out)
        return p

    def _pad(self, in_h: int, in_w: int):
        """((top, bottom), (left, right)): pad_w == -1 is TF-style SAME
        padding; a (low, high) tuple is asymmetric padding (the
        space-to-depth ResNet stem); an int pads both sides."""
        if self.pad_w == -1:
            return (_same_pads(in_h, self.kernel_h, self.stride_h,
                               self.dilation_h),
                    _same_pads(in_w, self.kernel_w, self.stride_w,
                               self.dilation_w))
        ph = (self.pad_h if isinstance(self.pad_h, (tuple, list))
              else (self.pad_h, self.pad_h))
        pw = (self.pad_w if isinstance(self.pad_w, (tuple, list))
              else (self.pad_w, self.pad_w))
        return tuple(ph), tuple(pw)

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        y = _conv2d_nhwc(x, p["weight"], (self.stride_h, self.stride_w),
                         self._pad(x.shape[1], x.shape[2]),
                         (self.dilation_h, self.dilation_w), self.n_group)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


# The reference's MKL weight-sharing variant is an allocation detail:
# the same math (reference: nn/SpatialShareConvolution.scala).
SpatialShareConvolution = SpatialConvolution


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (reference: nn/SpatialDilatedConvolution.scala)."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h=None,
                 stride_w=1, stride_h=None, pad_w=0, pad_h=None,
                 dilation_w: int = 1, dilation_h: Optional[int] = None,
                 with_bias: bool = True, name: Optional[str] = None, **kw):
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h,
                         with_bias=with_bias, name=name, **kw)
        self.dilation_w = dilation_w
        self.dilation_h = dilation_h if dilation_h is not None else dilation_w


class SpatialFullConvolution(Module):
    """Transposed convolution (reference: nn/SpatialFullConvolution.scala;
    adjW/adjH add output rows and columns at the bottom/right).
    `n_group`/`dilation_*` follow torch ConvTranspose2d's groups and
    dilation. The weight is HWOI (kh, kw, n_output_plane,
    n_input_plane / n_group), stored unflipped, as in the JAX package.

    The JAX package convolves the stride-dilated input with the flipped
    kernel over pads (d(k-1) - pad, d(k-1) - pad + adj). Here
    `F.conv_transpose2d` computes the same product with no padding
    (pads d(k-1) on both sides, every output that touches the input),
    and `F.pad` then crops `pad` from the top/left and `pad - adj`
    from the bottom/right (zero rows where adj > pad: there the
    dilated input has no tap)."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h=None,
                 stride_w=1, stride_h=None, pad_w=0, pad_h=None,
                 adj_w: int = 0, adj_h: int = 0, with_bias: bool = True,
                 n_group: int = 1, dilation_w: int = 1,
                 dilation_h: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h if kernel_h is not None else kernel_w
        self.stride_w = stride_w
        self.stride_h = stride_h if stride_h is not None else stride_w
        self.pad_w = pad_w
        self.pad_h = pad_h if pad_h is not None else pad_w
        self.adj_w, self.adj_h = adj_w, adj_h
        self.with_bias = with_bias
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(
                f"n_group {n_group} must divide n_input_plane "
                f"{n_input_plane} and n_output_plane {n_output_plane}")
        self.n_group = n_group
        self.dilation_w = dilation_w
        self.dilation_h = (dilation_h if dilation_h is not None
                           else dilation_w)

    def init_params(self, generator=None):
        fan_in = self.n_input_plane * self.kernel_h * self.kernel_w
        fan_out = self.n_output_plane * self.kernel_h * self.kernel_w
        p = {"weight": Xavier()(
            generator, (self.kernel_h, self.kernel_w, self.n_output_plane,
                        self.n_input_plane // self.n_group),
            fan_in=fan_in, fan_out=fan_out)}
        if self.with_bias:
            p["bias"] = torch.zeros((self.n_output_plane,))
        return p

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        g = self.n_group
        kh, kw, o, i = p["weight"].shape
        # HWOI, O split into g blocks → (in, out / g, kh, kw): input block
        # j feeds output block j, as under feature_group_count
        w = p["weight"].reshape(kh, kw, g, o // g, i) \
            .permute(2, 4, 3, 0, 1).reshape(g * i, o // g, kh, kw)
        y = F.conv_transpose2d(_nchw(x), w,
                               stride=(self.stride_h, self.stride_w),
                               dilation=(self.dilation_h, self.dilation_w),
                               groups=g)
        y = F.pad(y, (-self.pad_w, self.adj_w - self.pad_w,
                      -self.pad_h, self.adj_h - self.pad_h))
        y = _nhwc(y)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


class TemporalConvolution(Module):
    """1-D convolution over (batch, time, frame) input (reference:
    nn/TemporalConvolution.scala — inputFrameSize, outputFrameSize,
    kernelW, strideW); weight (kW, in, out), no padding."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.w_init = w_init or Xavier()
        self.b_init = b_init or Zeros()

    def init_params(self, generator=None):
        fan_in = self.input_frame_size * self.kernel_w
        fan_out = self.output_frame_size * self.kernel_w
        return {
            "weight": self.w_init(
                generator, (self.kernel_w, self.input_frame_size,
                            self.output_frame_size),
                fan_in=fan_in, fan_out=fan_out),
            "bias": self.b_init(generator, (self.output_frame_size,),
                                fan_in=fan_in, fan_out=fan_out),
        }

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        y = F.conv1d(x.permute(0, 2, 1), p["weight"].permute(2, 1, 0),
                     stride=self.stride_w)
        return y.permute(0, 2, 1) + p["bias"], variables["state"]
