"""Keras layer wrappers, tranche 2: 3-D conv/pool, upsampling, global
max-pool, recurrent variants.

Ports bigdl_tpu/keras/layers_extra.py (reference: the nn/keras layer
set). `SimpleRNN`, `GRU` and `Bidirectional` build `nn.Recurrent` /
`nn.BiRecurrent`, so on a card a GRU runs the fused GRU kernels and a
bidirectional LSTM the two-direction LSTM kernels."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.layers import KerasLayer, activation_module


class Conv3D(KerasLayer):
    """3-D conv over (D, H, W, C) input."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1, 1),
                 padding: str = "valid", activation: Optional[str] = None,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.filters = filters
        self.kernel = (kernel_size,) * 3 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.strides = (strides,) * 3 if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding
        self.activation = activation

    def build(self, input_shape):
        d, h, w, c = input_shape
        pad = -1 if self.padding == "same" else 0
        m = self._named(nn.VolumetricConvolution(
            c, self.filters, self.kernel[0], self.kernel[2], self.kernel[1],
            self.strides[0], self.strides[2], self.strides[1],
            pad_t=pad, pad_w=pad, pad_h=pad))
        out = self._infer_out(m, input_shape)
        act = activation_module(self.activation)
        if act is not None:
            m = nn.Sequential(m, act)
        return m, out


class MaxPooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool = (pool_size,) * 3 if isinstance(pool_size, int) \
            else tuple(pool_size)
        if strides is None:
            self.strides = self.pool
        else:
            self.strides = (strides,) * 3 if isinstance(strides, int) \
                else tuple(strides)

    def build(self, input_shape):
        m = self._named(nn.VolumetricMaxPooling(
            self.pool[0], self.pool[2], self.pool[1],
            self.strides[0], self.strides[2], self.strides[1]))
        return m, self._infer_out(m, input_shape)


class UpSampling2D(KerasLayer):
    def __init__(self, size=2, interpolation: str = "nearest",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        if isinstance(size, (tuple, list)):  # keras's (2, 2) form
            if len(set(size)) != 1:
                raise NotImplementedError(
                    "UpSampling2D needs a uniform scale, got "
                    f"size={tuple(size)}")
            size = size[0]
        self.size = int(size)
        self.interpolation = interpolation

    def build(self, input_shape):
        if self.interpolation == "nearest":
            m = nn.SpatialUpSamplingNearest(self.size)
        else:
            m = nn.SpatialUpSamplingBilinear(self.size,
                                             align_corners=False)
        h, w, c = input_shape
        return self._named(m), (h * self.size, w * self.size, c)


class GlobalMaxPooling2D(KerasLayer):
    def build(self, input_shape):
        m = self._named(nn.Sequential(
            nn.Max(dimension=2, squeeze=True),
            nn.Max(dimension=2, squeeze=True)))
        return m, (input_shape[-1],)


class SimpleRNN(KerasLayer):
    def __init__(self, units: int, return_sequences: bool = False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.units = units
        self.return_sequences = return_sequences

    def _cell(self, feat):
        return nn.RnnCell(feat, self.units)

    def build(self, input_shape):
        seq_len, feat = input_shape
        m = nn.Recurrent(self._cell(feat))
        if not self.return_sequences:
            m = nn.Sequential(m, nn.Select(2, -1))
            return self._named(m), (self.units,)
        return self._named(m), (seq_len, self.units)


class GRU(SimpleRNN):
    def _cell(self, feat):
        return nn.GRU(feat, self.units)


class _BiLastState(nn.Module):
    """Keras 'last state' of a concat-merged BiRecurrent output
    (reference: nn/keras/Bidirectional.scala with returnSequences=false,
    over nn/BiRecurrent.scala output).

    (N, T, 2H) → (N, 2H): forward half at t=-1, backward half at t=0.
    BiRecurrent re-flips the backward stream to input order, so the
    backward RNN's FINAL step (all frames seen) sits at input position
    0 — Select(2, -1) on the joint output would take the backward
    RNN's first step instead, which is not Keras semantics."""

    def __init__(self, units: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.units = units

    def apply(self, variables, x, training=False, rng=None):
        h = self.units
        out = torch.cat([x[:, -1, :h], x[:, 0, h:]], dim=-1)
        return out, variables["state"]


class Bidirectional(KerasLayer):
    """Wrap an LSTM/GRU/SimpleRNN layer config to run both directions
    (concat merge, like the reference's BiRecurrent)."""

    def __init__(self, layer, input_shape=None, name=None):
        super().__init__(input_shape or layer.input_shape, name)
        self.layer = layer

    def build(self, input_shape):
        seq_len, feat = input_shape
        units = self.layer.units
        if isinstance(self.layer, GRU):
            cell = lambda: nn.GRU(feat, units)
        elif isinstance(self.layer, SimpleRNN):
            cell = lambda: nn.RnnCell(feat, units)
        else:  # keras.LSTM config from layers.py
            cell = lambda: nn.LSTM(feat, units)
        m = nn.BiRecurrent(cell(), cell())
        if not getattr(self.layer, "return_sequences", False):
            m = nn.Sequential(m, _BiLastState(units))
            return self._named(m), (2 * units,)
        return self._named(m), (seq_len, 2 * units)


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        if isinstance(padding, int):
            padding = (padding, padding)
        self.padding = tuple(padding)  # (pad_h, pad_w)

    def build(self, input_shape):
        h, w, c = input_shape
        ph, pw = self.padding
        m = self._named(nn.SpatialZeroPadding(pw, pw, ph, ph))
        return m, (h + 2 * ph, w + 2 * pw, c)


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((1, 1), (1, 1)), input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        if isinstance(cropping, int):
            cropping = ((cropping, cropping), (cropping, cropping))
        self.cropping = tuple(tuple(c) for c in cropping)

    def build(self, input_shape):
        h, w, c = input_shape
        (t, b), (l, r) = self.cropping
        m = self._named(nn.Sequential(
            nn.Narrow(2, t + 1, h - t - b),
            nn.Narrow(3, l + 1, w - l - r)))
        return m, (h - t - b, w - l - r, c)


class Permute(KerasLayer):
    """Permute non-batch dims, keras-style 1-based `dims`."""

    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dims = tuple(dims)

    def build(self, input_shape):
        # decompose the permutation into swaps for nn.Transpose
        # (1-based over full tensor: +1 for the batch dim)
        perm = [d - 1 for d in self.dims]   # 0-based over features
        cur = list(range(len(perm)))
        swaps = []
        for i, want in enumerate(perm):
            j = cur.index(want)
            if j != i:
                swaps.append((i + 2, j + 2))  # 1-based incl. batch
                cur[i], cur[j] = cur[j], cur[i]
        m = self._named(nn.Transpose(swaps)) if swaps else None
        out = tuple(input_shape[d - 1] for d in self.dims)
        return m, out


class RepeatVector(KerasLayer):
    """(B, F) → (B, n, F)."""

    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.n = n

    def build(self, input_shape):
        m = self._named(nn.Replicate(self.n, dim=2))
        return m, (self.n,) + tuple(input_shape)
