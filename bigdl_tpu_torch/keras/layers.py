"""Keras-1-shaped layer wrappers.

Ports bigdl_tpu/keras/layers.py (reference: the nn/keras layer classes):
each holds its config, infers its input shape from the previous layer at
build time, and lowers to a core `bigdl_tpu_torch.nn` module. Shapes
exclude the batch dim, as in Keras. Where the JAX package infers a
module's output shape abstractly (`jax.eval_shape`), the port runs the
module once on a zero batch of one on the CPU, without autograd."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch import nn

_ACTIVATIONS = {
    "relu": nn.ReLU, "relu6": nn.ReLU6, "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid, "softmax": nn.SoftMax,
    "log_softmax": nn.LogSoftMax, "elu": nn.ELU, "gelu": nn.GELU,
    "softplus": nn.SoftPlus, "softsign": nn.SoftSign, "linear": None,
    None: None,
}


def activation_module(name):
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    cls = _ACTIVATIONS[name]
    return cls() if cls is not None else None


class KerasLayer:
    """A layer config: `build(input_shape)` → (nn.Module, output_shape).
    input/output shapes EXCLUDE the batch dim, as in Keras."""

    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def build(self, input_shape: Tuple[int, ...]
              ) -> Tuple[Optional[nn.Module], Tuple[int, ...]]:
        raise NotImplementedError

    def __call__(self, tensor):
        """Functional-API wiring: `layer(tensor)` on a KTensor from
        `keras.Input` (see keras/functional.py)."""
        from bigdl_tpu_torch.keras.functional import call_layer

        return call_layer(self, tensor)

    @staticmethod
    def _infer_out(module: nn.Module, input_shape: Tuple[int, ...]
                   ) -> Tuple[int, ...]:
        """Output shape from one forward of a zero batch of 1."""
        with torch.no_grad():
            out, _ = module.apply(module.init(device="cpu"),
                                  torch.zeros((1,) + tuple(input_shape)),
                                  training=False)
        return tuple(out.shape)[1:]

    def _named(self, m: nn.Module) -> nn.Module:
        if self.name:
            m.set_name(self.name)
        return m


class InputLayer(KerasLayer):
    def __init__(self, input_shape: Sequence[int]):
        super().__init__(input_shape=input_shape)

    def build(self, input_shape):
        return None, tuple(input_shape)


class Dense(KerasLayer):
    """Fully-connected layer (keras.layers.Dense shape)."""

    def __init__(self, output_dim: int, activation: Optional[str] = None,
                 input_shape=None, name=None, **kw):
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.activation = activation

    def build(self, input_shape):
        if len(input_shape) != 1:
            raise ValueError(f"Dense expects flat input, got {input_shape}")
        m = self._named(nn.Linear(input_shape[0], self.output_dim))
        act = activation_module(self.activation)
        if act is not None:
            m = nn.Sequential(m, act)
        return m, (self.output_dim,)


class Conv2D(KerasLayer):
    """2-D conv over NHWC (keras.layers.Conv2D shape; `padding` is
    'valid' or 'same')."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", activation: Optional[str] = None,
                 input_shape=None, name=None, **kw):
        super().__init__(input_shape, name)
        self.filters = filters
        self.kernel = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.strides = (strides,) * 2 if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding
        self.activation = activation

    def build(self, input_shape):
        h, w, c = input_shape
        pad = -1 if self.padding == "same" else 0
        m = self._named(nn.SpatialConvolution(
            c, self.filters, self.kernel[1], self.kernel[0],
            self.strides[1], self.strides[0], pad, pad))
        out = self._infer_out(m, input_shape)
        act = activation_module(self.activation)
        if act is not None:
            m = nn.Sequential(m, act)
        return m, out


Convolution2D = Conv2D


class _Pool2D(KerasLayer):
    _cls = None
    _kw = {}

    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool = (pool_size,) * 2 if isinstance(pool_size, int) \
            else tuple(pool_size)
        strides = strides if strides is not None else self.pool
        self.strides = (strides,) * 2 if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding

    def build(self, input_shape):
        pad = -1 if self.padding == "same" else 0
        m = self._named(self._cls(
            self.pool[1], self.pool[0], self.strides[1], self.strides[0],
            pad_w=pad, pad_h=pad, **self._kw))
        return m, self._infer_out(m, input_shape)


class MaxPooling2D(_Pool2D):
    _cls = nn.SpatialMaxPooling


class AveragePooling2D(_Pool2D):
    _cls = nn.SpatialAveragePooling
    _kw = {"count_include_pad": False}


class GlobalAveragePooling2D(KerasLayer):
    def build(self, input_shape):
        m = self._named(nn.Sequential(
            nn.Mean(dimension=2, squeeze=True),
            nn.Mean(dimension=2, squeeze=True)))
        return m, (input_shape[-1],)


class Flatten(KerasLayer):
    def build(self, input_shape):
        n = 1
        for d in input_shape:
            n *= int(d)
        return self._named(nn.Reshape([n])), (n,)


class Reshape(KerasLayer):
    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.target_shape = tuple(target_shape)

    def build(self, input_shape):
        return (self._named(nn.Reshape(list(self.target_shape))),
                self.target_shape)


class Activation(KerasLayer):
    def __init__(self, activation: str, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.activation = activation

    def build(self, input_shape):
        m = activation_module(self.activation)
        if m is None:
            return None, tuple(input_shape)
        return self._named(m), tuple(input_shape)


class Dropout(KerasLayer):
    def __init__(self, rate: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.rate = rate

    def build(self, input_shape):
        return self._named(nn.Dropout(self.rate)), tuple(input_shape)


class BatchNormalization(KerasLayer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.epsilon = epsilon
        self.momentum = momentum

    def build(self, input_shape):
        if len(input_shape) == 3:
            m = nn.SpatialBatchNormalization(
                input_shape[-1], eps=self.epsilon,
                momentum=1.0 - self.momentum)
        else:
            m = nn.BatchNormalization(input_shape[-1], eps=self.epsilon,
                                      momentum=1.0 - self.momentum)
        return self._named(m), tuple(input_shape)


class Embedding(KerasLayer):
    """Token ids (seq_len,) → (seq_len, output_dim)."""

    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 input_length: Optional[int] = None, name=None):
        if input_shape is None and input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape, name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def build(self, input_shape):
        m = self._named(nn.LookupTable(self.input_dim, self.output_dim))
        return m, tuple(input_shape) + (self.output_dim,)


class LSTM(KerasLayer):
    """Recurrent LSTM over (seq_len, features); `return_sequences`
    mirrors keras (False → last output only)."""

    def __init__(self, units: int, return_sequences: bool = False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.units = units
        self.return_sequences = return_sequences

    def build(self, input_shape):
        seq_len, feat = input_shape
        m = nn.Recurrent(nn.LSTM(feat, self.units))
        if not self.return_sequences:
            m = nn.Sequential(m, nn.Select(2, -1))
            out = (self.units,)
        else:
            out = (seq_len, self.units)
        return self._named(m), out
