"""Activation layers: the elementwise family.

Ports the `_Elementwise` layers of bigdl_tpu/nn/activation.py
(reference: nn/ReLU.scala, nn/Tanh.scala, nn/Sigmoid.scala,
nn/SoftMax.scala, nn/LogSoftMax.scala, ...). The reference's `ip`
(in-place) flags are accepted and ignored. GELU is the tanh
approximation (`jax.nn.gelu`'s default). The layers with parameters or
randomness (PReLU, SReLU, RReLU) come with the slices that use them
(ROADMAP.md queue A.7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class _Elementwise(Module):
    def __init__(self, ip: bool = False, name: Optional[str] = None):
        super().__init__(name=name)

    def _fn(self, x):
        raise NotImplementedError

    def apply(self, variables, x, training=False, rng=None):
        return self._fn(x), variables["state"]


class ReLU(_Elementwise):
    def _fn(self, x):
        return torch.relu(x)


class ReLU6(_Elementwise):
    def _fn(self, x):
        return torch.clamp(torch.relu(x), max=6.0)


class Tanh(_Elementwise):
    def _fn(self, x):
        return torch.tanh(x)


class Sigmoid(_Elementwise):
    def _fn(self, x):
        return torch.sigmoid(x)


class SoftMax(_Elementwise):
    def _fn(self, x):
        return torch.softmax(x, dim=-1)


class LogSoftMax(_Elementwise):
    def _fn(self, x):
        return torch.log_softmax(x, dim=-1)


class SoftPlus(_Elementwise):
    def __init__(self, beta: float = 1.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.beta = beta

    def _fn(self, x):
        return F.softplus(self.beta * x) / self.beta


class SoftSign(_Elementwise):
    def _fn(self, x):
        return x / (1.0 + x.abs())


class ELU(_Elementwise):
    def __init__(self, alpha: float = 1.0, ip: bool = False,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.alpha = alpha

    def _fn(self, x):
        return F.elu(x, alpha=self.alpha)


class GELU(_Elementwise):
    def _fn(self, x):
        return F.gelu(x, approximate="tanh")


class LeakyReLU(_Elementwise):
    def __init__(self, negval: float = 0.01, ip: bool = False,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.negval = negval

    def _fn(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class HardTanh(_Elementwise):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 ip: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    def __init__(self, min_value: float, max_value: float,
                 name: Optional[str] = None):
        super().__init__(min_value, max_value, name=name)


class Abs(_Elementwise):
    def _fn(self, x):
        return x.abs()


class Power(_Elementwise):
    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return (self.scale * x + self.shift) ** self.power


class Square(_Elementwise):
    def _fn(self, x):
        return x * x


class Sqrt(_Elementwise):
    def _fn(self, x):
        return torch.sqrt(x)


class Log(_Elementwise):
    def _fn(self, x):
        return torch.log(x)


class Exp(_Elementwise):
    def _fn(self, x):
        return torch.exp(x)


class HardSigmoid(_Elementwise):
    """clip(0.2x + 0.5, 0, 1) (reference: nn/HardSigmoid.scala)."""

    def _fn(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class Swish(_Elementwise):
    """x * sigmoid(x), SiLU (no reference counterpart)."""

    def _fn(self, x):
        return x * torch.sigmoid(x)


class Mish(_Elementwise):
    """x * tanh(softplus(x)) (reference: nn/Mish.scala)."""

    def _fn(self, x):
        return x * torch.tanh(F.softplus(x))
