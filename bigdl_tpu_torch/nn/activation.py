"""Activation layers.

Ports bigdl_tpu/nn/activation.py (reference: nn/ReLU.scala,
nn/Tanh.scala, nn/Sigmoid.scala, nn/SoftMax.scala, nn/LogSoftMax.scala,
nn/PReLU.scala, nn/SReLU.scala, nn/RReLU.scala, ...). The reference's
`ip` (in-place) flags are accepted and ignored. GELU is the tanh
approximation (`jax.nn.gelu`'s default). RReLU draws its training
slopes from the `rng` generator, on the input's device (torch's
stream, not threefry's: the packages agree in evaluation); in training
`rng=None` raises ValueError, as in nn/dropout.py.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.dropout import _need_rng
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


class PReLU(Module):
    """Learnable leaky slope (reference: nn/PReLU.scala); n_output_plane
    0 gives one shared slope, else one a channel on the trailing axis.
    Weight initialised to 0.25."""

    def __init__(self, n_output_plane: int = 0, name: Optional[str] = None):
        super().__init__(name=name)
        self.n_output_plane = n_output_plane

    def init_params(self, generator=None):
        return {"weight": torch.full((max(self.n_output_plane, 1),), 0.25)}

    def apply(self, variables, x, training=False, rng=None):
        w = variables["params"]["weight"]
        return torch.where(x >= 0, x, w * x), variables["state"]


class SReLU(Module):
    """S-shaped ReLU with four learnable parameters of `shape`
    (reference: nn/SReLU.scala):
    y = t_r + a_r (x - t_r)  if x >= t_r
        x                    if t_l < x < t_r
        t_l + a_l (x - t_l)  if x <= t_l
    """

    def __init__(self, shape, name: Optional[str] = None):
        super().__init__(name=name)
        self.shape = tuple(shape)

    def init_params(self, generator=None):
        return {"t_left": torch.zeros(self.shape),
                "a_left": torch.full(self.shape, 0.2),
                "t_right": torch.ones(self.shape),
                "a_right": torch.full(self.shape, 0.2)}

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        tl, al, tr, ar = (p["t_left"], p["a_left"], p["t_right"],
                          p["a_right"])
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        y = torch.where(x <= tl, tl + al * (x - tl), y)
        return y, variables["state"]


class RReLU(Module):
    """Randomized leaky ReLU (reference: nn/RReLU.scala): negative slopes
    drawn U(lower, upper) an element in training, the mean slope
    (lower + upper) / 2 in evaluation."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.lower = lower
        self.upper = upper

    def apply(self, variables, x, training=False, rng=None):
        if training:
            _need_rng(self, rng)
            a = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
                .uniform_(self.lower, self.upper, generator=rng)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x), variables["state"]
