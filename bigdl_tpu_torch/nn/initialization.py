"""Weight initialization methods.

Ports bigdl_tpu/nn/initialization.py (reference:
nn/InitializationMethod.scala): `Xavier`, `MsraFiller`,
`RandomUniform`, `RandomNormal`, `Zeros`, `Ones`, `ConstInitMethod`.
Each takes a CPU `torch.Generator` where the JAX package takes a PRNG
key, and explicit fans. The distributions and shapes are the JAX
package's; the draws are not (weights carry across with
models/convert.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class InitializationMethod:
    def __call__(self, generator: torch.Generator, shape, fan_in: int,
                 fan_out: int, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
        raise NotImplementedError


class Xavier(InitializationMethod):
    """Uniform(-a, a), a = sqrt(6 / (fan_in + fan_out)) — the default of
    Linear and the recurrent cells."""

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype).uniform_(-a, a,
                                                        generator=generator)


class MsraFiller(InitializationMethod):
    """He/MSRA normal init."""

    def __init__(self, variance_norm_average: bool = True):
        self.variance_norm_average = variance_norm_average

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average \
            else fan_in
        return math.sqrt(2.0 / n) * torch.randn(shape, generator=generator,
                                                dtype=dtype)


class RandomUniform(InitializationMethod):
    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        if self.lower is None:
            # reference default: 1/sqrt(fan_in) bounds
            bound = 1.0 / math.sqrt(max(fan_in, 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=dtype).uniform_(lo, hi,
                                                        generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        return self.mean + self.stdv * torch.randn(
            shape, generator=generator, dtype=dtype)


class Zeros(InitializationMethod):
    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


class Ones(InitializationMethod):
    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, fan_in, fan_out,
                 dtype=torch.float32):
        return torch.full(shape, self.value, dtype=dtype)
