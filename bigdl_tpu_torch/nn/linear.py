"""Linear layers.

Ports bigdl_tpu/nn/linear.py (reference: nn/Linear.scala, nn/CMul.scala,
nn/CAdd.scala, nn/Bilinear.scala, nn/Cosine.scala, nn/Euclidean.scala).
The JAX package's layouts are kept: Linear's weight is (in, out), so
the forward is `x @ W + b`; Bilinear's (out, in1, in2); Cosine's
(out, in); Euclidean's (in, out). Cosine floors each norm at 1e-12.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import (InitializationMethod, Xavier,
                                               Zeros)
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """y = x W + b (reference: nn/Linear.scala#Linear); Xavier weight,
    zero bias by default."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_init = w_init or Xavier()
        self.b_init = b_init or Zeros()

    def init_params(self, generator=None):
        fans = dict(fan_in=self.input_size, fan_out=self.output_size)
        p = {"weight": self.w_init(generator,
                                   (self.input_size, self.output_size),
                                   **fans)}
        if self.with_bias:
            p["bias"] = self.b_init(generator, (self.output_size,), **fans)
        return p

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        y = x @ p["weight"]
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


class CMul(Module):
    """Learnable elementwise scale of `size`, ones at init (reference:
    nn/CMul.scala)."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(size)

    def init_params(self, generator=None):
        return {"weight": torch.ones(self.size)}

    def apply(self, variables, x, training=False, rng=None):
        return x * variables["params"]["weight"], variables["state"]


class CAdd(Module):
    """Learnable elementwise bias of `size`, zeros at init (reference:
    nn/CAdd.scala)."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(size)

    def init_params(self, generator=None):
        return {"bias": torch.zeros(self.size)}

    def apply(self, variables, x, training=False, rng=None):
        return x + variables["params"]["bias"], variables["state"]


class Bilinear(Module):
    """y_k = x1 W_k x2 + b_k over a 2-table (x1, x2): a list, or a
    Table keyed 1 and 2 (reference: nn/Bilinear.scala)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.with_bias = with_bias

    def init_params(self, generator=None):
        p = {"weight": Xavier()(
            generator, (self.output_size, self.input_size1,
                        self.input_size2),
            fan_in=self.input_size1 + self.input_size2,
            fan_out=self.output_size)}
        if self.with_bias:
            p["bias"] = torch.zeros(self.output_size)
        return p

    def apply(self, variables, input, training=False, rng=None):
        x1, x2 = ((input[1], input[2]) if isinstance(input, dict)
                  else (input[0], input[1]))
        p = variables["params"]
        y = torch.einsum("bi,oij,bj->bo", x1, p["weight"], x2)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-12)


class Cosine(Module):
    """Cosine similarity of the input to each of `output_size` learned
    templates (reference: nn/Cosine.scala); weight (out, in),
    U(-1/sqrt(in), 1/sqrt(in)) at init."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size

    def init_params(self, generator=None):
        lim = 1.0 / math.sqrt(self.input_size)
        return {"weight": torch.empty(self.output_size, self.input_size)
                .uniform_(-lim, lim, generator=generator)}

    def apply(self, variables, x, training=False, rng=None):
        w = variables["params"]["weight"]
        return _unit_rows(x) @ _unit_rows(w).T, variables["state"]


class Euclidean(Module):
    """Euclidean distance of the input to each learned template
    (reference: nn/Euclidean.scala); weight (in, out),
    U(-1/sqrt(in), 1/sqrt(in)) at init."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size

    def init_params(self, generator=None):
        lim = 1.0 / math.sqrt(self.input_size)
        return {"weight": torch.empty(self.input_size, self.output_size)
                .uniform_(-lim, lim, generator=generator)}

    def apply(self, variables, x, training=False, rng=None):
        w = variables["params"]["weight"]
        diff = x[..., :, None] - w[None, :, :]
        return torch.linalg.vector_norm(diff, dim=-2), variables["state"]
