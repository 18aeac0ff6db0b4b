"""Linear layer.

Ports `Linear` from bigdl_tpu/nn/linear.py (reference: nn/Linear.scala).
The weight is stored (in, out), the JAX package's layout, so the
forward is `x @ W + b`. The file's other layers (CMul, CAdd, Bilinear,
Cosine, Euclidean) come with the slices that use them (ROADMAP.md
queue A.7).
"""

from __future__ import annotations

from typing import Optional

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
