"""Embedding: `LookupTable`.

Ports bigdl_tpu/nn/embedding.py (reference: nn/LookupTable.scala).
Indices are 0-based, as in the JAX package. `padding_value` rows emit
zeros; `max_norm` renormalizes the table rows on the fly (the weights
themselves are not changed).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal)
from bigdl_tpu_torch.nn.module import Module


class LookupTable(Module):
    """Index -> embedding row (reference: nn/LookupTable.scala); the
    weight is (n_index, n_output), N(0, 1) by default."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[int] = None,
                 max_norm: Optional[float] = None,
                 w_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.w_init = w_init or RandomNormal(0.0, 1.0)

    def init_params(self, generator=None):
        return {"weight": self.w_init(generator,
                                      (self.n_index, self.n_output),
                                      fan_in=self.n_index,
                                      fan_out=self.n_output)}

    def apply(self, variables, idx, training=False, rng=None):
        w = variables["params"]["weight"]
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(w, dim=1, keepdim=True)
            w = w * torch.clamp(self.max_norm / norms.clamp_min(1e-7),
                                max=1.0)
        idx = idx.long()
        out = w[idx]
        if self.padding_value is not None:
            out = out * (idx != self.padding_value)[..., None].to(out.dtype)
        return out, variables["state"]
