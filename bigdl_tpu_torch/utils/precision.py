"""Mixed-precision policies.

Ports bigdl_tpu/utils/precision.py: fp32 master weights and optimizer
state, forward and backward in the compute dtype (bf16 under
`DEFAULT_MIXED`). bf16 shares fp32's exponent range, so no loss
scaling is needed. The cast is `Tensor.to`, which autograd
differentiates, so gradients with respect to fp32 master weights come
back in fp32.
"""

from __future__ import annotations

from typing import Any

import torch


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point tensor leaf of a nested dict/list/tuple
    to `dtype`; integer leaves (token ids, labels) and non-tensors pass
    through untouched."""
    # imported here: models/convert imports utils/, whose package
    # exports this module
    from bigdl_tpu_torch.models.convert import tree_map

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


class Policy:
    """What dtype to store parameters in, compute in, and emit outputs
    in (the jmp-style policy of the JAX package)."""

    def __init__(self, param_dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 output_dtype: torch.dtype = torch.float32):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype

    def cast_to_compute(self, tree):
        return cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return cast_floats(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return cast_floats(tree, self.output_dtype)


DEFAULT_MIXED = Policy()
FULL_PRECISION = Policy(compute_dtype=torch.float32)
