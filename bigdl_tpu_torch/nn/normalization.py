"""Functional layer norm.

Ports `layer_norm` from bigdl_tpu/nn/normalization.py (the module
layers of that file come with the slices that use them).
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, written out as the JAX package
    writes it (mean of the squared deviation, then `rsqrt(var + eps)`)
    rather than `F.layer_norm`, so both packages take the same steps."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y
