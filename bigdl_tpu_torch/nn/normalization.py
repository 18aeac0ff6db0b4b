"""Normalization layers.

Ports bigdl_tpu/nn/normalization.py (reference:
nn/BatchNormalization.scala, nn/SpatialBatchNormalization.scala,
nn/SpatialCrossMapLRN.scala, nn/Normalize.scala): the batch norms, LRN,
Normalize, LayerNorm, RMSNorm and the functional `layer_norm` of the
transformer blocks.

Running statistics live in `state`, not `params`, so autograd never
differentiates them; `training=True` returns the updated statistics
(detached: a step's state must not keep its graph alive) where the
reference mutates `runningMean`/`runningVar` in place. Batch norm is
written out as the JAX package writes it, not as `F.batch_norm`: fp32
one-pass statistics `E[x²] − E[x]²` clamped at 0, the biased variance
in the running average `(1 − m)·r + m·batch`, scale and shift folded in
fp32 and applied in the input's dtype. (An fp64 input, which the JAX
package never sees, keeps fp64 statistics.)

Statistics are per device (the reference's per-replica behaviour);
`sync=True` averages them over a mesh, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class BatchNormalization(Module):
    """BN over the last axis of (N, C) input (reference:
    nn/BatchNormalization.scala)."""

    _reduce_axes = (0,)

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 sync: bool = False, axis_name: str = "data",
                 name: Optional[str] = None):
        super().__init__(name=name)
        if sync:
            raise ValueError(
                "BatchNormalization(sync=True) averages statistics over a "
                "device mesh, which is not ported to bigdl_tpu_torch yet "
                "(ROADMAP.md, queue A.8)")
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine

    def init_params(self, generator=None):
        if not self.affine:
            return {}
        return {"weight": torch.ones((self.n_output,)),
                "bias": torch.zeros((self.n_output,))}

    def init_state(self):
        return {"running_mean": torch.zeros((self.n_output,)),
                "running_var": torch.ones((self.n_output,))}

    def apply(self, variables, x, training=False, rng=None):
        state = variables["state"]
        acc = torch.promote_types(x.dtype, torch.float32)
        if training:
            xf = x.to(acc)
            mean = torch.mean(xf, dim=self._reduce_axes)
            mean2 = torch.mean(torch.square(xf), dim=self._reduce_axes)
            var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
            m = self.momentum
            new_state = {
                "running_mean": ((1 - m) * state["running_mean"]
                                 + m * mean).detach(),
                "running_var": ((1 - m) * state["running_var"]
                                + m * var).detach(),
            }
        else:
            mean = state["running_mean"].to(acc)
            var = state["running_var"].to(acc)
            new_state = state
        # per-channel scale and shift in fp32, then one multiply-add over
        # the activation in its own dtype
        inv = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = variables["params"]["weight"].to(acc) * inv
            shift = variables["params"]["bias"].to(acc) - mean * scale
        else:
            scale = inv
            shift = -mean * inv
        return x * scale.to(x.dtype) + shift.to(x.dtype), new_state


class SpatialBatchNormalization(BatchNormalization):
    """BN over NHWC feature maps, reducing over (N, H, W) (reference:
    nn/SpatialBatchNormalization.scala)."""

    _reduce_axes = (0, 1, 2)


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels (reference:
    nn/SpatialCrossMapLRN.scala): y = x / (k + alpha/size ·
    Σ_window x²)^beta over the channel axis, the window centred as the
    JAX package pads it ((size − 1) // 2 before)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def apply(self, variables, x, training=False, rng=None):
        half = (self.size - 1) // 2
        sq = F.pad(x * x, (half, self.size - 1 - half))
        summed = sq.unfold(-1, self.size, 1).sum(dim=-1)
        denom = (self.k + (self.alpha / self.size) * summed) ** self.beta
        return x / denom, variables["state"]


class Normalize(Module):
    """Lp-normalize along the last axis (reference: nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.p = p
        self.eps = eps

    def apply(self, variables, x, training=False, rng=None):
        if self.p == 2.0:
            norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        else:
            norm = torch.sum(torch.abs(x) ** self.p, dim=-1,
                             keepdim=True) ** (1.0 / self.p)
        return x / torch.clamp_min(norm, self.eps), variables["state"]


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


class LayerNorm(Module):
    """Layer normalization over the last axis (no reference counterpart;
    the transformer stack's normalization)."""

    def __init__(self, size: int, eps: float = 1e-5, affine: bool = True,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = size
        self.eps = eps
        self.affine = affine

    def init_params(self, generator=None):
        if not self.affine:
            return {}
        return {"weight": torch.ones((self.size,)),
                "bias": torch.zeros((self.size,))}

    def apply(self, variables, x, training=False, rng=None):
        if self.affine:
            p = variables["params"]
            return layer_norm(x, p["weight"], p["bias"],
                              self.eps), variables["state"]
        return layer_norm(x, eps=self.eps), variables["state"]


class RMSNorm(Module):
    """RMS normalization over the last axis, no mean subtraction (no
    reference counterpart; kept beside LayerNorm)."""

    def __init__(self, size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = size
        self.eps = eps

    def init_params(self, generator=None):
        return {"weight": torch.ones((self.size,))}

    def apply(self, variables, x, training=False, rng=None):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + self.eps)
        return y * variables["params"]["weight"], variables["state"]
