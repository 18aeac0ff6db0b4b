"""Dropout layers.

Ports bigdl_tpu/nn/dropout.py (reference: nn/Dropout.scala — inverted
dropout, scaled at train time — nn/SpatialDropout2D, nn/GaussianNoise,
nn/GaussianDropout). Randomness is explicit, as in the JAX package:
`apply` draws its mask or noise from the `rng` generator it is given
(containers fold one per child, `nn.module._fold_rng`; the Optimizer
makes one a step on the device of the weights), so a seeded step is
repeatable. The draw happens on the input's device, which must be the
generator's. The streams are torch's, not threefry's: for the same
seed the masks differ from the JAX package's, so the two agree only in
evaluation and at p = 0. In training, `rng=None` raises ValueError.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


def _need_rng(module: Module, rng: Optional[torch.Generator]) -> None:
    if rng is None:
        raise ValueError(
            f"{module.name}: {type(module).__name__} in training mode needs "
            "an rng (pass rng= to apply)")


def _keep_mask(shape, keep: float, x: torch.Tensor,
               rng: torch.Generator) -> torch.Tensor:
    """A bool mask of `shape`, each entry True with probability `keep`."""
    return torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=rng).bool()


class Dropout(Module):
    """Inverted dropout (reference: nn/Dropout.scala — scales by
    1/(1-p) at train time so evaluation is the identity). `ip` (in
    place) is accepted for the reference's signature and ignored."""

    def __init__(self, init_p: float = 0.5, ip: bool = False,
                 scale: bool = True, name: Optional[str] = None):
        super().__init__(name=name)
        self.p = init_p
        self.scale = scale

    def apply(self, variables, x, training=False, rng=None):
        if not training or self.p <= 0.0:
            return x, variables["state"]
        _need_rng(self, rng)
        keep = 1.0 - self.p
        y = torch.where(_keep_mask(x.shape, keep, x, rng), x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        if self.scale:
            y = y / keep
        return y, variables["state"]


class SpatialDropout2D(Module):
    """Drop whole feature maps (NHWC: one draw a sample and channel)."""

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name=name)
        self.p = init_p

    def apply(self, variables, x, training=False, rng=None):
        if not training or self.p <= 0.0:
            return x, variables["state"]
        _need_rng(self, rng)
        keep = 1.0 - self.p
        mask = _keep_mask((x.shape[0], 1, 1, x.shape[-1]), keep, x, rng)
        return torch.where(mask, x, torch.zeros(
            (), dtype=x.dtype, device=x.device)) / keep, variables["state"]


class GaussianNoise(Module):
    """Additive zero-mean noise at train time (reference:
    nn/GaussianNoise.scala)."""

    def __init__(self, stddev: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.stddev = stddev

    def apply(self, variables, x, training=False, rng=None):
        if not training:
            return x, variables["state"]
        _need_rng(self, rng)
        noise = torch.randn(x.shape, generator=rng, dtype=x.dtype,
                            device=x.device)
        return x + self.stddev * noise, variables["state"]


class GaussianDropout(Module):
    """Multiplicative gaussian noise, 1 + N(0, rate / (1 - rate))
    (reference: nn/GaussianDropout.scala)."""

    def __init__(self, rate: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.rate = rate

    def apply(self, variables, x, training=False, rng=None):
        if not training:
            return x, variables["state"]
        _need_rng(self, rng)
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = torch.randn(x.shape, generator=rng, dtype=x.dtype,
                            device=x.device)
        return x * (1.0 + stddev * noise), variables["state"]
