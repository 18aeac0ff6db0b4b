"""Spatial upsampling.

Ports bigdl_tpu/nn/upsampling.py (reference:
nn/SpatialUpSamplingNearest.scala, nn/SpatialUpSamplingBilinear.scala;
integer scale). NHWC. The bilinear layer computes its source
coordinates as the JAX package does — `jnp.linspace`'s formula,
start (1 - i/n) + stop i/n with the stop appended, under
align_corners, the clipped half-pixel formula otherwise — then gathers
the four neighbours and blends them in the same order, so the two agree
to rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """`jnp.linspace(0.0, stop, num)` in fp32, term for term."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    head = 0.0 * (1 - step) + stop * step
    return torch.cat([head, torch.full((1,), stop, device=device)])


def _half_pixel(size: int, out: int, device) -> torch.Tensor:
    c = (torch.arange(out, dtype=torch.float32, device=device) + 0.5) \
        * (size / out) - 0.5
    return torch.clamp(c, 0.0, size - 1.0)


class SpatialUpSamplingNearest(Module):
    """Each pixel repeated `scale` times along H and W."""

    def __init__(self, scale: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.scale = int(scale)

    def apply(self, variables, x, training=False, rng=None):
        s = self.scale
        y = x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        return y, variables["state"]


class SpatialUpSamplingBilinear(Module):
    """Bilinear x`scale` upsampling; align_corners=True is the
    reference's (torch-style) default."""

    def __init__(self, scale: int, align_corners: bool = True,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.scale = int(scale)
        self.align_corners = align_corners

    def apply(self, variables, x, training=False, rng=None):
        _, h, w, _ = x.shape
        oh, ow = h * self.scale, w * self.scale
        if self.align_corners and oh > 1 and ow > 1:
            ys = _linspace(h - 1.0, oh, x.device)
            xs = _linspace(w - 1.0, ow, x.device)
        else:
            ys = _half_pixel(h, oh, x.device)
            xs = _half_pixel(w, ow, x.device)
        y0 = torch.floor(ys).long()
        x0 = torch.floor(xs).long()
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (ys - y0).to(x.dtype)[None, :, None, None]
        wx = (xs - x0).to(x.dtype)[None, None, :, None]

        def g(yi, xi):
            return x[:, yi][:, :, xi]

        top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
        bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
        return top * (1 - wy) + bot * wy, variables["state"]
