"""INT8 quantized inference layers.

Ports bigdl_tpu/nn/quantized.py (reference: nn/quantized/Linear.scala,
nn/quantized/SpatialConvolution.scala over `QuantizedTensor`, backed by
the bigquant int8 kernels). The scheme is the JAX package's: weights
quantized offline, symmetric per output channel (scale = max|w| / 127);
activations quantized at each call, symmetric per tensor; the int8 x
int8 products accumulate in int32, and one fp32 scale multiply
restores the output. The rounding is `torch.round`, half to even, as
`jnp.round`.

The int32 accumulators are exact integer sums in both packages, so
they agree bit for bit. The product (`int8_matmul`): on the card
`torch._int_mm`, cuBLASLt's int8 gemm — the JAX package's products are
`lax.dot_general` / `conv_general_dilated` with
`preferred_element_type=int32`, outside any Pallas kernel, so a library
call stands in for them — with rows, K and N zero-padded to its shape
rules (zeros keep the sums exact); on CPU tensors the plain version,
the product in fp64, exact while |sum| < 2^53. The convolution builds
NHWC patches (the window taps of each output pixel, (kh, kw, C) in the
HWIO weight's order) and multiplies them per group; it honours
dilation, which the JAX layer leaves out.

`quantize(module, variables)` converts a trained model (reference:
`Module.quantize()`), swapping Linear / SpatialConvolution inside
containers for their quantized twins and keeping the containers' keys.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.container import Container
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module

# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_INT_MM_MIN_ROWS, _INT_MM_ALIGN = 17, 8


def _divisor(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on `like`'s device. A Python-number divisor makes
    the CUDA kernel multiply by its reciprocal, a rounding away from
    the true quotient the CPU and the JAX package take; a tensor
    divisor divides on both."""
    return torch.full((), 127.0, dtype=like.dtype, device=like.device)


def _quantize_weight(w: torch.Tensor, axis
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 over `axis` (an int or a tuple):
    (int8 weights, fp32 scales with the reduced axes kept)."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / _divisor(amax)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8 for activations."""
    amax = x.abs().amax()
    scale = amax.clamp_min(1e-8) / _divisor(amax)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> the exact (M, N) int32 product:
    `torch._int_mm` on CUDA tensors (operands zero-padded to its shape
    rules), the fp64 product on CPU tensors."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    mp = max(_round_up(m, _INT_MM_ALIGN), _round_up(_INT_MM_MIN_ROWS,
                                                    _INT_MM_ALIGN))
    kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (mp, np_) != (m, n) else out


class QuantizedLinear(Module):
    """INT8 y = x W + b (reference: nn/quantized/Linear.scala); params
    qweight (in, out) int8, scale (out,), bias (out,)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name=None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias

    @staticmethod
    def from_float(linear: Linear, variables: Dict[str, Any]):
        """The quantized twin of a trained Linear and its variables."""
        m = QuantizedLinear(linear.input_size, linear.output_size,
                            linear.with_bias, name=linear.name)
        m._explicit_name = linear._explicit_name
        p = variables["params"]
        qw, scale = _quantize_weight(p["weight"], axis=0)   # per column
        qp = {"qweight": qw, "scale": scale[0]}
        if linear.with_bias:
            qp["bias"] = p["bias"]
        return m, {"params": qp, "state": {}}

    def init_params(self, generator=None):
        qp = {"qweight": torch.zeros((self.input_size, self.output_size),
                                     dtype=torch.int8),
              "scale": torch.ones(self.output_size)}
        if self.with_bias:
            qp["bias"] = torch.zeros(self.output_size)
        return qp

    def accumulate(self, variables, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the int32 accumulator x_q . W_q, the activation scale)."""
        xq, xs = _quantize_act(x)
        acc = int8_matmul(xq.reshape(-1, x.shape[-1]),
                          variables["params"]["qweight"])
        return acc.reshape(*x.shape[:-1], acc.shape[-1]), xs

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        acc, xs = self.accumulate(variables, x)
        y = acc.float() * (p["scale"] * xs)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


class QuantizedSpatialConvolution(Module):
    """INT8 NHWC convolution (reference:
    nn/quantized/SpatialConvolution.scala), the twin of `conv`: its
    stride, padding (SAME and asymmetric pads included), groups and
    dilation; params qweight HWIO int8, scale (out,), bias (out,)."""

    def __init__(self, conv: SpatialConvolution, name=None):
        super().__init__(name=name or conv.name)
        self._explicit_name = conv._explicit_name
        self.conv = conv

    @staticmethod
    def from_float(conv: SpatialConvolution, variables: Dict[str, Any]):
        m = QuantizedSpatialConvolution(conv)
        p = variables["params"]
        # HWIO: reduce over (H, W, I), one scale an output channel
        qw, scale = _quantize_weight(p["weight"], axis=(0, 1, 2))
        qp = {"qweight": qw, "scale": scale.reshape(-1)}
        if conv.with_bias:
            qp["bias"] = p["bias"]
        return m, {"params": qp, "state": {}}

    def init_params(self, generator=None):
        c = self.conv
        qp = {"qweight": torch.zeros(
            (c.kernel_h, c.kernel_w, c.n_input_plane // c.n_group,
             c.n_output_plane), dtype=torch.int8),
            "scale": torch.ones(c.n_output_plane)}
        if c.with_bias:
            qp["bias"] = torch.zeros(c.n_output_plane)
        return qp

    def accumulate(self, variables, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the int32 accumulator, NHWC, the activation scale)."""
        c = self.conv
        w = variables["params"]["qweight"]
        kh, kw, cin_g, cout = w.shape
        g = c.n_group
        xq, xs = _quantize_act(x)
        (pt, pb), (pl, pr) = c._pad(x.shape[1], x.shape[2])
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
        dh, dw = c.dilation_h, c.dilation_w
        # (N, Ho, Wo, C, eh, ew) windows, then every dilation-th tap
        win = xq.unfold(1, dh * (kh - 1) + 1, c.stride_h) \
            .unfold(2, dw * (kw - 1) + 1, c.stride_w)[..., ::dh, ::dw]
        n, ho, wo = win.shape[:3]
        taps = kh * kw * cin_g
        # per group: (N Ho Wo, kh kw C/g) rows in the HWIO weight's order
        patches = win.reshape(n, ho, wo, g, cin_g, kh, kw) \
            .permute(3, 0, 1, 2, 5, 6, 4).reshape(g, n * ho * wo, taps)
        wg = w.reshape(taps, g, cout // g)
        acc = torch.cat([int8_matmul(patches[j], wg[:, j].contiguous())
                         for j in range(g)], dim=-1)
        return acc.reshape(n, ho, wo, cout), xs

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        acc, xs = self.accumulate(variables, x)
        y = acc.float() * (p["scale"] * xs)
        if self.conv.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


def quantize(module: Module, variables: Dict[str, Any]
             ) -> Tuple[Module, Dict[str, Any]]:
    """A trained model in INT8 inference form (reference:
    AbstractModule.quantize()): Linear / SpatialConvolution become
    their quantized twins, containers recurse keeping their keys,
    everything else passes through with its variables."""
    if isinstance(module, Linear):
        return QuantizedLinear.from_float(module, variables)
    if isinstance(module, SpatialConvolution):
        return QuantizedSpatialConvolution.from_float(module, variables)
    if isinstance(module, Container):
        children, params, state = [], {}, {}
        for key, child in zip(module._keys, module.modules_):
            qchild, qvars = quantize(child, {
                "params": variables["params"][key],
                "state": variables["state"][key]})
            children.append(qchild)
            params[key] = qvars["params"]
            state[key] = qvars["state"]
        clone = type(module)(*children, name=module.name)
        clone._explicit_name = module._explicit_name
        clone._keys = list(module._keys)
        return clone, {"params": params, "state": state}
    return module, variables
