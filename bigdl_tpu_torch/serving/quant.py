"""Quantized serving-weight layout.

Ports bigdl_tpu/serving/quant.py, on nn/quantized.py's
`_quantize_weight` as the JAX module is on its package's: BigDL's
low-precision inference — weights quantized offline, symmetric per output channel to int8, fp32
restored by one scale multiply. `quantize_serving_params` repacks the
gemm weights of a `TransformerLM.serving_params` dict into int8
`QuantWeight` leaves (same dict/tuple structure), and the model
dequantizes at use through the duck-typed `_deq`/`_embed_rows` hooks
of models/transformer.py. Biases, LayerNorm gains and the positional
table stay fp32.

The dequantize and the gemm are plain PyTorch (`q.float() * scale`,
then `torch.matmul`), as the JAX package computes them outside any
Pallas kernel; there is no fused int8 kernel on either side. The
rounding is `torch.round` — round half to even, as `jnp.round`.

Numerics contract: quantization is LOSSY. A quantized engine is not
bit-identical to fp32 and never claims to be; the bitwise pins (warm ==
cold, spill, handoff) are fp32-scoped, and a quantized engine is held
to a prefix of agreeing greedy tokens instead
(tests/test_torch_quant_serving.py). `layout_family` on the engine
names the contract a request's tokens were produced under.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from bigdl_tpu_torch.nn.quantized import _quantize_weight

# per-layer gemm weights quantized per OUTPUT channel (axis=0 of the
# (in, out) layout): one scale per output column
_BLOCK_GEMMS = ("wq", "wk", "wv", "wo", "w1", "w2")


class QuantWeight(NamedTuple):
    """An int8 weight and its fp32 dequant scale, as one node.
    models/transformer.py discovers it by duck type (`hasattr(w,
    "deq")`) — serving/ depends on models/, never the reverse."""

    q: torch.Tensor       # int8, the fp32 weight's shape
    scale: torch.Tensor   # fp32, broadcast shape (keepdim amax / 127)

    def deq(self) -> torch.Tensor:
        """fp32 view: one multiply."""
        return self.q.float() * self.scale

    @property
    def shape(self):
        return self.q.shape


def quantize_weight(w: torch.Tensor, axis: int = 0) -> QuantWeight:
    """Symmetric per-channel int8 repack of one fp32 weight (the
    nn/quantized.py scheme: scale = max|w| / 127 over `axis`)."""
    return QuantWeight(*_quantize_weight(w, axis))


def quantize_serving_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Repack a serving_params dict (per-layer block tuples) into the
    int8 layout: block gemm weights and the embedding/head table become
    QuantWeight leaves, everything else passes through untouched. The
    embedding is scaled PER ROW (axis=1), so token lookups gather int8
    rows and their scales instead of dequantizing the whole (V, E)
    table."""
    p = params["params"] if "params" in params else params
    if not isinstance(p["blocks"], (tuple, list)):
        raise ValueError(
            "quantize_serving_params expects the per-layer serving "
            "layout — call model.serving_params(variables) first")
    out = dict(p)
    out["blocks"] = tuple(
        {k: quantize_weight(v, axis=0) if k in _BLOCK_GEMMS else v
         for k, v in bp.items()}
        for bp in p["blocks"])
    out["embed"] = quantize_weight(p["embed"], axis=1)
    if "head" in p:
        out["head"] = quantize_weight(p["head"], axis=0)
    return out


def params_leaves(params: Any):
    """Every tensor of a params tree, in order (a QuantWeight yields q
    then scale)."""
    if isinstance(params, dict):
        for v in params.values():
            yield from params_leaves(v)
    elif isinstance(params, (tuple, list)):
        for v in params:
            yield from params_leaves(v)
    else:
        yield params


def params_bytes(params: Any) -> int:
    """Stored bytes of a params tree (QuantWeight counts q AND scale) —
    the weight-streaming side of the bytes a decoded token costs."""
    return int(sum(t.numel() * t.element_size()
                   for t in params_leaves(params)))
