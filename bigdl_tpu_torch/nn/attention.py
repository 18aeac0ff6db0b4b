"""Attention layers: `MultiHeadAttention`.

Ports bigdl_tpu/nn/attention.py (no reference counterpart: attention is
the JAX package's extension of the sequence stack). The projections
are plain `torch.matmul`, as the JAX package computes them outside any
Pallas kernel; the attention itself is `ops/flash_attention.
flash_attention`, so on CUDA tensors it runs the flash kernels (K2
forward, K3 backward; any head dim, padded to the kernels' head dims)
and on CPU tensors their plain versions.

`impl` takes the port's flash values: None (the kernels for CUDA
tensors, the plain version for CPU tensors), "cuda" (the kernels or an
error), "torch" (the plain version). Attention-probability dropout
needs the probabilities materialized, so in training with
`attn_dropout` > 0 the layer runs `attention_reference` with its mask
drawn from `rng`, as the JAX package runs its reference; output
dropout works on every path. The masks are torch's streams, not
threefry's: the packages agree at dropout 0 and in expectation.

Incremental decode (`init_cache`, `apply_prefill`, `apply_decode`)
rides the dense KV cache of ops/kv_cache.py: the prefill runs the flash
path over the prompt and writes its keys and values, each decode step
writes one row a sequence at its clock and attends over the cache. The
cache is updated in place and returned.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.dropout import _keep_mask, _need_rng
from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.flash_attention import (attention_reference,
                                                 flash_attention)
from bigdl_tpu_torch.ops.kv_cache import (cached_attention,
                                          init_layer_cache, update_cache,
                                          write_prefill)


class MultiHeadAttention(Module):
    """Multi-head (self- or cross-) attention over (B, S, E) inputs.

    apply(variables, x)             -> self-attention
    apply(variables, [q_in, kv_in]) -> cross-attention (kv_in gives the
                                       keys and values)

    Params, the JAX package's tree: wq, wk, wv (E, H*D), wo (H*D, E),
    Xavier; bq, bk, bv, bo zeros when `with_bias`."""

    def __init__(self, embed_dim: int, num_heads: int,
                 head_dim: Optional[int] = None, causal: bool = False,
                 attn_dropout: float = 0.0, out_dropout: float = 0.0,
                 with_bias: bool = True, impl: Optional[str] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if head_dim is None:
            if embed_dim % num_heads:
                raise ValueError(
                    f"embed_dim {embed_dim} not divisible by num_heads "
                    f"{num_heads}; pass head_dim explicitly")
            head_dim = embed_dim // num_heads
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.causal = causal
        self.attn_dropout = attn_dropout
        self.out_dropout = out_dropout
        self.with_bias = with_bias
        self.impl = impl

    def init_params(self, generator=None):
        e, hd = self.embed_dim, self.num_heads * self.head_dim
        init = Xavier()
        p = {"wq": init(generator, (e, hd), fan_in=e, fan_out=hd),
             "wk": init(generator, (e, hd), fan_in=e, fan_out=hd),
             "wv": init(generator, (e, hd), fan_in=e, fan_out=hd),
             "wo": init(generator, (hd, e), fan_in=hd, fan_out=e)}
        if self.with_bias:
            p.update(bq=torch.zeros(hd), bk=torch.zeros(hd),
                     bv=torch.zeros(hd), bo=torch.zeros(e))
        return p

    def _bias(self, p, key):
        return p[key] if self.with_bias else None

    def _proj(self, x, w, b):
        """(B, S, E) @ (E, H*D) (+ b) -> (B, H, S, D)."""
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        batch, seq = y.shape[0], y.shape[1]
        return y.reshape(batch, seq, self.num_heads,
                         self.head_dim).permute(0, 2, 1, 3)

    def _qkv(self, p, x_q, x_kv):
        return (self._proj(x_q, p["wq"], self._bias(p, "bq")),
                self._proj(x_kv, p["wk"], self._bias(p, "bk")),
                self._proj(x_kv, p["wv"], self._bias(p, "bv")))

    def _out(self, p, out):
        """(B, H, S, D) heads -> (B, S, E) through wo (+ bo)."""
        batch, _, seq, _ = out.shape
        out = out.permute(0, 2, 1, 3).reshape(
            batch, seq, self.num_heads * self.head_dim)
        y = torch.matmul(out, p["wo"])
        if self.with_bias:
            y = y + p["bo"]
        return y

    def apply(self, variables, input, training=False, rng=None):
        p = variables["params"]
        if isinstance(input, (list, tuple)):
            x_q, x_kv = input[0], input[1]
        else:
            x_q = x_kv = input
        q, k, v = self._qkv(p, x_q, x_kv)             # (B, H, S, D)
        if training and self.attn_dropout > 0.0:
            _need_rng(self, rng)
            out = attention_reference(q, k, v, causal=self.causal,
                                      dropout=self.attn_dropout,
                                      dropout_generator=rng)
        else:
            out = flash_attention(q, k, v, causal=self.causal,
                                  impl=self.impl)
        y = self._out(p, out)
        if training and self.out_dropout > 0.0:
            _need_rng(self, rng)
            keep = 1.0 - self.out_dropout
            mask = _keep_mask(y.shape, keep, y, rng)
            y = torch.where(mask, y, torch.zeros(
                (), dtype=y.dtype, device=y.device)) / keep
        return y, variables["state"]

    # ------------------------------------------------- incremental decode
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32, device=None):
        """A zero-filled {'k', 'v'} cache of (B, H, max_len, D)."""
        k, v = init_layer_cache(batch, self.num_heads, max_len,
                                self.head_dim, dtype, device)
        return {"k": k, "v": v}

    def _decode_only(self):
        if not self.causal:
            raise ValueError(f"{self.name}: incremental decode requires "
                             "causal=True")

    def apply_prefill(self, variables, x, cache):
        """Causal self-attention over the prompt x (B, S, E), writing its
        keys and values at cache positions [0, S). Returns (y (B, S, E),
        cache)."""
        self._decode_only()
        p = variables["params"]
        q, k, v = self._qkv(p, x, x)
        kc, vc = write_prefill(cache["k"], cache["v"], k, v)
        out = flash_attention(q, k, v, causal=True, impl=self.impl)
        return self._out(p, out), {"k": kc, "v": vc}

    def apply_decode(self, variables, x, cache, pos):
        """One decode step: x (B, E), the current token's features, is
        written at per-row positions `pos` (B,) and attends over the
        cache up to them. Returns (y (B, E), cache)."""
        self._decode_only()
        p = variables["params"]
        x3 = x[:, None, :]
        q, k, v = self._qkv(p, x3, x3)                # (B, H, 1, D)
        kc, vc = update_cache(cache["k"], cache["v"], k, v, pos)
        out = cached_attention(q, kc, vc, pos)
        return self._out(p, out)[:, 0], {"k": kc, "v": vc}
