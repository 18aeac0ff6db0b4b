"""Decoder-only Transformer language model: training and serving.

Ports bigdl_tpu/models/transformer.py: `TransformerConfig`, the
training forward of `TransformerLM` (`apply_hidden`, `loss`, `apply`,
with flash attention and the remat policies), the paged serving trio
(`init_block_pool`, `prefill_paged`, `decode_step_paged`) with
`init_params`, `serving_params` and the tied `head`, and
`lm_train_matmul_flops_per_token`. Same architecture: pre-LayerNorm
residual blocks, GELU MLP (the tanh approximation, which is what
`jax.nn.gelu` computes by default), learned positional embedding,
output head tied to the embedding.

The parameter tree keeps the JAX package's names, shapes and layouts,
so weights carry across unchanged (models/convert.py): `Linear`
weights are `(in, out)`; `blocks` holds `wq, wk, wv, wo, bq, bk, bv,
bo, ln1_g, ln1_b, ln2_g, ln2_b, w1, b1, w2, b2`, stacked `(L, ...)`;
top-level leaves are `embed`, `pos`, `lnf_g`, `lnf_b` (and `head` when
the embedding is untied). As in the JAX package the model object holds
the configuration and the methods take the parameters as an argument,
so one model serves any number of weight sets.

Training attention is `ops/flash_attention.flash_attention` (the CUDA
kernels on the card, the plain version on the CPU; `attn_impl`
overrides). The JAX package's `lax.scan` over the stacked blocks is a
Python loop over per-layer views (`unbind`, whose backward stacks the
layer gradients in one op). Remat policies map onto
`torch.utils.checkpoint`: "full" checkpoints the whole block, so the
flash forward re-runs in the backward; "attn_saved" checkpoints only
the FFN half, so the attention forward kernel runs once and its saved
(q, k, v, out, lse) feed the backward kernels; "dots" checkpoints the
block with a selective policy that saves the matmul outputs (the
counterpart of `dots_with_no_batch_dims_saveable`). Dropout draws from
an explicit `torch.Generator` (`rng`); its bits are not JAX's
(threefry is not ported), so parity holds at dropout 0. Masks are
drawn outside any checkpointed region, so a recomputation sees the
same mask.

The serving trio honours the int8 layout of serving/quant.py: every
gemm weight goes through `_deq` and the embedding lookup through
`_embed_rows`, duck-typed hooks that pass fp32 tensors through
untouched (as in the JAX package), so fp32 stays the bitwise reference
layout and the training paths never see a `QuantWeight`.

Not ported: the dense per-slot cache, mixture-of-experts FFNs, tensor
and sequence parallelism — asking for any of them raises
NotImplementedError.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import layer_norm
from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.ops.kv_cache import (block_attention,
                                          gather_block_cache,
                                          init_block_pool,
                                          write_decode_blocks,
                                          write_prompt_blocks)
from bigdl_tpu_torch.ops.paged_decode import paged_decode_attention
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

Pools = Tuple[Dict[str, torch.Tensor], ...]
REMAT_POLICIES = ("full", "dots", "attn_saved")


def _deq(w):
    """Duck-typed dequantize: a serving/quant.py QuantWeight knows how
    to `deq()` itself back to fp32; a plain tensor passes through. The
    serving paths call this at every gemm-weight use, so one code path
    serves both weight layouts — and models/ never imports serving/."""
    return w.deq() if hasattr(w, "deq") else w


def _embed_rows(w, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table row lookup for either layout. The quantized
    table is scaled PER ROW (scale (V, 1)), so a lookup gathers int8
    rows and their scales and multiplies — never the (V, E) fp32
    dequant `_deq` would materialize."""
    if hasattr(w, "deq"):
        return w.q[tokens].float() * w.scale[tokens]
    return w[tokens]


@dataclass
class TransformerConfig:
    vocab_size: int = 256
    max_len: int = 512
    dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    mlp_ratio: int = 4
    dropout: float = 0.0
    causal: bool = True
    tie_embeddings: bool = True
    # rematerialize each block in the backward: "full" (whole block),
    # "dots" (save matmul outputs, recompute the rest) or "attn_saved"
    # (checkpoint only the FFN half)
    remat: bool = False
    remat_policy: str = "full"
    # kept so a JAX configuration maps field for field; only 0 is ported
    moe_experts: int = 0

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {self.remat_policy!r}: expected 'full', "
                "'dots' or 'attn_saved'")
        if self.moe_experts:
            raise NotImplementedError(
                "mixture-of-experts FFNs are not ported yet")
        if self.dim % self.num_heads:
            raise ValueError("dim must be divisible by num_heads")


# matmul ops whose outputs the "dots" policy saves
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, *args, policy: str = "full"):
    """`fn(*args)` under a non-reentrant checkpoint; "dots" saves the
    matmul outputs."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def _dropout_mask(shape, keep: float, like: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Inverted-dropout multiplier (0 or 1/keep) in like's dtype."""
    draw = torch.rand(shape, generator=generator, device=like.device)
    return (draw < keep).to(like.dtype) / keep


class TransformerLM(Module):
    """apply(variables, tokens (B, S) int) → log-probs (B, S, V), and
    the paged serving surface, on `device` (None → the GPU,
    utils/device.py). `attn_impl` selects the training attention
    (ops/flash_attention.py: None → the kernels on CUDA tensors, the
    plain version on CPU tensors; "cuda" or "torch" explicitly).
    `sp_axis` / `tp_axis` exist to refuse the JAX package's parallel
    variants explicitly."""

    def __init__(self, config: TransformerConfig,
                 device: DeviceLike = None,
                 sp_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if sp_axis is not None or tp_axis is not None:
            raise NotImplementedError(
                "sequence and tensor parallelism are not ported yet")
        self.cfg = config
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self.head_dim = config.dim // config.num_heads

    # ------------------------------------------------------------ params
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
        """A fresh stacked parameter tree on the model's device, drawn
        from `generator` — a CPU `torch.Generator`, so the weights of a
        seed are the same whatever the device (default: seed 0). Same
        distributions as the JAX package: N(0, 1) * fan_in**-0.5 for
        the gemm weights, 0.02 * N(0, 1) for `embed` and `pos`, ones
        and zeros for the norms and biases. The draws differ from
        `jax.random`'s; weights carry across with models/convert.py."""
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        c = self.cfg
        e, f, n = c.dim, c.dim * c.mlp_ratio, c.num_layers

        def norm(shape, fan_in):
            return torch.randn(shape, generator=g) * fan_in ** -0.5

        blocks = {
            "ln1_g": torch.ones(n, e), "ln1_b": torch.zeros(n, e),
            "wq": norm((n, e, e), e), "wk": norm((n, e, e), e),
            "wv": norm((n, e, e), e), "wo": norm((n, e, e), e),
            "bq": torch.zeros(n, e), "bk": torch.zeros(n, e),
            "bv": torch.zeros(n, e), "bo": torch.zeros(n, e),
            "ln2_g": torch.ones(n, e), "ln2_b": torch.zeros(n, e),
            "w1": norm((n, e, f), e), "b1": torch.zeros(n, f),
            "w2": norm((n, f, e), f), "b2": torch.zeros(n, e),
        }
        p = {
            "embed": torch.randn(c.vocab_size, e, generator=g) * 0.02,
            "pos": torch.randn(c.max_len, e, generator=g) * 0.02,
            "blocks": blocks,
            "lnf_g": torch.ones(e), "lnf_b": torch.zeros(e),
        }
        if not c.tie_embeddings:
            p["head"] = norm((e, c.vocab_size), e)
        return tree_map(lambda t: t.to(self.device), p)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
        """As `Module.init`, on the model's device unless told another."""
        return super().init(generator,
                            self.device if device is None else device)

    @staticmethod
    def _params(variables: Dict[str, Any]) -> Dict[str, Any]:
        return variables["params"] if "params" in variables else variables

    def serving_params(self, variables: Dict[str, Any]) -> Dict[str, Any]:
        """The per-layer serving layout: `blocks` becomes a tuple of L
        dicts (views into the stacked leaves, no copy); a tree already
        in that layout passes through. Leaves move to the model's
        device."""
        p = self._params(variables)
        out = dict(p)
        out["blocks"] = self._layer_blocks(p)
        return tree_map(lambda t: t.to(self.device), out)

    def _layer_blocks(self, p: Dict[str, Any]) -> Sequence[Dict]:
        blocks = p["blocks"]
        if isinstance(blocks, (tuple, list)):
            return tuple(blocks)
        return tuple({k: v[i] for k, v in blocks.items()}
                     for i in range(self.cfg.num_layers))

    def head(self, variables: Dict[str, Any]) -> torch.Tensor:
        """The (E, V) output projection: `embed.T` when tied. A quantized
        embedding or head (serving/quant.py) is dequantized here."""
        p = self._params(variables)
        return _deq(p["embed"]).T if self.cfg.tie_embeddings \
            else _deq(p["head"])

    # ----------------------------------------------------------- helpers
    def _split_heads(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, heads, self.head_dim).transpose(1, 2)

    @staticmethod
    def _dense_ffn(y: torch.Tensor, bp: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        y = F.gelu(y @ _deq(bp["w1"]) + bp["b1"], approximate="tanh")
        return y @ _deq(bp["w2"]) + bp["b2"]

    # ---------------------------------------------------------- training
    def _attention(self, q, k, v):
        return flash_attention(q, k, v, causal=self.cfg.causal,
                               impl=self.attn_impl)

    def _block(self, x: torch.Tensor, bp: Dict[str, torch.Tensor],
               masks: Tuple[Optional[torch.Tensor], ...],
               remat_mlp: bool = False) -> torch.Tensor:
        """One pre-LN block; `masks` are the block's two dropout
        multipliers (None: no dropout). remat_mlp=True (the
        "attn_saved" policy) checkpoints ONLY the FFN half: the
        attention half runs outside any checkpoint, so the flash
        forward's saved tensors stay and the backward does not re-run
        the forward kernel."""
        b, s, _ = x.shape
        d = self.head_dim
        h = bp["wq"].shape[-1] // d
        y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        q = self._split_heads(y @ bp["wq"] + bp["bq"], h)
        k = self._split_heads(y @ bp["wk"] + bp["bk"], h)
        v = self._split_heads(y @ bp["wv"] + bp["bv"], h)
        a = self._attention(q, k, v)
        a = a.transpose(1, 2).reshape(b, s, h * d) @ bp["wo"] + bp["bo"]
        if masks[0] is not None:
            a = a * masks[0]
        x = x + a

        def ffn(xres):
            y = self._dense_ffn(layer_norm(xres, bp["ln2_g"], bp["ln2_b"]),
                                bp)
            return y if masks[1] is None else y * masks[1]

        return x + (_remat(ffn, x) if remat_mlp else ffn(x))

    def apply_hidden(self, variables: Dict[str, Any], tokens: torch.Tensor,
                     training: bool = False,
                     rng: Optional[torch.Generator] = None):
        """Forward up to the final LayerNorm: (B, S) int → (B, S, E).
        The training hot path: pair
        with `head(variables)` and
        `ops.losses.softmax_cross_entropy_chunked`, so (B, S, V) is
        never held."""
        c = self.cfg
        p = self._params(variables)
        s = tokens.shape[-1]
        x = p["embed"][tokens.long()] + p["pos"][:s]
        drop = training and c.dropout > 0.0
        if drop and rng is None:
            raise ValueError(f"{self.name}: dropout needs rng in training")
        blocks = p["blocks"]
        names = list(blocks)
        layers = [dict(zip(names, vals)) for vals in
                  zip(*(blocks[n].unbind(0) for n in names))]
        remat = c.remat_policy if c.remat else None
        for bp in layers:
            masks = ((_dropout_mask(x.shape, 1.0 - c.dropout, x, rng),
                      _dropout_mask(x.shape, 1.0 - c.dropout, x, rng))
                     if drop else (None, None))
            if remat in ("full", "dots"):
                x = _remat(functools.partial(self._block, masks=masks), x,
                           bp, policy=remat)
            else:
                x = self._block(x, bp, masks,
                                remat_mlp=remat == "attn_saved")
        return layer_norm(x, p["lnf_g"], p["lnf_b"])

    def loss(self, variables: Dict[str, Any], tokens: torch.Tensor,
             targets: torch.Tensor, training: bool = False,
             rng: Optional[torch.Generator] = None,
             chunk: int = 256) -> torch.Tensor:
        """Fused mean-NLL training loss — never holds (B, S, V)
        log-probs (ops/losses.softmax_cross_entropy_chunked)."""
        from bigdl_tpu_torch.ops.losses import softmax_cross_entropy_chunked

        hidden = self.apply_hidden(variables, tokens, training=training,
                                   rng=rng)
        return softmax_cross_entropy_chunked(hidden, self.head(variables),
                                             targets, chunk=chunk)

    def apply(self, variables: Dict[str, Any], tokens: torch.Tensor,
              training: bool = False,
              rng: Optional[torch.Generator] = None):
        """(log-probs (B, S, V), state) — the reference-parity
        LogSoftMax output for evaluation and prediction."""
        x = self.apply_hidden(variables, tokens, training=training,
                              rng=rng)
        logits = x @ self.head(variables)
        return torch.log_softmax(logits, dim=-1), variables.get("state", {})

    # ------------------------------------------------------- paged KV
    def _serving_guard(self) -> None:
        if not self.cfg.causal:
            raise ValueError("incremental decode requires causal=True")

    def init_block_pool(self, num_blocks: int, block_size: int,
                        dtype: torch.dtype = torch.float32) -> Pools:
        """Per-layer paged KV pools on the model's device: a tuple of L
        dicts {'k', 'v'}, each (num_blocks, H, block_size, D). Block 0
        is the reserved scratch block (ops/kv_cache.py)."""
        self._serving_guard()
        c = self.cfg
        return tuple(
            dict(zip(("k", "v"), init_block_pool(
                num_blocks, c.num_heads, block_size, self.head_dim,
                dtype, self.device)))
            for _ in range(c.num_layers))

    def prefill_paged(self, variables: Dict[str, Any],
                      tokens: torch.Tensor, pools: Pools,
                      table: torch.Tensor, block_ids: torch.Tensor,
                      start: int) -> Pools:
        """Prefill ONE request's suffix into the paged pools, in place:
        tokens (1, bucket) right-padded suffix at global positions
        [start, start + bucket); `table` (1, max_blocks) the slot's
        whole block table (reused prefix blocks, then the fresh
        `block_ids` (nb,) this call writes); `start` the block-aligned
        cached-prefix length (0 = cold). Returns the pools; the engine
        takes the first token by re-decoding the last prompt token, so
        no head runs here.

        Suffix queries attend through the gathered table over the FULL
        table extent with mask j <= start + i, so the written KV is
        bitwise the same whether a position is computed cold or warm
        (ops/kv_cache.py)."""
        self._serving_guard()
        p = self._params(variables)
        bsz, s = tokens.shape
        if bsz != 1:
            raise ValueError("prefill_paged fills one request (batch "
                             f"1), got batch {bsz}")
        start = int(start)
        if start < 0 or start + s > self.cfg.max_len:
            raise ValueError(f"positions [{start}, {start + s}) exceed "
                             f"the positional table ({self.cfg.max_len})")
        d = self.head_dim
        dev = tokens.device
        x = _embed_rows(p["embed"], tokens.long()) \
            + p["pos"][start:start + s]
        bs = pools[0]["k"].shape[2]
        jpos = torch.arange(table.shape[1] * bs, device=dev)
        ipos = start + torch.arange(s, device=dev)
        visible = jpos[None, None, :] <= ipos[None, :, None]  # (1, s, S)
        valid = jpos[None, :] < start + s                     # (1, S)
        for bp, pl in zip(self._layer_blocks(p), pools):
            h = bp["wq"].shape[-1] // d
            y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
            q = self._split_heads(y @ _deq(bp["wq"]) + bp["bq"], h)
            k = self._split_heads(y @ _deq(bp["wk"]) + bp["bk"], h)
            v = self._split_heads(y @ _deq(bp["wv"]) + bp["bv"], h)
            write_prompt_blocks(pl["k"], pl["v"], k, v, block_ids)
            kc = gather_block_cache(pl["k"], table)     # (1, H, S, D)
            vc = gather_block_cache(pl["v"], table)
            a = block_attention(q, kc, vc, visible, valid)
            a = a.transpose(1, 2).reshape(bsz, s, h * d)
            x = x + a @ _deq(bp["wo"]) + bp["bo"]
            x = x + self._dense_ffn(
                layer_norm(x, bp["ln2_g"], bp["ln2_b"]), bp)
        return pools

    def decode_step_paged(self, variables: Dict[str, Any],
                          tokens: torch.Tensor, pos: torch.Tensor,
                          pools: Pools, table: torch.Tensor,
                          attn_impl: Optional[str] = None
                          ) -> Tuple[torch.Tensor, Pools]:
        """One incremental step over the paged pools: tokens (B,) the
        current token per row, written at the row clocks pos (B,)
        int32, i.e. at (table[pos // bs], pos % bs) — always an
        exclusive block (copy-on-write) — then attended through the
        table. Returns (logits (B, V) for the NEXT token, pools), the
        pools updated in place. Every op is per row, so a non-finite
        row contaminates only its own logits and its own blocks.

        `attn_impl` selects the decode attention
        (ops/paged_decode.py): None → the CUDA kernel for CUDA
        tensors, the plain version for CPU tensors; "cuda" or
        "torch" explicitly."""
        self._serving_guard()
        p = self._params(variables)
        bsz = tokens.shape[0]
        d = self.head_dim
        bs = pools[0]["k"].shape[2]
        pos_l = pos.long()
        rows = torch.arange(bsz, device=tokens.device)
        block_ids = table.long()[rows, pos_l // bs]          # (B,)
        offsets = pos_l % bs
        x = _embed_rows(p["embed"], tokens.long()) + p["pos"][pos_l]
        for bp, pl in zip(self._layer_blocks(p), pools):
            h = bp["wq"].shape[-1] // d
            y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])[:, None, :]
            # (B, h, 1, D)
            q = self._split_heads(y @ _deq(bp["wq"]) + bp["bq"], h)
            k = self._split_heads(y @ _deq(bp["wk"]) + bp["bk"], h)
            v = self._split_heads(y @ _deq(bp["wv"]) + bp["bv"], h)
            write_decode_blocks(pl["k"], pl["v"], k, v, block_ids,
                                offsets)
            a = paged_decode_attention(q.contiguous(), pl["k"], pl["v"],
                                       table, pos, impl=attn_impl)
            a = a.reshape(bsz, h * d)
            x = x + a @ _deq(bp["wo"]) + bp["bo"]
            x = x + self._dense_ffn(
                layer_norm(x, bp["ln2_g"], bp["ln2_b"]), bp)
        hid = layer_norm(x, p["lnf_g"], p["lnf_b"])
        return hid @ self.head(p), pools


def lm_train_matmul_flops_per_token(cfg: TransformerConfig) -> float:
    """Training (fwd + bwd = 3x fwd) matmul FLOPs per token — the
    analytic model-flops count behind the model-flops share. Remat
    recompute is not credited (the usual convention).

    Per layer fwd: qkv+o projections 4*2*e^2, mlp 2*2*e*4e -> 24*e^2;
    attention scores+values 2*2*S*e (halved when causal); head 2*e*V.
    The embedding gather is not a matmul (excluded)."""
    e, L, S, V = cfg.dim, cfg.num_layers, cfg.max_len, cfg.vocab_size
    per_layer = 24 * e * e + (2 * 2 * S * e) * (0.5 if cfg.causal else 1)
    head = 2 * e * V
    return 3 * (L * per_layer + head)
