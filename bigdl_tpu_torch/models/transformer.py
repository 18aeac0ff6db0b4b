"""Decoder-only Transformer language model: training and serving.

Ports bigdl_tpu/models/transformer.py: `TransformerConfig`, the
training forward of `TransformerLM` (`apply_hidden`, `loss`, `apply`,
with flash attention and the remat policies), the paged serving trio
(`init_block_pool`, `prefill_paged`, `decode_step_paged`) with
`init_params`, `serving_params` and the tied `head`,
`lm_train_matmul_flops_per_token` and `tp_shard_gather`. Same
architecture: pre-LayerNorm residual blocks, GELU MLP (the tanh
approximation, which is what `jax.nn.gelu` computes by default),
learned positional embedding, output head tied to the embedding.

The parameter tree keeps the JAX package's names, shapes and layouts,
so weights carry across unchanged (models/convert.py): `Linear`
weights are `(in, out)`; `blocks` holds `wq, wk, wv, wo, bq, bk, bv,
bo, ln1_g, ln1_b, ln2_g, ln2_b, w1, b1, w2, b2`, stacked `(L, ...)`;
top-level leaves are `embed`, `pos`, `lnf_g`, `lnf_b` (and `head` when
the embedding is untied). As in the JAX package the model object holds
the configuration and the methods take the parameters as an argument,
so one model serves any number of weight sets.

The dense-cache decode trio (`init_cache`, `prefill`, `decode_step`)
keeps one (B, H, max_len, D) key and value cache a layer and a clock a
row (ops/kv_cache.py's dense half): `prefill` runs the right-padded
prompt through `flash_attention` (the forward kernel on the card) and
writes each layer's keys and values; `decode_step` attends one row a
sequence against the cache in plain PyTorch, as the JAX package does in
plain `jnp`. Both take the stacked layout and `serving_params`'.

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

Mixture-of-experts FFNs (`moe_experts > 0`) replace every block's MLP
with the routed experts of parallel/moe.py (Switch top-1, GShard top-2
or expert choice; the expert-stacked leaves `router (L, E, EX)`, `w1
(L, EX, E, F)`, `b1`, `w2`, `b2`); `apply_hidden(with_aux=True)`
returns the summed load-balancing aux and `loss()` adds
`moe_aux_weight · aux`. The parallel variants run on a process mesh
bound by parallel/collectives.bind (the step builders of
parallel/tensor_parallel.py, pipeline.py and moe.py bind it): with
`tp_axis` the block takes column- and row-split weights, with
`tp_identity` before the column-parallel gemms and `tp_reduce` after
the row-parallel ones; with `sp_axis` attention is ring or zigzag
attention (parallel/ring_attention.py) and the positional rows are
this rank's chunk's; with `ep_axis` the experts are split over that
axis. The serving trios refuse MoE and `sp_axis` models as the JAX
package does, and the dense trio `tp_axis` models too. A `tp_axis`
model's paged trio is the tensor-parallel serving
step (serving/tp.py binds the mesh): this rank's pools hold H/tp heads,
wq/wk/wv/w1 arrive split by column, and `tp_shard_gather` rebuilds the
attention output and the FFN hidden whole before the replicated wo/w2
gemms, so every contraction keeps its unsharded extent and the logits
are bitwise the unsharded step's.
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
                                          cached_attention,
                                          gather_block_cache,
                                          init_block_pool,
                                          init_layer_cache, update_cache,
                                          write_decode_blocks,
                                          write_prefill,
                                          write_prompt_blocks)
from bigdl_tpu_torch.ops.paged_decode import paged_decode_attention
from bigdl_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size, tp_identity,
                                                  tp_reduce)
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

Pools = Tuple[Dict[str, torch.Tensor], ...]
Cache = Tuple[Dict[str, torch.Tensor], ...]
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


def _by_row_tiles(op, tile: int, x: torch.Tensor, *args) -> torch.Tensor:
    """op(x, *args), for an op whose rows' bits depend on how many rows
    it is given (a product, a row reduction), over `tile`-row tiles of
    x (its rows a multiple of `tile`), each call one shape, the tiles'
    results joined. One tile is one call."""
    n = x.shape[0]
    if n == tile:
        return op(x, *args)
    return torch.cat([op(x[i:i + tile], *args)
                      for i in range(0, n, tile)])


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=-1, keepdim=True)


def _tiled_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, tile: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """nn/normalization.py `layer_norm`, step for step, with its two row
    means over `tile`-row tiles; the elementwise steps give each element
    the same bits at any row count, so they run over all rows at once."""
    if x.shape[0] == tile:
        return layer_norm(x, weight, bias, eps)
    mu = _by_row_tiles(_row_mean, tile, x)
    var = _by_row_tiles(_row_mean, tile, (x - mu) ** 2)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def tp_shard_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The whole activation from disjoint per-rank column slabs: one
    all-gather over `axis` (parallel/collectives.all_gather), placed on
    the serving path where Megatron's row-parallel all-reduce would sit.
    An all-reduce of PARTIAL gemm sums changes the fp32 accumulation
    order against the unsharded gemm; concatenating disjoint slabs is a
    copy, so the replicated wo/w2 gemm that follows runs over the same
    operands as the unsharded step and gives its bits."""
    return all_gather(x, axis, dim=x.dim() - 1)


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
    # Switch/GShard-MoE FFN: moe_experts > 0 replaces every block's MLP
    # with a routed mixture of moe_experts expert MLPs
    # (parallel/moe.py); the load-balancing aux, summed over layers, is
    # added to .loss() scaled by moe_aux_weight
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # "top_k" (Switch/GShard, capacity dropping) or "expert_choice"
    # (dropless, aux 0, not causally masked — see parallel/moe.py)
    moe_routing: str = "top_k"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {self.remat_policy!r}: expected 'full', "
                "'dots' or 'attn_saved'")
        if self.moe_experts and self.moe_top_k not in (1, 2):
            raise ValueError("moe_top_k must be 1 or 2")
        if self.moe_routing not in ("top_k", "expert_choice"):
            raise ValueError(
                f"moe_routing {self.moe_routing!r}: expected 'top_k' "
                "or 'expert_choice'")
        if (self.moe_experts and self.moe_routing == "expert_choice"
                and self.causal):
            # expert-choice routing selects tokens per expert over the
            # whole sequence: at train time an expert's choice for
            # position t depends on tokens after t
            import logging

            logging.getLogger("bigdl_tpu_torch.models").warning(
                "moe_routing='expert_choice' with causal=True: "
                "expert-choice token selection reads the full sequence, "
                "leaking future tokens into the routing decision at "
                "train time; causal-LM eval/teacher-forcing metrics may "
                "be optimistic (see parallel/moe.py)")
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

    `sp_axis`: attention runs as ring attention over that mesh axis,
    on this rank's sequence chunk (positional rows offset by the
    chunk's global position); `sp_mode` "ring" (contiguous chunks) or
    "zigzag" (the causal load-balanced layout: callers feed tokens and
    targets permuted into it, as make_transformer_train_step does).
    `tp_axis`: the Megatron split (parallel/tensor_parallel.py).
    `ep_axis`: the MoE experts split over that axis (parallel/moe.py).
    Each needs its mesh bound (parallel/collectives.bind)."""

    def __init__(self, config: TransformerConfig,
                 device: DeviceLike = None,
                 sp_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 sp_mode: str = "ring",
                 ep_axis: Optional[str] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.cfg = config
        self.device = resolve_device(device)
        self.sp_axis = sp_axis
        self.tp_axis = tp_axis
        self.attn_impl = attn_impl
        self.ep_axis = ep_axis
        if ep_axis is not None and not config.moe_experts:
            raise ValueError("ep_axis requires moe_experts > 0")
        if sp_mode not in ("ring", "zigzag"):
            raise ValueError(f"sp_mode must be ring|zigzag, got {sp_mode}")
        if sp_mode == "zigzag" and not config.causal:
            raise ValueError("zigzag sp_mode requires a causal model")
        self.sp_mode = sp_mode
        self._moe = None
        if config.moe_experts:
            if tp_axis is not None:
                raise NotImplementedError(
                    "MoE FFN under tensor parallelism (expert "
                    "parallelism shards experts instead; see "
                    "parallel/moe.py)")
            from bigdl_tpu_torch.parallel.moe import MoE

            # routing/dispatch only; its params are the per-layer
            # slices of the stacked block weights
            self._moe = MoE(config.dim, config.dim * config.mlp_ratio,
                            config.moe_experts,
                            capacity_factor=config.moe_capacity_factor,
                            top_k=config.moe_top_k,
                            routing=config.moe_routing,
                            expert_axis=ep_axis, name="moe_ffn")
        self.head_dim = config.dim // config.num_heads
        # per-layer routing records of the last MoE forward
        self.moe_routes = []

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
        }
        if c.moe_experts:
            ex = c.moe_experts
            blocks.update({
                "router": norm((n, e, ex), e),
                "w1": norm((n, ex, e, f), e), "b1": torch.zeros(n, ex, f),
                "w2": norm((n, ex, f, e), f), "b2": torch.zeros(n, ex, e),
            })
        else:
            blocks.update({
                "w1": norm((n, e, f), e), "b1": torch.zeros(n, f),
                "w2": norm((n, f, e), f), "b2": torch.zeros(n, e),
            })
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

    def _dense_ffn(self, y: torch.Tensor, bp: Dict[str, torch.Tensor],
                   mm=torch.matmul) -> torch.Tensor:
        """The dense FFN, its products through `mm` (the decode step's
        row tiles). On the serving path of a `tp_axis` model (w1/b1
        split by column) the GELU hidden is this rank's slab, gathered
        whole before the replicated w2 gemm; the training block has its
        own tp branch and never comes here with one."""
        y = F.gelu(mm(y, _deq(bp["w1"])) + bp["b1"], approximate="tanh")
        if self.tp_axis is not None:
            y = tp_shard_gather(y, self.tp_axis)
        return mm(y, _deq(bp["w2"])) + bp["b2"]

    # ---------------------------------------------------------- training
    def _attention(self, q, k, v):
        from bigdl_tpu_torch.parallel.ring_attention import (
            ring_attention, zigzag_ring_attention)

        if self.sp_axis is not None:
            if self.sp_mode == "zigzag":
                return zigzag_ring_attention(q, k, v, axis=self.sp_axis)
            return ring_attention(q, k, v, axis=self.sp_axis,
                                  causal=self.cfg.causal)
        return flash_attention(q, k, v, causal=self.cfg.causal,
                               impl=self.attn_impl)

    def _block(self, x: torch.Tensor, bp: Dict[str, torch.Tensor],
               masks: Tuple[Optional[torch.Tensor], ...],
               remat_mlp: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One pre-LN block → (x, MoE aux); `masks` are the block's two
        dropout multipliers (None: no dropout). With `tp_axis` the
        column-split wq/wk/wv/w1 and row-split wo/w2 of this rank
        arrive (the local head count comes from wq's shape) and each
        row-parallel gemm is followed by `tp_reduce`. remat_mlp=True
        (the "attn_saved" policy) checkpoints ONLY the FFN half: the
        attention half runs outside any checkpoint, so the flash
        forward's saved tensors stay and the backward does not re-run
        the forward kernel."""
        b, s, _ = x.shape
        d = self.head_dim
        h = bp["wq"].shape[-1] // d
        y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        if self.tp_axis is not None:
            y = tp_identity(y, self.tp_axis)
        q = self._split_heads(y @ bp["wq"] + bp["bq"], h)
        k = self._split_heads(y @ bp["wk"] + bp["bk"], h)
        v = self._split_heads(y @ bp["wv"] + bp["bv"], h)
        a = self._attention(q, k, v)
        a = a.transpose(1, 2).reshape(b, s, h * d) @ bp["wo"]
        if self.tp_axis is not None:
            a = tp_reduce(a, self.tp_axis)   # row-parallel partial sums
        a = a + bp["bo"]
        if masks[0] is not None:
            a = a * masks[0]
        x = x + a

        def ffn(xres):
            y = layer_norm(xres, bp["ln2_g"], bp["ln2_b"])
            aux = y.new_zeros((), dtype=torch.float32)
            if self._moe is not None:
                moe_p = {k: bp[k] for k in ("router", "w1", "b1", "w2",
                                            "b2")}
                (y, aux), _ = self._moe.apply({"params": moe_p}, y)
            elif self.tp_axis is not None:
                y = tp_identity(y, self.tp_axis)
                y = F.gelu(y @ bp["w1"] + bp["b1"], approximate="tanh")
                y = tp_reduce(y @ bp["w2"], self.tp_axis) + bp["b2"]
            else:
                y = self._dense_ffn(y, bp)
            return (y if masks[1] is None else y * masks[1]), aux

        y, aux = _remat(ffn, x) if remat_mlp else ffn(x)
        return x + y, aux

    def _positions(self, p: Dict[str, Any], s: int) -> torch.Tensor:
        """The positional rows of this rank's (B, s) tokens: the first s
        rows, or under `sp_axis` the rows of this rank's sequence chunk
        (contiguous, or its two zigzag half-chunks)."""
        if self.sp_axis is None:
            return p["pos"][:s]
        n, my = axis_size(self.sp_axis), axis_index(self.sp_axis)
        if self.sp_mode == "zigzag":
            from bigdl_tpu_torch.parallel.ring_attention import \
                zigzag_positions

            if s % 2:
                raise ValueError(
                    f"zigzag sp_mode needs an even local sequence "
                    f"length, got {s}")
            return p["pos"][zigzag_positions(n, s)[my].to(
                p["pos"].device)]
        return p["pos"][my * s:(my + 1) * s]

    def apply_hidden(self, variables: Dict[str, Any], tokens: torch.Tensor,
                     training: bool = False,
                     rng: Optional[torch.Generator] = None,
                     with_aux: bool = False):
        """Forward up to the final LayerNorm: (B, S) int → (B, S, E);
        `with_aux=True` also returns the summed MoE load-balancing aux
        (0.0 for dense configs). The training hot path: pair
        with `head(variables)` and
        `ops.losses.softmax_cross_entropy_chunked`, so (B, S, V) is
        never held."""
        c = self.cfg
        p = self._params(variables)
        s = tokens.shape[-1]
        x = p["embed"][tokens.long()] + self._positions(p, s)
        drop = training and c.dropout > 0.0
        if drop and rng is None:
            raise ValueError(f"{self.name}: dropout needs rng in training")
        blocks = p["blocks"]
        names = list(blocks)
        layers = [dict(zip(names, vals)) for vals in
                  zip(*(blocks[n].unbind(0) for n in names))]
        remat = c.remat_policy if c.remat else None
        self.moe_routes = []
        aux = x.new_zeros((), dtype=torch.float32)
        for bp in layers:
            masks = ((_dropout_mask(x.shape, 1.0 - c.dropout, x, rng),
                      _dropout_mask(x.shape, 1.0 - c.dropout, x, rng))
                     if drop else (None, None))
            if remat in ("full", "dots"):
                x, a = _remat(functools.partial(self._block, masks=masks),
                              x, bp, policy=remat)
            else:
                x, a = self._block(x, bp, masks,
                                   remat_mlp=remat == "attn_saved")
            aux = aux + a
            if self._moe is not None:
                self.moe_routes.append(self._moe.last_route)
        h = layer_norm(x, p["lnf_g"], p["lnf_b"])
        return (h, aux) if with_aux else h

    def loss(self, variables: Dict[str, Any], tokens: torch.Tensor,
             targets: torch.Tensor, training: bool = False,
             rng: Optional[torch.Generator] = None,
             chunk: int = 256) -> torch.Tensor:
        """Fused mean-NLL training loss — never holds (B, S, V)
        log-probs (ops/losses.softmax_cross_entropy_chunked)."""
        from bigdl_tpu_torch.ops.losses import softmax_cross_entropy_chunked

        hidden, aux = self.apply_hidden(variables, tokens,
                                        training=training, rng=rng,
                                        with_aux=True)
        nll = softmax_cross_entropy_chunked(hidden, self.head(variables),
                                            targets, chunk=chunk)
        if self.cfg.moe_experts:
            return nll + self.cfg.moe_aux_weight * aux
        return nll

    def apply(self, variables: Dict[str, Any], tokens: torch.Tensor,
              training: bool = False,
              rng: Optional[torch.Generator] = None):
        """(log-probs (B, S, V), state) — the reference-parity
        LogSoftMax output for evaluation and prediction."""
        x = self.apply_hidden(variables, tokens, training=training,
                              rng=rng)
        logits = x @ self.head(variables)
        return torch.log_softmax(logits, dim=-1), variables.get("state", {})

    # ------------------------------------------------------- dense KV
    def _serving_guard(self, tp_ok: bool = False) -> None:
        """`tp_ok=True` on the paged trio, which is tp-aware
        (serving/tp.py); the dense-cache trio runs single-mesh."""
        if self.sp_axis is not None \
                or (self.tp_axis is not None and not tp_ok):
            raise NotImplementedError(
                "incremental decode runs single-mesh (no sp axis; tp "
                "only on the paged trio via serving/tp.py); build a "
                "plain TransformerLM for dense-cache serving")
        if self.cfg.moe_experts:
            raise NotImplementedError(
                "incremental decode for MoE FFNs (routing is per-token; "
                "not wired yet)")
        if not self.cfg.causal:
            raise ValueError("incremental decode requires causal=True")

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Cache:
        """Per-layer KV cache: a tuple of L dicts {'k', 'v'}, each
        (B, H, S, D) zeros, S = `max_len` (default the positional
        table's length; more raises). `dtype` may be bf16 (half the
        cache bytes; scores still accumulate in fp32). On `device`
        (None: the model's; `utils/device.resolve_device`)."""
        self._serving_guard()
        c = self.cfg
        s = c.max_len if max_len is None else max_len
        if s > c.max_len:
            raise ValueError(f"cache max_len {s} > positional table "
                             f"{c.max_len}")
        dev = self.device if device is None else resolve_device(device)
        return tuple(
            dict(zip(("k", "v"), init_layer_cache(
                batch, c.num_heads, s, self.head_dim, dtype, dev)))
            for _ in range(c.num_layers))

    def prefill(self, variables: Dict[str, Any], tokens: torch.Tensor,
                cache: Cache, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Fill cache positions [0, S_p) from a right-padded prompt
        batch tokens (B, S_p) and return (logits (B, V) of each row's
        last real token, cache). `lengths` (B,) int: the real prompt
        lengths (default: all S_p). Causal attention makes positions
        below a row's length independent of the padding after them; the
        keys and values the pad positions write are never read (decode
        masks past the row clock, then overwrites them). Attention is
        `flash_attention(causal=True, impl=self.attn_impl)`: the forward
        kernel on CUDA tensors. The cache is written in place and
        returned (the JAX method returns a new one)."""
        self._serving_guard()
        c = self.cfg
        p = self._params(variables)
        bsz, s = tokens.shape
        if s > c.max_len:
            raise ValueError(f"prompt length {s} > positional table "
                             f"{c.max_len}")
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((bsz,), s, dtype=torch.long, device=dev)
        d = self.head_dim
        x = p["embed"][tokens.long()] + p["pos"][:s]
        for bp, lc in zip(self._layer_blocks(p), cache):
            y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
            q = self._split_heads(y @ bp["wq"] + bp["bq"], c.num_heads)
            k = self._split_heads(y @ bp["wk"] + bp["bk"], c.num_heads)
            v = self._split_heads(y @ bp["wv"] + bp["bv"], c.num_heads)
            write_prefill(lc["k"], lc["v"], k, v)
            a = flash_attention(q, k, v, causal=True, impl=self.attn_impl)
            a = a.transpose(1, 2).reshape(bsz, s, c.num_heads * d)
            x = x + a @ bp["wo"] + bp["bo"]
            x = x + self._dense_ffn(
                layer_norm(x, bp["ln2_g"], bp["ln2_b"]), bp)
        h = layer_norm(x, p["lnf_g"], p["lnf_b"])
        rows = torch.arange(bsz, device=dev)
        last = h[rows, lengths.long().to(dev) - 1]
        return last @ self.head(p), cache

    def decode_step(self, variables: Dict[str, Any], tokens: torch.Tensor,
                    pos: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One incremental step: tokens (B,) the current token per row,
        written at the row clocks `pos` (B,) int, attended against the
        cache (`ops/kv_cache.cached_attention`, plain PyTorch: the JAX
        step is plain `jnp`, no kernel). Returns (logits (B, V) for the
        NEXT token, cache), the cache written in place. Every op is per
        row, so a non-finite row contaminates only its own logits and
        cache rows; value rows past a clock are zeroed before the
        weighted sum, so a recycled slot's leftovers cannot leak. A
        clock at or past the table's end reads the last positional row
        and writes the cache's last slot, as the JAX step's gather and
        `dynamic_update_slice` clamp them (on the device, no host
        read); the attention mask keeps the raw clock."""
        self._serving_guard()
        c = self.cfg
        p = self._params(variables)
        bsz = tokens.shape[0]
        d = self.head_dim
        n = p["pos"].shape[0]
        pos_l = pos.long()
        # JAX's gather: a negative index counts from the end, then clamps
        row = torch.where(pos_l < 0, pos_l + n, pos_l).clamp(0, n - 1)
        x = p["embed"][tokens.long()] + p["pos"][row]         # (B, E)
        for bp, lc in zip(self._layer_blocks(p), cache):
            y = layer_norm(x, bp["ln1_g"], bp["ln1_b"])[:, None, :]
            q = self._split_heads(y @ bp["wq"] + bp["bq"], c.num_heads)
            k = self._split_heads(y @ bp["wk"] + bp["bk"], c.num_heads)
            v = self._split_heads(y @ bp["wv"] + bp["bv"], c.num_heads)
            update_cache(lc["k"], lc["v"], k, v, pos)
            a = cached_attention(q, lc["k"], lc["v"], pos)   # (B, H, 1, D)
            a = a.reshape(bsz, c.num_heads * d)
            x = x + a @ bp["wo"] + bp["bo"]
            x = x + self._dense_ffn(
                layer_norm(x, bp["ln2_g"], bp["ln2_b"]), bp)
        h = layer_norm(x, p["lnf_g"], p["lnf_b"])
        return h @ self.head(p), cache

    # ------------------------------------------------------- paged KV
    def init_block_pool(self, num_blocks: int, block_size: int,
                        dtype: torch.dtype = torch.float32) -> Pools:
        """Per-layer paged KV pools on the model's device: a tuple of L
        dicts {'k', 'v'}, each (num_blocks, H, block_size, D). Block 0
        is the reserved scratch block (ops/kv_cache.py). A `tp_axis`
        model (under the mesh serving/tp.py binds) holds this rank's
        heads only: (num_blocks, H/tp, block_size, D)."""
        self._serving_guard(tp_ok=True)
        c = self.cfg
        heads = c.num_heads
        if self.tp_axis is not None:
            tp = axis_size(self.tp_axis)
            if heads % tp:
                raise ValueError(f"num_heads {heads} not divisible by the "
                                 f"{self.tp_axis!r} axis size {tp}")
            heads //= tp
        return tuple(
            dict(zip(("k", "v"), init_block_pool(
                num_blocks, heads, block_size, self.head_dim,
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
        (ops/kv_cache.py). With `tp_axis` each rank writes and attends
        its own heads through the same (replicated) table, and
        `tp_shard_gather` rebuilds the attention output before wo."""
        self._serving_guard(tp_ok=True)
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
            if self.tp_axis is not None:
                a = tp_shard_gather(a, self.tp_axis)
            x = x + a @ _deq(bp["wo"]) + bp["bo"]
            x = x + self._dense_ffn(
                layer_norm(x, bp["ln2_g"], bp["ln2_b"]), bp)
        return pools

    def decode_step_paged(self, variables: Dict[str, Any],
                          tokens: torch.Tensor, pos: torch.Tensor,
                          pools: Pools, table: torch.Tensor,
                          attn_impl: Optional[str] = None,
                          row_tile: Optional[int] = None
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
        "torch" explicitly. With `tp_axis` each rank attends its H/tp
        heads against its own pools (the kernel's split plan depends
        on the table width and block size, never on H, so each (row,
        head) runs the same CTAs at H and at H/tp) and
        `tp_shard_gather` rebuilds the attention output before wo.

        `row_tile` (the rows a multiple of it; None: all of them) is
        the row count of every computation whose rows' bits depend on
        how many rows it is given: the products and the layer norms'
        row means run over tiles of exactly that many rows (elementwise
        steps, over all rows at once, give each element the same bits
        at any row count). cuBLAS (and oneDNN on the CPU) pick a
        product's algorithm, and ATen a reduction's launch shape, and so
        a row's summation order, from the problem's shape: at the 43M
        widths on an H100 no row decoded among 8 matched its copy among
        32. With one tile shape a row's logits do not depend on how many
        rows the call holds. A serving engine passes its slot count, so
        its own step is one tile and a speculative verify pass of
        slots·(k+1) rows runs k+1 tiles of the same shape. Attention
        needs no tiles: the kernel's split plan depends on the table
        width and block size, never on the row count."""
        self._serving_guard(tp_ok=True)
        p = self._params(variables)
        bsz = tokens.shape[0]
        tile = bsz if row_tile is None else row_tile
        if bsz % tile:
            raise ValueError(f"decode_step_paged: {bsz} rows are not a "
                             f"multiple of row_tile {tile}")
        d = self.head_dim
        bs = pools[0]["k"].shape[2]
        pos_l = pos.long()
        rows = torch.arange(bsz, device=tokens.device)
        block_ids = table.long()[rows, pos_l // bs]          # (B,)
        offsets = pos_l % bs

        def mm(a, w):
            return _by_row_tiles(torch.matmul, tile, a, w)

        def ln(a, g, b):
            return _tiled_layer_norm(a, g, b, tile)

        x = _embed_rows(p["embed"], tokens.long()) + p["pos"][pos_l]
        for bp, pl in zip(self._layer_blocks(p), pools):
            h = bp["wq"].shape[-1] // d
            y = ln(x, bp["ln1_g"], bp["ln1_b"])[:, None, :]
            # (B, h, 1, D)
            q = self._split_heads(mm(y, _deq(bp["wq"])) + bp["bq"], h)
            k = self._split_heads(mm(y, _deq(bp["wk"])) + bp["bk"], h)
            v = self._split_heads(mm(y, _deq(bp["wv"])) + bp["bv"], h)
            write_decode_blocks(pl["k"], pl["v"], k, v, block_ids,
                                offsets)
            a = paged_decode_attention(q.contiguous(), pl["k"], pl["v"],
                                       table, pos, impl=attn_impl)
            a = a.reshape(bsz, h * d)
            if self.tp_axis is not None:
                a = tp_shard_gather(a, self.tp_axis)
            x = x + mm(a, _deq(bp["wo"])) + bp["bo"]
            x = x + self._dense_ffn(ln(x, bp["ln2_g"], bp["ln2_b"]), bp, mm)
        hid = ln(x, p["lnf_g"], p["lnf_b"])
        return mm(hid, self.head(p)), pools


def build_lm(vocab_size: int = 256, dim: int = 128, num_heads: int = 4,
             num_layers: int = 2, max_len: int = 512,
             **kw) -> TransformerLM:
    """A TransformerLM of the given sizes; `kw` goes to TransformerLM
    (`device`, the parallel axes, `attn_impl`, `name`)."""
    return TransformerLM(TransformerConfig(
        vocab_size=vocab_size, dim=dim, num_heads=num_heads,
        num_layers=num_layers, max_len=max_len), **kw)


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
