"""KV-cache primitives for incremental decode.

Ports bigdl_tpu/ops/kv_cache.py: the dense per-layer cache
(`init_layer_cache`, `write_prefill`, `update_cache`,
`cached_attention`; `nn.MultiHeadAttention`'s decode path) and the
paged pools of the serving engine (`init_block_pool` through
`paged_attention`). Both are plain PyTorch, as the JAX package computes
them outside any Pallas kernel; the paged read has a CUDA kernel of
its own (ops/paged_decode.py).

Dense layout: (B, H, max_len, D) keys and values a layer, one clock a
row; a read attends to positions <= the row's clock.

Paged layout: one preallocated `(num_blocks, H, block_size, D)` pool per
layer for keys and one for values. A sequence's cache is a BLOCK TABLE
— a row of pool indices — so eviction and prefix sharing are integer
surgery on the table (serving/kv_pool.py, serving/prefix_cache.py),
never a cache copy. Block 0 is RESERVED as the scratch block: unused
table entries point at it, inactive batch rows write their garbage
into it, and no reader ever sees it unmasked.

Numerics, as in the JAX package: fp32 scores, masked logits at -1e30
applied AFTER the q·k dot (which also launders NaN scores a poisoned
masked key would produce), softmax in fp32, value rows outside the
row's `valid` region zeroed before the weighted sum (0.0 * NaN would
otherwise be NaN), output cast to the q dtype.

Every attention read spans the FULL gathered table extent with
per-query masking, so the reduction shapes — and with them the fp32
accumulation order — do not depend on where a position was computed:
a KV row written by a cold prefill and by a warm suffix prefill after
a prefix hit is the same tensor bit for bit (the warm == cold promise
of the prefix cache, pinned inside the port by
tests/test_torch_transformer_serving.py).

The writes update the caches and pools IN PLACE (`index_put_`) and
return them: the JAX step donates its buffers and gets new ones back,
the port saves the copy. Callers that need the old content clone
first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


# --------------------------------------------------------------- dense
def init_layer_cache(batch: int, num_heads: int, max_len: int,
                     head_dim: int, dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's (k, v) cache, each (B, H, max_len, D), zero-filled.
    Zeros are safe: reads mask every position past the row's clock."""
    shape = (batch, num_heads, max_len, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def write_prefill(k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a prompt's (B, H, S_p, D) keys/values at [start, start +
    S_p) of every row, in place."""
    end = start + k_new.shape[2]
    k_cache[:, :, start:end] = k_new.to(k_cache.dtype)
    v_cache[:, :, start:end] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's (B, H, 1, D) keys/values at per-row
    positions `pos` (B,), in place."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    p = pos.long().to(k_cache.device)
    k_cache[rows, :, p, :] = k_new[:, :, 0, :].to(k_cache.dtype)
    v_cache[rows, :, p, :] = v_new[:, :, 0, :].to(v_cache.dtype)
    return k_cache, v_cache


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One query row a sequence against the dense cache: q (B, H, 1,
    D), caches (B, H, S, D), pos (B,) the row's clock (the index its
    current token was just written at). Attends positions <= pos;
    value rows past the clock are zeroed before the weighted sum, so a
    NaN left there (a poisoned request's leftovers) never rides a
    0-probability into the output. Returns (B, H, 1, D) in q's
    dtype."""
    if q.shape[-2] != 1:
        raise ValueError(f"cached_attention decodes one row, got q "
                         f"length {q.shape[-2]}")
    seq = k_cache.shape[-2]
    visible = (torch.arange(seq, device=q.device)[None, :]
               <= pos.long().to(q.device)[:, None])            # (B, S)
    return block_attention(q, k_cache, v_cache, visible[:, None, :],
                           visible, sm_scale)


# --------------------------------------------------------------- paged
def init_block_pool(num_blocks: int, num_heads: int, block_size: int,
                    head_dim: int, dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's paged (k, v) pool, each (num_blocks, H, block_size,
    D), zero-filled. Block 0 is the scratch block by convention; the
    host allocator (serving/kv_pool.py) never hands it out."""
    shape = (num_blocks, num_heads, block_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def write_prompt_blocks(k_pool: torch.Tensor, v_pool: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        block_ids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one request's prefill keys/values (1, H, S, D) into the
    blocks `block_ids` (nb,), nb = ceil(S / block_size), in place. S
    pads up to nb*block_size with zeros (the pad positions sit beyond
    the row's clock, masked like any garbage). `block_ids` must be
    distinct — the allocator guarantees it."""
    if k_new.shape[0] != 1:
        raise ValueError("write_prompt_blocks writes one request "
                         f"(batch 1), got batch {k_new.shape[0]}")
    nb = block_ids.shape[0]
    _, h, s, d = k_new.shape
    bs = k_pool.shape[2]
    pad = nb * bs - s
    if pad < 0:
        raise ValueError(f"{nb} blocks of {bs} cannot hold {s} tokens")

    def blocked(x, pool):
        x = x[0].to(pool.dtype)                     # (H, S, D)
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        # (H, nb*bs, D) → (nb, H, bs, D): one row per destination block
        return x.reshape(h, nb, bs, d).permute(1, 0, 2, 3)

    ids = block_ids.long()
    k_pool[ids] = blocked(k_new, k_pool)
    v_pool[ids] = blocked(v_new, v_pool)
    return k_pool, v_pool


def write_decode_blocks(k_pool: torch.Tensor, v_pool: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        block_ids: torch.Tensor, offsets: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's (B, H, 1, D) keys/values at per-row
    (block, offset) destinations, in place. Active rows target distinct
    exclusive blocks (copy-on-write: the engine never routes a write at
    a shared block); inactive rows all target the scratch block, whose
    content no reader sees unmasked, so colliding writes there are
    harmless."""
    ids, offs = block_ids.long(), offsets.long()
    k_pool[ids, :, offs, :] = k_new[:, :, 0, :].to(k_pool.dtype)
    v_pool[ids, :, offs, :] = v_new[:, :, 0, :].to(v_pool.dtype)
    return k_pool, v_pool


def gather_block_cache(pool: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Each row's logical cache through its block table: pool
    (N, H, bs, D) gathered by table (B, nb) → (B, H, nb*bs, D). A pure
    gather — values pass through bit for bit."""
    g = pool[table.long()]                          # (B, nb, H, bs, D)
    b, nb, h, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, nb * bs, d)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    visible: torch.Tensor, valid: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Masked attention over a gathered block cache — the shared core
    of paged decode and paged suffix prefill. q (B, H, Q, D), k/v
    (B, H, S, D), `visible` (B, Q, S) bool per-query visibility,
    `valid` (B, S) bool the row's written region: value rows outside
    it are zeroed exactly, so garbage beyond the clock (scratch blocks,
    recycled content, a poisoned former occupant's NaN) never rides a
    0-probability into the weighted sum."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = torch.where(visible[:, None, :, :], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    probs = p / p.sum(dim=-1, keepdim=True)
    vf = torch.where(valid[:, None, :, None], v.float(), 0.0)
    return torch.matmul(probs, vf).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    pos: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """One query row per sequence against the paged pool: q
    (B, H, 1, D), pools (N, H, bs, D), table (B, nb), pos (B,) — the
    row clock, the index the current token was just written at.
    Gathers each row's blocks and attends positions <= pos over the
    full table extent. Returns (B, H, 1, D). This is the plain version
    of the CUDA paged-decode kernel (ops/paged_decode.py)."""
    if q.shape[-2] != 1:
        raise ValueError(f"paged_attention decodes one row, got q "
                         f"length {q.shape[-2]}")
    kc = gather_block_cache(k_pool, table)
    vc = gather_block_cache(v_pool, table)
    seq = kc.shape[-2]
    visible = (torch.arange(seq, device=pos.device)[None, :]
               <= pos.long()[:, None])                      # (B, S)
    return block_attention(q, kc, vc, visible[:, None, :], visible,
                           sm_scale)
