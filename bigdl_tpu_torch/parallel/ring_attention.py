"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

Ports bigdl_tpu/parallel/ring_attention.py (no reference counterpart:
the reference's sequence stack is single-node BPTT). The sequence axis
of attention is split over a mesh axis (`seq`); each rank is a process
holding its chunk, and the chunks travel between ranks through the
differentiable collectives of parallel/collectives.py.

* `ring_attention(q, k, v, axis)` — each rank keeps its Q chunk and
  streams the KV chunks around the ring with `ppermute`, merging each
  hop's statistics with an online (running max / running sum) softmax,
  the outer loop of flash attention with the chunks on different ranks.
  The hop's scores are a plain einsum in fp32 accumulation, as in the
  JAX package (its `_chunk_stats` is an einsum too, not a Pallas
  kernel). The backward of `ppermute` is the reverse shift, so autograd
  derives the ring backward.
* `zigzag_ring_attention(q, k, v, axis)` — the load-balanced causal
  ring: rank i holds half-chunks i and 2n-1-i, so every hop after the
  first computes exactly two unmasked half-blocks on every rank. The
  JAX package selects the hop's case with `lax.switch` on traced
  indices; each rank runs its own program here, so the case is a
  Python branch on the rank's `src` against its own coordinate.
* `ulysses_attention(q, k, v, axis)` — `all_to_all` swaps the split
  from sequence to heads, `ops.flash_attention` runs over the full
  sequence (the flash kernels K2/K3 on CUDA tensors), and a second
  `all_to_all` swaps back. Needs num_heads % axis size == 0.

Causality across chunks uses global positions: -1e30 masks a score
whose key lies after its query, and a fully masked row (its running
max still -1e30) gets zero weight instead of exp(0).

`make_ring_attention(mesh, ...)` is the counterpart of the JAX jitted
wrapper: it takes global (B, H, S, D) tensors that every rank holds
alike, runs this rank's chunk (zigzag-permuted in that mode) and
returns the global output, all-gathered. Its input slice and output
gather are conjugate autograd functions (the slice's backward gathers,
the gather's backward slices), so gradients of the global inputs come
out whole and equal on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.parallel.collectives import (all_to_all, axis_index,
                                                  axis_size, bind,
                                                  ppermute)

__all__ = ["ring_attention", "zigzag_positions", "zigzag_order",
           "zigzag_ring_attention", "ulysses_attention",
           "make_ring_attention"]

_NEG_INF = -1e30


def _chunk_stats(q, k, v, sm_scale, q_off, k_off, causal):
    """Unnormalized attention of a Q chunk against one KV chunk.

    q: (B, H, Sq, D), k/v: (B, H, Sk, D); q_off/k_off are the chunks'
    global sequence offsets — ints for contiguous chunks, or (Sq,)/(Sk,)
    position tensors for non-contiguous layouts (zigzag).
    Returns (o_unnorm (B,H,Sq,D) fp32, m (B,H,Sq), l (B,H,Sq)).
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        dev = s.device
        qpos = (q_off.to(dev)[:, None] if torch.is_tensor(q_off) else
                q_off + torch.arange(sq, device=dev)[:, None])
        kpos = (k_off.to(dev)[None, :] if torch.is_tensor(k_off) else
                k_off + torch.arange(sk, device=dev)[None, :])
        s = torch.where(kpos <= qpos, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)                                    # (B,H,Sq)
    p = torch.exp(s - m[..., None])
    # fully-masked rows: m == -1e30 → p would be exp(0) = 1; zero them
    alive = (m > _NEG_INF / 2)[..., None]
    p = torch.where(alive, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o.float(), m, l


def _online_combine(acc, m_acc, l_acc, o_i, m_i, l_i):
    """Merge one chunk's (o, m, l) into the running accumulator."""
    m_new = torch.maximum(m_acc, m_i)
    a1 = torch.exp(m_acc - m_new)
    a2 = torch.exp(m_i - m_new)
    acc = acc * a1[..., None] + o_i * a2[..., None]
    l_new = l_acc * a1 + l_i * a2
    return acc, m_new, l_new


def _state0(q, dv):
    return (q.new_zeros(q.shape[:-1] + (dv,), dtype=torch.float32),
            q.new_full(q.shape[:-1], _NEG_INF, dtype=torch.float32),
            q.new_zeros(q.shape[:-1], dtype=torch.float32))


def _finish(state, dtype):
    acc, _, l_acc = state
    safe_l = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return (acc / safe_l[..., None]).to(dtype)


def _hop(kv, axis, last):
    """The next hop's (k, v): one ppermute of the stacked pair."""
    if last:
        return kv
    return ppermute(torch.stack(kv), axis).unbind(0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = "seq", causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over mesh axis `axis` (bound by
    `collectives.bind`). q, k, v: (B, H, S_local, D), this rank's
    contiguous chunk; returns this rank's chunk of the output."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n = axis_size(axis)
    my = axis_index(axis)
    s_local = q.shape[-2]
    state = _state0(q, v.shape[-1])
    kv = (k, v)
    for i in range(n):
        # after i hops the resident KV chunk originated on rank my - i
        src = (my - i) % n
        k_i, v_i = kv
        stats = _chunk_stats(q, k_i, v_i, sm_scale, my * s_local,
                             src * k_i.shape[-2], causal)
        state = _online_combine(*state, *stats)
        kv = _hop(kv, axis, i == n - 1)
    return _finish(state, q.dtype)


def zigzag_positions(n: int, s_local: int) -> List[torch.Tensor]:
    """Global row positions rank i holds under the zigzag layout:
    half-chunks i and 2n-1-i. A list of (s_local,) int64 tensors, one
    per rank."""
    h = s_local // 2
    return [torch.cat([i * h + torch.arange(h),
                       (2 * n - 1 - i) * h + torch.arange(h)])
            for i in range(n)]


def zigzag_order(n: int, s: int) -> torch.Tensor:
    """Global gather order for the zigzag layout over the full sequence
    (every rank's zigzag_positions, concatenated), with the
    divisibility check every entry point needs — the one source of the
    layout for the model's positions, the step's feed permutation and
    the attention wrapper."""
    if s % (2 * n):
        raise ValueError(
            f"zigzag needs sequence length divisible by 2·{n} "
            f"(two half-chunks per device), got {s}")
    return torch.cat(zigzag_positions(n, s // n))


def _attn_diag(qh, kh, vh, sm_scale):
    """A diagonal half-block: causal within the half."""
    h = qh.shape[-2]
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() * sm_scale
    half = torch.arange(h, device=s.device)
    diag = half[:, None] >= half[None, :]
    s = torch.where(diag, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(vh.dtype), vh)
    return o.float(), m, l


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, axis: str = "seq",
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Load-balanced causal ring attention. q, k, v: (B, H, S_local, D)
    in the zigzag layout (rank i holds global rows [i·h, (i+1)·h) ∪
    [(2n−1−i)·h, (2n−i)·h), h = S_local/2). For KV from `src`:

        hi_q · lo_k : fully visible for every (my, src)   — always done
        src < my    : + lo_q · lo_k fully visible
        src > my    : + hi_q · hi_k fully visible
        src == my   : + lo_q·lo_k and hi_q·hi_k, each diagonal
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n = axis_size(axis)
    my = axis_index(axis)
    s_local = q.shape[-2]
    if s_local % 2:
        raise ValueError("zigzag needs an even local sequence length")
    h = s_local // 2
    q_lo, q_hi = q[..., :h, :], q[..., h:, :]
    dv = v.shape[-1]
    lo, hi = _state0(q_lo, dv), _state0(q_hi, dv)

    def full(qh, kh, vh):
        return _chunk_stats(qh, kh, vh, sm_scale, 0, 0, causal=False)

    kv = (k, v)
    for i in range(n):
        src = (my - i) % n
        k_i, v_i = kv
        k_lo, k_hi = k_i[..., :h, :], k_i[..., h:, :]
        v_lo, v_hi = v_i[..., :h, :], v_i[..., h:, :]
        hi = _online_combine(*hi, *full(q_hi, k_lo, v_lo))
        if src < my:
            lo = _online_combine(*lo, *full(q_lo, k_lo, v_lo))
        elif src > my:
            hi = _online_combine(*hi, *full(q_hi, k_hi, v_hi))
        else:
            lo = _online_combine(*lo, *_attn_diag(q_lo, k_lo, v_lo,
                                                  sm_scale))
            hi = _online_combine(*hi, *_attn_diag(q_hi, k_hi, v_hi,
                                                  sm_scale))
        kv = _hop(kv, axis, i == n - 1)
    return torch.cat([_finish(lo, q.dtype), _finish(hi, q.dtype)], dim=-2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = "seq", causal: bool = False,
                      sm_scale: Optional[float] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Ulysses (all-to-all) sequence parallelism. q, k, v: (B, H,
    S_local, D) with H divisible by the axis size: all_to_all → (B,
    H/n, S, D) → ops.flash_attention (global sequence, so the plain
    `causal` flag is exact) → all_to_all back."""
    n = axis_size(axis)
    heads = q.shape[1]
    if heads % n:
        raise ValueError(f"num_heads {heads} not divisible by axis size "
                         f"{n}")
    qg, kg, vg = (all_to_all(x, axis, split_dim=1, concat_dim=2)
                  for x in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal, sm_scale=sm_scale,
                          impl=impl)
    return all_to_all(out, axis, split_dim=2, concat_dim=1)


class _SliceSeq(torch.autograd.Function):
    """This rank's chunk of a global tensor every rank holds alike;
    the backward gathers the chunks' cotangents into the whole."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.args = (group, n)
        s = x.shape[2] // n
        return x[:, :, i * s:(i + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, ct):
        return _gather_seq(ct, *ctx.args), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The global tensor from every rank's chunk; the cotangent is
    replicated, so the backward takes this rank's chunk of it."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.args = (n, i)
        return _gather_seq(x, group, n)

    @staticmethod
    def backward(ctx, ct):
        n, i = ctx.args
        s = ct.shape[2] // n
        return ct[:, :, i * s:(i + 1) * s], None, None, None


def _gather_seq(x, group, n):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def make_ring_attention(mesh, axis: str = "seq", causal: bool = False,
                        mode: str = "ring",
                        impl: Optional[str] = None) -> Callable:
    """(q, k, v) global (B, H, S, D) tensors, every rank holding alike,
    S divisible by the axis size → the global attention output.

    mode: "ring" (contiguous chunks) | "ulysses" (all-to-all) |
    "zigzag" (causal-only load-balanced ring: the wrapper permutes the
    global sequence into the zigzag layout, runs the balanced ring on
    this rank's chunk and undoes the permutation)."""
    if mode not in ("ring", "ulysses", "zigzag"):
        raise ValueError(f"mode must be ring|ulysses|zigzag, got {mode!r}")
    if mode == "zigzag" and not causal:
        raise ValueError("zigzag balancing only applies to causal "
                         "attention; use mode='ring'")
    group, n, i = mesh.groups[axis], mesh.shape[axis], mesh.coord(axis)

    def body(q, k, v):
        if mode == "ring":
            return ring_attention(q, k, v, axis=axis, causal=causal)
        if mode == "zigzag":
            return zigzag_ring_attention(q, k, v, axis=axis)
        return ulysses_attention(q, k, v, axis=axis, causal=causal,
                                 impl=impl)

    def fn(q, k, v):
        if q.shape[2] % n:
            raise ValueError(f"sequence length {q.shape[2]} does not "
                             f"divide by the {axis!r} axis size {n}")
        order = inv = None
        if mode == "zigzag":
            order = zigzag_order(n, q.shape[2]).to(q.device)
            inv = torch.argsort(order)
            q, k, v = q[:, :, order], k[:, :, order], v[:, :, order]
        with bind(mesh):
            if n == 1:
                out = body(q, k, v)
            else:
                out = _GatherSeq.apply(body(*(
                    _SliceSeq.apply(x, group, n, i) for x in (q, k, v))),
                    group, n, i)
        return out if inv is None else out[:, :, inv]

    return fn
