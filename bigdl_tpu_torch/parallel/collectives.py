"""Differentiable collectives over one axis of a process mesh.

No JAX counterpart (like launch.py): the JAX package gets these from
`lax` (`psum`, `pmean`, `ppermute`, `all_to_all`, `axis_index`) and
from the custom VJPs `tp_identity`/`tp_reduce` of
bigdl_tpu/models/transformer.py, all inside `shard_map`, which binds
the mesh's axis names. Here each rank is a process and each collective
is a `torch.autograd.Function` over the process group of one axis
(parallel/mesh.py):

    tp_identity(x, axis)   identity forward, all-reduce backward
                           (Megatron's "f", before column-parallel gemms)
    tp_reduce(x, axis)     all-reduce forward, identity backward
                           (Megatron's "g", after row-parallel gemms)
    psum / pmean           all-reduce (mean) forward and backward — the
                           transpose `lax.psum` has inside shard_map
    ppermute(x, axis, shift)  send to coordinate i + shift, receive
                           from i - shift (`dist.batch_isend_irecv`);
                           the backward is the reverse shift
    all_to_all(x, axis, split_dim, concat_dim)
                           the tiled `lax.all_to_all`: chunk j of
                           `split_dim` goes to coordinate j, the chunks
                           received are concatenated along `concat_dim`
                           in coordinate order; the backward is the
                           inverse exchange
    all_gather(x, axis, dim)  the tiled `lax.all_gather`: every rank's
                           `x` concatenated along `dim` in coordinate
                           order (forward only: the serving path's
                           tp_shard_gather, models/transformer.py)
    axis_index / axis_size this rank's coordinate and the axis size

`tp_reduce` is not `torch.distributed.nn.functional.all_reduce`: that
one's backward is another sum, the "bare psum" that multiplies the
(identical-per-rank) cotangents by the axis size.

An axis is named as in the JAX package (`"model"`, `"seq"`, ...) and
resolved through the mesh bound by `bind(mesh)` — the counterpart of
shard_map's axis binding; the step builders of tensor_parallel.py,
pipeline.py and moe.py bind their mesh around each step. At axis size 1
every collective is the identity: no copy and no launch.

Every rank must run the same collectives in the same order. The
backward of a collective runs where autograd reaches it, so a
computation whose graph differs between ranks (a branch that drops a
received tensor on one rank) deadlocks: the pipeline's tick loop keeps
both sides of its stage masks in the graph (`torch.where`) for that
reason, as the JAX package's SPMD program does by construction.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["bind", "bound_mesh", "axis_size", "axis_index", "tp_identity",
           "tp_reduce", "psum", "pmean", "ppermute", "all_to_all",
           "all_gather", "psum_leaves"]

_BOUND: List = []

Axes = Union[str, Sequence[str]]


@contextlib.contextmanager
def bind(mesh) -> Iterator:
    """Resolve axis names through `mesh` inside this block."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound_mesh():
    if not _BOUND:
        raise RuntimeError(
            "no mesh is bound: call collectives inside "
            "`parallel.collectives.bind(mesh)` (the counterpart of "
            "shard_map), as the parallel step builders do")
    return _BOUND[-1]


def _axis(axis: str) -> Tuple[object, int, int]:
    """(group, size, this rank's coordinate) of a bound mesh axis."""
    mesh = bound_mesh()
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of the bound "
                         f"mesh {mesh.shape}")
    return mesh.groups[axis], mesh.shape[axis], mesh.coords[axis]


def axis_size(axis: str) -> int:
    return _axis(axis)[1]


def axis_index(axis: str) -> int:
    return _axis(axis)[2]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _TpIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


def tp_identity(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Identity forward, sum over `axis` backward: placed where a
    replicated activation enters column-parallel compute, so the
    partial cotangents of the shards are summed before they reach
    replicated params, whose gradients come out full on every shard."""
    group, n, _ = _axis(axis)
    return x if n == 1 else _TpIdentity.apply(x, group)


def tp_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum over `axis` forward, identity backward: the summed
    activation is replicated, so each shard already holds its full
    cotangent."""
    group, n, _ = _axis(axis)
    return x if n == 1 else _TpReduce.apply(x, group)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    for a in _axes(axes):
        group, n, _ = _axis(a)
        if n > 1:
            x = _Psum.apply(x, group)
    return x


def pmean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    n = 1
    for a in _axes(axes):
        n *= axis_size(a)
    return x if n == 1 else psum(x, axes) / n


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _shift(x: torch.Tensor, group, n: int, i: int,
           shift: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out, _global(group, (i - shift) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, shift):
        ctx.args = (group, n, i, shift)
        return _shift(x, group, n, i, shift)

    @staticmethod
    def backward(ctx, ct):
        group, n, i, shift = ctx.args
        return _shift(ct, group, n, i, -shift), None, None, None, None


def ppermute(x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """`lax.ppermute` with perm [(j, (j + shift) % n)]: this rank's `x`
    goes to coordinate i + shift, the result is what i - shift sent."""
    group, n, i = _axis(axis)
    return x if n == 1 else _Ppermute.apply(x, group, n, i, shift)


def _exchange(x: torch.Tensor, group, n: int, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide by the axis size {n}")
    send = torch.stack(torch.tensor_split(x, n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, split_dim, concat_dim)
        return _exchange(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, ct):
        group, n, split_dim, concat_dim = ctx.args
        return (_exchange(ct, group, n, concat_dim, split_dim), None, None,
                None, None)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled `lax.all_to_all(x, axis, split_dim, concat_dim)`."""
    group, n, _ = _axis(axis)
    split_dim %= x.dim()
    concat_dim %= x.dim()
    return x if n == 1 else _AllToAll.apply(x, group, n, split_dim,
                                            concat_dim)


@torch.no_grad()
def all_gather(x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """The tiled `lax.all_gather(x, axis, axis=dim, tiled=True)`: the
    ranks' `x` (same shape on each) concatenated along `dim` in
    coordinate order. Disjoint shards come back as the whole array bit
    for bit: a copy, no arithmetic."""
    group, n, _ = _axis(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def psum_leaves(leaves: Sequence[torch.Tensor], axes: Axes,
                mean: bool = False) -> None:
    """Sum (or average) a list of tensors over `axes` in place, one
    all-reduce of their concatenation per axis — the gradient
    reduction of the step builders (not differentiable)."""
    leaves = list(leaves)
    for a in _axes(axes):
        group, n, _ = _axis(a)
        if n == 1 or not leaves:
            continue
        flat = torch.cat([t.reshape(-1) for t in leaves])
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= n
        for t, part in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(part.view_as(t))
