"""Data-parallel training plane: ZeRO-1/2 over a process mesh.

Ports bigdl_tpu/parallel/data_parallel.py (reference:
parameters/AllReduceParameter.scala — the reference keeps all weights
in ONE flat vector, splits it into one slice per partition, and per
iteration reduce-scatters the gradients, updates each slice where it
lives and gathers the slices back). The JAX step is one jitted
`shard_map`; here each rank is a process that runs the same step
eagerly on its rows of the global batch:

    grads  = autograd over unflatten(flat_w)      this rank's rows
    g_my   = reduce-scatter(flatten(grads)) / n   this rank's slice
    w_my   = this rank's slice of flat_w
    w_my'  = optim.update(g_my, w_my, slots_my)   slots live sharded (ZeRO-1)
    flat_w'= all-gather(w_my')

`grad_dtype="bfloat16"` (DistriOptimizer's default) is the reference's
FP16CompressedTensor wire: the flat gradient is cut into n chunks, cast
to bf16 and exchanged with `all_to_all_single`, and each rank sums the
chunks it receives in fp32, in rank order, then divides by n — bf16 on
the wire, fp32 accumulation. `grad_dtype=None` is the exact path: an
fp32 `reduce_scatter_tensor`, then / n.

ZeRO-2 (`zero=2`): the fp32 master weights also live sharded — a rank
keeps only its (shard_size,) slice between steps and the step opens
with the all-gather that ZeRO-1 runs at its end. The same bytes move,
and the all-gather of the disjoint slices rebuilds the exact vector, so
a ZeRO-2 step is bit for bit a ZeRO-1 step in fp32.

The collectives are `torch.distributed`'s (NCCL on the card, gloo on
the CPU): `reduce_scatter_tensor`, `all_to_all_single`,
`all_gather_into_tensor`, `all_reduce`. The optimizer step is the port's
own `OptimMethod.update` on the (shard_size,) slice.

A step's signature keeps the JAX package's, with `bx`/`by` this rank's
rows (`mesh.host_to_global`) and `rng` a `torch.Generator` seeded from
(seed, step, rank) — the counterpart of `fold_in(rng, axis_index)`.
Dropout therefore draws differently from the JAX package's; parity
holds at p = 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.ops.losses import build_train_loss
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.parallel.param_layout import FlatParamSpec
from bigdl_tpu_torch.utils.anomaly import health_ok

__all__ = ["FlatParamSpec", "NON_REDUCIBLE_STATE_KEYS", "make_dp_train_step",
           "make_dp_accum_steps", "make_dp_eval_step", "rank_generator"]

NON_REDUCIBLE_STATE_KEYS = frozenset({"num_batches", "step", "counter"})


def rank_generator(device: torch.device, seed: int, step: int,
                   rank: int) -> torch.Generator:
    """The dropout stream of `rank` at `step`: LocalOptimizer's stream
    on rank 0, a stream of its own on every other rank."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step + (rank << 40))


def _all_gather(w_my: torch.Tensor, n: int, group) -> torch.Tensor:
    full = torch.empty(n * w_my.numel(), dtype=w_my.dtype,
                       device=w_my.device)
    dist.all_gather_into_tensor(full, w_my.contiguous(), group=group)
    return full


def _mean_scalar(x: torch.Tensor, n: int, group) -> torch.Tensor:
    x = x.detach().to(torch.float32).reshape(1).clone()
    dist.all_reduce(x, group=group)
    return (x / n)[0]


def _make_scattered_grads(model, criterion, spec: FlatParamSpec, mesh: Mesh,
                          grad_dtype, precision):
    """Local forward/backward on this rank's rows, then the
    reduce-scatter of the flat gradient. Returns (g_my (shard_size,)
    fp32 mean over the global batch, new module state, local loss)."""
    n, group = spec.num_shards, mesh.group
    loss_call = build_train_loss(model, criterion, precision)
    wire = None if grad_dtype is None else getattr(torch, grad_dtype)

    def scattered_grads(flat_w, mod_state, bx, by, rng):
        w = flat_w.detach().requires_grad_(True)
        loss, new_state = loss_call(spec.unflatten(w), mod_state, bx, by,
                                    rng)
        (flat_g,) = torch.autograd.grad(loss, w)
        if wire is not None:
            # the reference's compressed wire with fp32 accumulation:
            # each rank's contribution to each slice crosses as bf16,
            # and the received chunks are summed in fp32, in rank order
            chunks = flat_g.view(n, spec.shard_size).to(wire)
            recv = torch.empty_like(chunks)
            dist.all_to_all_single(recv, chunks, group=group)
            g_my = recv[0].to(torch.float32)
            for i in range(1, n):
                g_my = g_my + recv[i].to(torch.float32)
            g_my = g_my / n
        else:
            g_my = torch.empty(spec.shard_size, dtype=torch.float32,
                               device=flat_g.device)
            dist.reduce_scatter_tensor(g_my, flat_g, group=group)
            g_my = g_my / n
        return g_my, new_state, loss.detach()

    return scattered_grads


def _global_sq(g_my: torch.Tensor, group) -> torch.Tensor:
    """The squared norm of the whole gradient from the disjoint shards."""
    sq = (g_my * g_my).sum().reshape(1)
    dist.all_reduce(sq, group=group)
    return sq[0]


def _clip_shard(g_my, clip_const, clip_norm, group):
    if clip_const is not None:
        g_my = torch.clamp(g_my, clip_const[0], clip_const[1])
    if clip_norm is not None:
        sq = _global_sq(g_my, group)
        scale = torch.clamp(clip_norm / torch.clamp(torch.sqrt(sq),
                                                    min=1e-12), max=1.0)
        g_my = g_my * scale
    return g_my


def _reducible_leaves(tree, non_reducible: bool, out: List):
    """Collect (container, key) of the float leaves `_reduce_state`
    averages. Two opt-outs, as in the JAX package: a key starting with
    '_' exempts its whole subtree; a key in NON_REDUCIBLE_STATE_KEYS
    exempts only a leaf directly under it."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            nr = non_reducible or (isinstance(k, str) and k.startswith("_"))
            _reducible_leaves(v, nr, out)
            continue
        exempt = non_reducible or (isinstance(k, str) and (
            k.startswith("_") or k in NON_REDUCIBLE_STATE_KEYS))
        if (not exempt and isinstance(v, torch.Tensor)
                and v.is_floating_point()):
            out.append((tree, k))


def _thaw(tree):
    """A copy of the containers of `tree` (tuples as lists) whose leaves
    can be replaced in place; `_refreeze` restores the tuples."""
    if isinstance(tree, dict):
        return {k: _thaw(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_thaw(v) for v in tree]
    return tree


def _refreeze(tree, like):
    if isinstance(like, dict):
        return {k: _refreeze(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_refreeze(t, l) for t, l in zip(tree, like))
    return tree


def _reduce_state(new_state, mesh: Mesh, n: int):
    """Batch-dependent float state (BN running statistics) averaged over
    the data axis, so replicated state stays replicated; the exempt
    leaves advance alike on every rank and stay as they are. One
    all-reduce over the concatenated leaves."""
    thawed = _thaw(new_state)
    slots: List = []
    _reducible_leaves(thawed, False, slots)
    if not slots:
        return new_state
    vals = [c[k] for c, k in slots]
    buf = torch.cat([v.detach().reshape(-1).to(torch.float32) for v in vals])
    dist.all_reduce(buf, group=mesh.group)
    buf = buf / n
    off = 0
    for (c, k), v in zip(slots, vals):
        c[k] = buf[off:off + v.numel()].view(v.shape).to(v.dtype)
        off += v.numel()
    return _refreeze(thawed, new_state)


def make_dp_train_step(
    model: Module,
    criterion: Criterion,
    method,
    mesh: Mesh,
    spec: FlatParamSpec,
    axis: str = "data",
    grad_dtype: Optional[str] = "bfloat16",
    clip_const: Optional[Tuple[float, float]] = None,
    clip_norm: Optional[float] = None,
    precision=None,
    health: bool = False,
    zero: int = 1,
) -> Callable:
    """The data-parallel train step.

    Signature: (flat_w, slots, mod_state, bx, by, lr, stepno, rng)
             -> (flat_w', slots', mod_state', mean_loss)

    `flat_w` is the (padded,) fp32 vector (ZeRO-1) or this rank's
    (shard_size,) slice of it (ZeRO-2); `slots` the optim method's slots
    of this rank's slice ({name: [(shard_size,) tensor]}, updated in
    place). With `health=True` the step takes a trailing `max_gnorm`
    and returns `(ok, gnorm)` too — the pre-clip global gradient norm
    and utils/anomaly's predicate, read by the host — and an anomalous
    step returns its inputs untouched."""
    if zero not in (1, 2):
        raise ValueError(f"zero must be 1 or 2, got {zero!r}")
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    n, group, rank = spec.num_shards, mesh.group, mesh.rank
    scattered_grads = _make_scattered_grads(model, criterion, spec, mesh,
                                            grad_dtype, precision)

    def step(flat_w, slots, mod_state, bx, by, lr, stepno, rng,
             max_gnorm=None):
        full = _all_gather(flat_w, n, group) if zero == 2 else flat_w
        g_my, new_state, loss = scattered_grads(full, mod_state, bx, by, rng)
        mean_loss = _mean_scalar(loss, n, group)
        new_state = _reduce_state(new_state, mesh, n)
        if health:
            gnorm = torch.sqrt(_global_sq(g_my, group))
            ok_f, gnorm_f = torch.stack([
                health_ok(mean_loss, gnorm, max_gnorm).to(gnorm.dtype),
                gnorm]).tolist()  # one host read
            ok = bool(ok_f)
            if not ok:
                return flat_w, slots, mod_state, mean_loss, ok, gnorm_f
        g_my = _clip_shard(g_my, clip_const, clip_norm, group)
        with torch.no_grad():
            w_my = (flat_w if zero == 2
                    else spec.shard_slice(flat_w, rank)).clone()
            method.update([g_my], [w_my], slots, lr, stepno)
        new_w = w_my if zero == 2 else _all_gather(w_my, n, group)
        if health:
            return new_w, slots, new_state, mean_loss, ok, gnorm_f
        return new_w, slots, new_state, mean_loss

    return step


def make_dp_accum_steps(
    model: Module,
    criterion: Criterion,
    method,
    mesh: Mesh,
    spec: FlatParamSpec,
    axis: str = "data",
    grad_dtype: Optional[str] = "bfloat16",
    clip_const: Optional[Tuple[float, float]] = None,
    clip_norm: Optional[float] = None,
    precision=None,
    health: bool = False,
    zero: int = 1,
) -> Tuple[Callable, Callable]:
    """Gradient accumulation over the mesh: the accumulator is this
    rank's (shard_size,) slice — micro-steps reduce-scatter, then add.

    micro_fn: (flat_w, g_acc, mod_state, bx, by, rng)
            -> (g_acc', mod_state', mean_loss)
    apply_fn: (flat_w, slots, g_acc, lr, stepno, n_micro)
            -> (flat_w', slots', zeroed g_acc)

    Clipping applies to the mean accumulated gradient at update time.
    With `health=True` micro_fn takes a trailing `max_gnorm` and also
    returns `(ok, gnorm)`; an anomalous micro-gradient is not added and
    the module state keeps its inputs. `zero=2` as in make_dp_train_step.
    """
    if zero not in (1, 2):
        raise ValueError(f"zero must be 1 or 2, got {zero!r}")
    n, group, rank = spec.num_shards, mesh.group, mesh.rank
    scattered_grads = _make_scattered_grads(model, criterion, spec, mesh,
                                            grad_dtype, precision)

    def micro_fn(flat_w, g_acc, mod_state, bx, by, rng, max_gnorm=None):
        full = _all_gather(flat_w, n, group) if zero == 2 else flat_w
        g_my, new_state, loss = scattered_grads(full, mod_state, bx, by, rng)
        mean_loss = _mean_scalar(loss, n, group)
        new_state = _reduce_state(new_state, mesh, n)
        if health:
            gnorm = torch.sqrt(_global_sq(g_my, group))
            ok = bool(health_ok(mean_loss, gnorm, max_gnorm))
            if not ok:
                return g_acc, mod_state, mean_loss, ok, float(gnorm)
            return g_acc + g_my, new_state, mean_loss, ok, float(gnorm)
        return g_acc + g_my, new_state, mean_loss

    def apply_fn(flat_w, slots, g_acc, lr, stepno, n_micro):
        g_my = _clip_shard(g_acc / n_micro, clip_const, clip_norm, group)
        with torch.no_grad():
            w_my = (flat_w if zero == 2
                    else spec.shard_slice(flat_w, rank)).clone()
            method.update([g_my], [w_my], slots, lr, stepno)
        new_w = w_my if zero == 2 else _all_gather(w_my, n, group)
        return new_w, slots, torch.zeros_like(g_acc)

    return micro_fn, apply_fn


def make_dp_eval_step(model: Module, methods, mesh: Mesh,
                      axis: str = "data"):
    """The evaluation step: forward on this rank's rows, then one
    all-reduce of every method's (sum, count) — the reference's
    Evaluator mapPartitions + reduce.

    Signature: (params, mod_state, bx, by, row_mask) -> [(sum, count)]
    `row_mask` is this rank's 0/1 float rows (padded tail rows are 0)."""

    @torch.no_grad()
    def step(params, mod_state, bx, by, row_mask):
        out, _ = model.apply({"params": params, "state": mod_state}, bx,
                             training=False)
        stats = [m.stats(out, by, row_mask) for m in methods]
        buf = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                           device=out.device).reshape(())
                           for s in stats for v in s])
        dist.all_reduce(buf, group=mesh.group)
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(len(methods))]

    return step
