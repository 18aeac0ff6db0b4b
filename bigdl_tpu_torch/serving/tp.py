"""Tensor-parallel serving: one engine's weights and KV pool split over
the `model` axis of a process mesh.

Ports bigdl_tpu/serving/tp.py. `InferenceEngine(model, tp_mesh=mesh)`
serves through the memoized `TPServingLM` wrapper, which duck-types the
paged trio (`init_block_pool`, `prefill_paged`, `decode_step_paged`)
plus `serving_params`, so the engine serves through it unchanged.

The split, per serving layer, is the reference's:

    wq/wk/wv, bq/bk/bv   split by HEAD column (each rank owns H/tp
                         heads end to end)
    KV block pools       split on the head axis: (N, H/tp, bs, D) per
                         rank, 1/tp of the cache; the block TABLE stays
                         host-side and identical on every rank, so the
                         allocator, the radix prefix tree and the
                         copy-on-write caps carry over as they are
    w1/b1                split by FFN column
    wo/w2, everything    replicated; their gemms run over the FULL
    else                 contraction on every rank

Bit identity. Megatron's row-parallel all-reduce of PARTIAL sums would
change the fp32 accumulation order against the unsharded gemm. In its
place `tp_shard_gather` (models/transformer.py) all-gathers the
disjoint column slabs of the attention output and of the FFN hidden
back into the exact arrays the unsharded step holds, and the wo/w2 and
head gemms run replicated over them: the logits, and so the tokens,
are bitwise the unsharded engine's. Head-parallel attention is a batch
split over heads; a column split keeps each output's contraction
extent. On the card each rank runs the paged-decode kernel
(ops/csrc/paged_decode.cu) on its own H/tp heads: its split plan
depends on the table width and the block size, never on H, so each
(row, head) runs the same CTAs at H and at H/tp. cuBLAS picks its
algorithm per shape, so the column gemms' bits at N/tp are the card's
to keep; chip_smoke.py and parallel/multichip.py gate them bitwise.

Lockstep. The JAX engine is one controller over all the mesh's devices.
Here every rank is a process with its own engine, and every host-side
decision must come out the same on every rank, or one rank skips an
all-gather and the group hangs. Requests are submitted identically on
every rank (SPMD). The engine's clock is read the same way on every
rank: rank 0 of the model axis reads it and the others receive its
reading, so deadlines, queue-wait TTLs, shedding, ttft and latency
agree. A step, submit or cancel takes a start reading only if it needs
one (`lockstep_clock`, one broadcast; `run()` takes one for all its
submissions); the decode step's end reading rides on `agree`, the one
all-reduce that also takes the worst of the ranks' watchdog or retry
verdicts, which every rank acts on alike. So a decode step with no
queued request costs one round trip. Both ride a gloo group of their
own over the model axis.

Abandoned gathers. A rank whose step outlives the watchdog budget
leaves its worker thread behind; if a peer stalled before dispatching,
that thread (on the card: the stream behind it) waits in an activation
gather no peer will join. So the wrapper gathers over a group of its
own (a second group over the model axis on the mesh's backend), and on
an agreed watchdog trip `abandon` retires it: the wrapper refuses all
further use and leaves the memo, on NCCL its communicator is aborted
so that the waiting gather returns, and the next engine over the same
(model, mesh, axis) builds a fresh wrapper with fresh groups, which
nothing stale can pair with. On gloo the waiting gather ends with an
error when the peers' groups are destroyed.

Compile contract. The JAX wrapper is memoized so that engines over one
(model, mesh, axis) share its jitted executables (buckets + 1). An
eager port compiles nothing; `tp_serving_model` keeps the memoization
(one wrapper per triple, and the same re-wrap ValueError), not the
contract.

Resharding. A port shard is this rank's slice, not a global array:
`gather_serving_params(params, mesh, axis)` all-gathers a sharded tree
into its host (checkpoint) form, and `shard_serving_params(mesh,
params, axis)` cuts any rank's slices from a host tree, so a tp = 2
tree moves to tp = 4 (or back to one rank) bit for bit.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.collectives import bind
from bigdl_tpu_torch.parallel.param_layout import (gather_tree,
                                                   tp_serving_specs)
from bigdl_tpu_torch.parallel.tensor_parallel import (gather_params,
                                                      shard_params)

__all__ = ["TPServingLM", "tp_serving_model", "tp_serving_specs",
           "gather_serving_params", "shard_serving_params"]


def _is_sharded(params, mesh, axis: str) -> bool:
    """True if `params` (serving layout) already holds this rank's
    column slices on `mesh` (wq narrower than the model width)."""
    tp = mesh.shape[axis]
    blocks = params.get("blocks")
    if tp == 1 or not isinstance(blocks, (tuple, list)) or not blocks:
        return False
    wq = blocks[0]["wq"]
    return wq.shape[-1] * tp == wq.shape[-2]


def gather_serving_params(params, mesh=None, axis: str = "model"):
    """The host (checkpoint) form of a serving-layout tree: every leaf
    a whole numpy array. A tree sharded on `mesh` is all-gathered over
    `axis` first (every rank of the axis must call); an unsharded tree
    (no mesh) is copied off its device. The inverse of
    `shard_serving_params`: the round trip is bitwise across tp
    degrees, since a gather and a slice move values and change none."""
    if mesh is not None and _is_sharded(params, mesh, axis):
        params = gather_params(mesh, tp_serving_specs(params, axis),
                               params)
    return gather_tree(params)


def shard_serving_params(mesh, params, axis: str = "model"):
    """This rank's slices of a host (or unsharded) serving-layout tree
    on `mesh` under the tp serving specs, on the mesh's device — the
    resharding half of the checkpoint round trip."""
    return shard_params(mesh, tp_serving_specs(params, axis), params)


class TPServingLM:
    """The sharded serving backend `InferenceEngine(tp_mesh=...)` runs:
    the paged trio plus `serving_params` over this rank's shards, each
    call inside `collectives.bind(mesh)`.

    Divisibility: `num_heads % tp == 0` (head-parallel attention) and
    `(dim * mlp_ratio) % tp == 0` (the FFN column split). MoE FFNs are
    refused, as in the JAX package."""

    def __init__(self, model, mesh, axis: str = "model"):
        # models/ imports parallel/, whose optimizer imports serving/
        from bigdl_tpu_torch.models.transformer import TransformerLM

        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"(axes: {dict(mesh.shape)})")
        cfg = model.cfg
        tp = int(mesh.shape[axis])
        if cfg.moe_experts:
            raise NotImplementedError(
                "tensor-parallel serving over a MoE FFN (shard experts "
                "with parallel/moe.py instead)")
        if cfg.num_heads % tp:
            raise ValueError(
                f"num_heads {cfg.num_heads} not divisible by tp degree "
                f"{tp} (head-parallel attention shards whole heads)")
        if (cfg.dim * cfg.mlp_ratio) % tp:
            raise ValueError(
                f"ffn hidden {cfg.dim * cfg.mlp_ratio} not divisible "
                f"by tp degree {tp}")
        if mesh.device != model.device:
            raise ValueError(f"mesh device {mesh.device} differs from "
                             f"the model's {model.device}")
        self.model = model
        self.mesh = mesh
        self.axis = axis
        self.tp = tp
        self.cfg = cfg
        self.device = model.device
        # the tp-aware twin: same config, tp_axis armed — its paged
        # trio runs the gather construction under the bound mesh
        self._tp_model = TransformerLM(
            cfg, device=model.device, tp_axis=axis,
            attn_impl=model.attn_impl, name=f"{model.name}_tp{tp}")
        # the activation gathers run on a group of the wrapper's own,
        # bound through a view of the mesh (see "Abandoned gathers");
        # the lockstep channel is a gloo group over the same lines.
        # Every rank creates every line's groups, in the same order, as
        # torch.distributed requires
        self.broken: Optional[str] = None
        self.rendezvous = 0          # lockstep round trips so far
        self._view = mesh
        self._gather = self._ctl = None
        self._ctl_src = 0
        if tp > 1:
            names = list(mesh.shape)
            order = np.arange(mesh.size).reshape(list(mesh.shape.values()))
            lines = [[int(r) for r in line] for line in np.moveaxis(
                order, names.index(axis), -1).reshape(-1, tp)]
            self._gather, _ = dist.new_subgroups_by_enumeration(
                lines, backend=mesh.backend)
            self._ctl, _ = dist.new_subgroups_by_enumeration(
                lines, backend="gloo")
            me = dist.get_rank()
            self._ctl_src = next(line for line in lines if me in line)[0]
            self._view = copy.copy(mesh)
            self._view.groups = {**mesh.groups, axis: self._gather}

    def bound(self):
        """The wrapper's mesh view, bound for its collectives; refused
        once the wrapper is abandoned."""
        if self.broken is not None:
            raise RuntimeError(
                f"this tensor-parallel serving wrapper was abandoned "
                f"({self.broken}): build a new InferenceEngine over the "
                "underlying model and mesh (a fresh wrapper, fresh "
                "groups)")
        return bind(self._view)

    @property
    def variables(self):
        """The wrapped model's variables (the engine's default)."""
        return self.model.variables

    # ------------------------------------------------------ placement
    def serving_params(self, variables):
        """The per-layer serving layout, then this rank's slices of the
        column-split leaves (the rest replicated, copied). A tree that
        already holds this mesh's slices passes through."""
        sp = self.model.serving_params(variables)
        if _is_sharded(sp, self.mesh, self.axis):
            return sp
        return shard_serving_params(self.mesh, sp, self.axis)

    def init_block_pool(self, num_blocks: int, block_size: int,
                        dtype: torch.dtype = torch.float32):
        """This rank's per-layer pools, (num_blocks, H/tp, block_size,
        D) each — 1/tp of the unsharded pool. Block ids and tables are
        host integers, identical across ranks."""
        with self.bound():
            return self._tp_model.init_block_pool(num_blocks, block_size,
                                                  dtype)

    # ------------------------------------------------------ paged trio
    def prefill_paged(self, variables, tokens, pools, table, block_ids,
                      start):
        """Each rank writes its own heads' k/v into its pools through
        the same table; the attention output and the FFN hidden are
        gathered whole before the replicated gemms."""
        with self.bound():
            return self._tp_model.prefill_paged(
                variables, tokens, pools, table, block_ids, start)

    def decode_step_paged(self, variables, tokens, pos, pools, table,
                          attn_impl: Optional[str] = None,
                          row_tile: Optional[int] = None):
        """Per-head attention against this rank's pools (the paged-decode
        kernel on the card), gathers that keep every contraction
        full-extent; the logits come out replicated and bitwise those
        of the unsharded step."""
        with self.bound():
            return self._tp_model.decode_step_paged(
                variables, tokens, pos, pools, table, attn_impl=attn_impl,
                row_tile=row_tile)

    # ------------------------------------------------------- lockstep
    def lockstep_clock(self, clock: Callable[[], float]
                       ) -> Callable[[], float]:
        """`clock` as every rank of the model axis reads it: rank 0
        reads, the others receive its reading. Each call is a
        collective, so the engines call it at the same points."""
        if self._ctl is None:
            return clock

        def read() -> float:
            t = torch.tensor([clock() if dist.get_rank() == self._ctl_src
                              else 0.0], dtype=torch.float64)
            dist.broadcast(t, src=self._ctl_src, group=self._ctl)
            self.rendezvous += 1
            return float(t[0])

        return read

    def agree(self, verdict: int, now: float) -> Tuple[int, float]:
        """(the worst (largest) of the ranks' verdict codes for a step,
        rank 0's clock reading `now`) in one all-reduce, so that every
        rank retries, degrades or goes on alike, and stamps the step's
        tokens with the same time."""
        if self._ctl is None:
            return verdict, now
        t = torch.tensor([float(verdict), now if dist.get_rank()
                          == self._ctl_src else -math.inf],
                         dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._ctl)
        self.rendezvous += 1
        return int(t[0]), float(t[1])

    def abandon(self, reason: str) -> None:
        """Retire the wrapper after an agreed watchdog trip (every rank
        calls it): refuse further use, leave the memo, and on NCCL abort
        the gather group's communicator, so that a gather an abandoned
        worker waits in returns."""
        self.broken = reason
        key = (id(self.model), id(self.mesh), self.axis)
        if _WRAPPERS.get(key) is self:
            del _WRAPPERS[key]
        if self._gather is not None and self.mesh.backend == "nccl":
            abort = getattr(self._gather, "abort", None)
            if abort is None:
                from torch.distributed import distributed_c10d as c10d
                c10d._abort_process_group(self._gather)
            else:
                abort()


# one wrapper per (model, mesh, axis), held for the process (it holds
# its model and mesh, so their ids stay theirs): a wrapper's
# construction creates process groups, a collective every rank must
# make at the same point, so whether one exists must not hang on when
# each rank's garbage collector runs (the JAX package holds them
# weakly: a new wrapper there costs a compile, no collective).
# `TPServingLM.abandon` retires one
_WRAPPERS: Dict[Tuple[int, int, str], TPServingLM] = {}


def tp_serving_model(model, mesh, axis: str = "model") -> TPServingLM:
    """The memoized constructor `InferenceEngine(tp_mesh=...)` goes
    through: one TPServingLM per (model, mesh, axis). A wrapper passed
    again with its own mesh and axis passes through; re-wrapping it
    onto another layout is a configuration error."""
    if isinstance(model, TPServingLM):
        if model.mesh is mesh and model.axis == axis:
            return model
        raise ValueError(
            f"model is already tp-wrapped for (mesh={model.mesh}, "
            f"axis={model.axis!r}); to serve its weights on another "
            "layout, pass the underlying model (wrapper.model)")
    key = (id(model), id(mesh), axis)
    got = _WRAPPERS.get(key)
    if got is None or got.model is not model or got.mesh is not mesh \
            or got.broken is not None:
        got = TPServingLM(model, mesh, axis)
        _WRAPPERS[key] = got
    return got
