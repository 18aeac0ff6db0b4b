"""Tensor parallelism for the transformer stack — the Megatron split on
a process mesh.

Ports bigdl_tpu/parallel/tensor_parallel.py (no reference counterpart:
the reference's only strategy is data parallelism). The split is the
classic one:

    wq/wk/wv/w1 column-sharded  (each rank owns heads/tp heads and
                                 ffn/tp hidden units — no communication)
    wo/w2       row-sharded      (partial sums → one all-reduce a gemm)
    ln/embed/pos/bo/b2 replicated

`TransformerLM._block` runs this split unchanged with `tp_axis` set:
it reads its local head count from `wq`'s shard and sums after the
row-parallel gemms (`tp_reduce`); `tp_identity` before the
column-parallel ones sums the activation cotangents, so the replicated
leaves' gradients come out whole and equal on every tp rank and no
per-leaf correction is needed.

`transformer_tp_specs` gives the PartitionSpec tree (parallel/mesh.P)
of the stacked parameters; `shard_params` cuts this rank's slice of
each leaf along its spec's split dim; `make_transformer_train_step`
is the dp×tp(×sp) step. Every rank runs the step eagerly on its rows
(data axis) and its sequence chunk (seq axis, contiguous or zigzag),
computes the full-log-softmax loss and its gradients, averages both
over the data and seq axes, and applies the port's
`OptimMethod.update` to its shards in place.

`gather_params` (no JAX counterpart: a JAX array sharded by a spec is
already the global array) all-gathers shards back into the whole
tree, for checkpoints and comparisons.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.models.convert import (tree_leaves,
                                            tree_leaves_with_path,
                                            tree_map, tree_unflatten)
from bigdl_tpu_torch.parallel.collectives import bind, psum_leaves
from bigdl_tpu_torch.parallel.mesh import P

__all__ = ["transformer_tp_specs", "make_transformer_train_step",
           "slot_specs_for", "shard_params", "gather_params"]

# stacked-block leaves: which dim (after the layer axis) carries the shard
_COL = {"wq", "wk", "wv", "w1"}          # shard last dim
_ROW = {"wo", "w2"}                      # shard middle (input) dim
_COL_BIAS = {"bq", "bk", "bv", "b1"}     # shard last dim


def transformer_tp_specs(tp_axis: str = "model",
                         tie_embeddings: bool = True) -> Dict[str, Any]:
    """PartitionSpec tree for TransformerLM params (stacked blocks)."""
    blocks = {}
    for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "bo", "b2"):
        blocks[k] = P()
    for k in _COL:
        blocks[k] = P(None, None, tp_axis)
    for k in _ROW:
        blocks[k] = P(None, tp_axis, None)
    for k in _COL_BIAS:
        blocks[k] = P(None, tp_axis)
    specs = {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "blocks": blocks,
    }
    if not tie_embeddings:
        specs["head"] = P()  # replicated: the loss needs the full vocab
    return specs


def slot_specs_for(method, specs):
    """Optimizer slots are {slot_name: params-like tree}; each slot leaf
    shards like its param."""
    probe = method.init_slots([torch.zeros(1)])
    return {k: specs for k in probe}


def _zip_specs(specs, tree) -> List[P]:
    """The spec of each leaf of `tree`, in tree_leaves order."""
    want = tree_leaves_with_path(tree)
    got = dict(tree_leaves_with_path(specs))
    missing = [path for path, _ in want if path not in got]
    if missing:
        raise ValueError(f"no PartitionSpec for leaves {missing[:4]}")
    return [got[path] for path, _ in want]


def _split_dim(spec: P):
    """(dim, axis) of the one split dim of a spec, or (None, None)."""
    split = [(i, a) for i, a in enumerate(spec) if a is not None]
    if len(split) > 1:
        raise NotImplementedError(f"{spec}: one split dim per leaf")
    return split[0] if split else (None, None)


def shard_params(mesh, specs, tree):
    """This rank's slice of each leaf of `tree` along its spec's split
    dim (a copy on the mesh's device); replicated leaves are copied
    whole. `tree` is the global tree every rank holds alike."""
    leaves = []
    for leaf, spec in zip(tree_leaves(tree), _zip_specs(specs, tree)):
        t = torch.as_tensor(leaf)
        dim, axis = _split_dim(spec)
        if dim is not None:
            n = mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide by the {axis!r} axis size {n}")
            t = t.chunk(n, dim)[mesh.coord(axis)]
        leaves.append(t.to(mesh.device).clone(
            memory_format=torch.contiguous_format))
    return tree_unflatten(tree, leaves)


def gather_params(mesh, specs, tree):
    """The global tree from every rank's shards (an all-gather along
    each split leaf's axis), copies of the live shards."""
    leaves = []
    for leaf, spec in zip(tree_leaves(tree), _zip_specs(specs, tree)):
        dim, axis = _split_dim(spec)
        n = 1 if dim is None else mesh.shape[axis]
        if n > 1:
            parts = [torch.empty_like(leaf, memory_format=torch.
                                      contiguous_format) for _ in range(n)]
            dist.all_gather(parts, leaf.detach().contiguous(),
                            group=mesh.groups[axis])
            leaf = torch.cat(parts, dim)
        else:  # a copy: the step updates the live shards in place
            leaf = leaf.detach().clone()
        leaves.append(leaf)
    return tree_unflatten(tree, leaves)


def step_generator(rng: Optional[int], shard_id: int,
                   device) -> Optional[torch.Generator]:
    """The dropout stream of a step: an int seed folded with the
    shard's id (the counterpart of jax.random.fold_in), or None."""
    if rng is None:
        return None
    return torch.Generator(device=device).manual_seed(
        int(rng) * 1_000_003 + (int(shard_id) << 40))


def make_transformer_train_step(model, method, mesh,
                                dp_axis: Optional[str] = "data",
                                tp_axis: Optional[str] = "model",
                                sp_axis: Optional[str] = None) -> Callable:
    """The SPMD LM training step over a dp×tp(×sp) mesh:

        step(params, slots, tokens, targets, lr, stepno, rng)
            -> (params', slots', mean_loss)

    params/slots: this rank's shards (`shard_params(mesh,
    transformer_tp_specs(...), tree)`; slots `{name: [tensors]}` in the
    params' leaf order, from `method.init_slots`), updated in place and
    returned; tokens/targets: the global (B, S) batch every rank holds
    alike — this rank trains its rows of the data axis and its chunk of
    the seq axis (zigzag-permuted when the model's sp_mode is "zigzag":
    the LM loss is a mean over positions, so the permutation leaves it
    and every gradient as the contiguous layout has them); `rng`: an int
    seed or None, folded over the data and seq shards but not over tp,
    so tp shards share their dropout masks. The model must have been
    built with the matching tp_axis/sp_axis."""
    if (model.tp_axis or None) != (tp_axis or None):
        raise ValueError(
            f"model.tp_axis={model.tp_axis!r} != step tp_axis={tp_axis!r}")
    if model.cfg.moe_experts:
        raise NotImplementedError(
            "make_transformer_train_step over a MoE-FFN TransformerLM "
            "(the expert-stacked param specs and the aux loss are not "
            "plumbed; train MoE via the Optimizer path, or shard "
            "experts with parallel/moe.py directly)")
    if (model.sp_axis or None) != (sp_axis or None):
        raise ValueError(
            f"model.sp_axis={model.sp_axis!r} != step sp_axis={sp_axis!r}")

    tie = model.cfg.tie_embeddings
    specs = transformer_tp_specs(tp_axis, tie) if tp_axis else \
        tree_map(lambda _: P(), transformer_tp_specs("x", tie))
    reduce_axes = tuple(a for a in (dp_axis, sp_axis) if a)
    zigzag = sp_axis is not None and model.sp_mode == "zigzag"

    def local_batch(x):
        if dp_axis:
            n, i = mesh.shape[dp_axis], mesh.coord(dp_axis)
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} does not divide by "
                                 f"the {dp_axis!r} axis size {n}")
            x = x.chunk(n, 0)[i]
        if sp_axis:
            n, i = mesh.shape[sp_axis], mesh.coord(sp_axis)
            if zigzag:
                from bigdl_tpu_torch.parallel.ring_attention import \
                    zigzag_order

                x = x[:, zigzag_order(n, x.shape[1]).to(x.device)]
            if x.shape[1] % n:
                raise ValueError(f"sequence {x.shape[1]} does not divide "
                                 f"by the {sp_axis!r} axis size {n}")
            x = x.chunk(n, 1)[i]
        return x

    def step(params, slots, tokens, targets, lr, stepno, rng=None):
        leaves = tree_leaves(params)
        tok, tgt = local_batch(tokens), local_batch(targets)
        # one id per (data, seq) shard — mixed radix over the axes
        shard_id, stride = 0, 1
        for a in reduce_axes:
            shard_id += mesh.coord(a) * stride
            stride *= mesh.shape[a]
        gen = step_generator(rng, shard_id, leaves[0].device)
        with bind(mesh):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            logp, _ = model.apply({"params": p, "state": {}}, tok,
                                  training=True, rng=gen)
            loss = -logp.gather(-1, tgt.long()[..., None]).mean()
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
            loss = loss.detach().clone()
            if reduce_axes:
                # batch/sequence shards each saw part of the data
                psum_leaves(grads + [loss], reduce_axes, mean=True)
        method.update(grads, leaves, slots, lr, stepno)
        return params, slots, loss

    step.specs = specs
    return step
