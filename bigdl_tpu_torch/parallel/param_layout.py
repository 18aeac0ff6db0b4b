"""The parameter-layout algebra: flatten, pad, shard, re-pad, unstack.

Ports bigdl_tpu/parallel/param_layout.py over torch trees (nested
dicts, lists and tuples of tensors). `FlatParamSpec` flattens a params
tree into one fp32 vector padded to a multiple of the shard count, in
`jax.tree_util` order (dict keys sorted, models/convert.tree_leaves),
so a flat vector of the JAX package's — a `zero1_flat` checkpoint's
slots — lines up element for element. `shard_slice` is the ZeRO slice
rule, `repad_flat`/`adapt_flat_tree` the elastic-resume reshard,
`concat_shard_trees` the load-side inverse of the slices, and
`unstack_blocks`/`map_block_leaves`/`gather_tree` the serving-layout
walks.

Not ported: `TP_COL`, `TP_COL_BIAS`, `tp_serving_block_specs` and
`tp_serving_specs`, the PartitionSpec trees of tensor-parallel serving
(`serving/tp.py`), which wait for ROADMAP.md queue A.8, step 6.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.models.convert import (tree_leaves, tree_map,
                                            tree_unflatten)

__all__ = ["FlatParamSpec", "repad_flat", "adapt_flat_tree",
           "concat_shard_trees", "unstack_blocks", "map_block_leaves",
           "gather_tree"]


class FlatParamSpec:
    """Flatten/unflatten a params tree to one padded flat fp32 vector.

    Reference parity: Module.getParameters() — all weights in one
    contiguous tensor so AllReduceParameter can slice it evenly; padded
    to a multiple of `num_shards` so every rank owns an equal slice (the
    reference's ceil-division in AllReduceParameter.init)."""

    def __init__(self, params: Any, num_shards: int):
        leaves = tree_leaves(params)
        self.template = tree_map(lambda _: 0, params)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.total = sum(self.sizes)
        self.num_shards = num_shards
        self.padded = -(-self.total // num_shards) * num_shards
        self.shard_size = self.padded // num_shards

    def flatten(self, params) -> torch.Tensor:
        """(padded,) fp32: the leaves raveled in tree order, then zeros."""
        leaves = [torch.as_tensor(l) for l in tree_leaves(params)]
        flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
        return F.pad(flat, (0, self.padded - self.total))

    def unflatten(self, flat: torch.Tensor):
        """The params tree whose leaves are views of `flat` (one split:
        autograd through it costs one concatenation), cast back to each
        leaf's dtype."""
        parts = torch.split(flat, self.sizes + [self.padded - self.total])
        leaves = [p.view(shape).to(dtype) for p, shape, dtype
                  in zip(parts, self.shapes, self.dtypes)]
        return tree_unflatten(self.template, leaves)

    def shard_slice(self, flat: torch.Tensor, index: int) -> torch.Tensor:
        """Shard `index`'s (shard_size,) slice of a (padded,) vector —
        THE ZeRO slice rule. The slices of 0..num_shards-1 are disjoint
        and cover the vector, so an all-gather of them is the vector
        bit for bit (the ZeRO-2 == ZeRO-1 pin)."""
        return flat[index * self.shard_size:(index + 1) * self.shard_size]


def repad_flat(flat, old_total: int, padded: int) -> torch.Tensor:
    """Re-pad one flat vector from another world size's layout: strip
    the old padding down to the `old_total` real parameters, then
    zero-pad to this layout's `padded` length."""
    flat = torch.as_tensor(flat)
    if old_total > padded:
        raise ValueError(f"cannot re-pad {old_total} parameters into "
                         f"{padded}")
    return F.pad(flat[:old_total], (0, padded - old_total))


def adapt_flat_tree(saved_slots, optim_meta, spec: FlatParamSpec):
    """Checkpointed slots in this run's ZeRO flat layout: a zero1/zero2
    flat layout of the same padding as saved; of another world size
    re-padded; a LocalOptimizer checkpoint's param-shaped slot trees
    flattened with `spec`."""
    layout = (optim_meta or {}).get("layout")
    if layout in ("zero1_flat", "zero2_flat"):
        if optim_meta["padded"] == spec.padded:
            return {k: torch.as_tensor(v) for k, v in saved_slots.items()}
        total = optim_meta["total"]
        return {k: repad_flat(v, total, spec.padded)
                for k, v in saved_slots.items()}
    return {k: spec.flatten(v) for k, v in saved_slots.items()}


def concat_shard_trees(parts):
    """Per-shard slot trees (in shard order) concatenated back into the
    full (padded,) vectors, on the host: the inverse of `shard_slice`."""
    leaves = [tree_leaves(p) for p in parts]
    cat = [np.concatenate([np.asarray(torch.as_tensor(x).cpu())
                           for x in xs]) for xs in zip(*leaves)]
    return tree_unflatten(parts[0], cat)


def unstack_blocks(p: Dict[str, Any], num_layers: int) -> tuple:
    """Per-layer block dicts from the stacked (L, ...) training layout
    (a tuple or list passes through)."""
    blocks = p["blocks"]
    if isinstance(blocks, (tuple, list)):
        return tuple(blocks)
    return tuple(tree_map(lambda a: a[l], blocks)
                 for l in range(num_layers))


def map_block_leaves(params: Dict[str, Any], fn) -> Dict[str, Any]:
    """A serving-layout dict with `fn(key, leaf)` applied to every
    per-layer block leaf (top-level entries pass through). Requires the
    per-layer layout."""
    if not isinstance(params["blocks"], (tuple, list)):
        raise ValueError(
            "map_block_leaves expects the per-layer serving layout — "
            "call model.serving_params(variables) first")
    out = dict(params)
    out["blocks"] = tuple({k: fn(k, v) for k, v in bp.items()}
                          for bp in params["blocks"])
    return out


def gather_tree(params):
    """The host (checkpoint) form of a params tree: every tensor leaf as
    a numpy array copied off its device."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t),
                    params)
