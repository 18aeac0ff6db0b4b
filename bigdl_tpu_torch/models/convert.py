"""Parameter trees: moving them between packages and devices.

No single JAX counterpart: the JAX package's parameters are pytrees
(`jax.tree_util`); the port keeps the same nested dicts of tensors, so
a JAX tree carries across unchanged — same names, shapes and layouts
(`Linear` weights `(in, out)`, blocks stacked `(L, ...)`). Nothing here
imports JAX: the input is the JAX tree fetched to host arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply `fn` to every leaf of nested dicts/lists/tuples; with more
    trees of the same structure, to the matching leaves together."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple = ()
                          ) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs in `jax.tree_util`'s order — dict keys
    sorted — so a flattened port tree lines up with the flattened JAX
    tree leaf for leaf."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in `jax.tree_util` order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like `template` whose leaves are `leaves`, taken in
    `tree_leaves` order (dict keys sorted) — the inverse of
    `tree_leaves`."""
    leaves = list(leaves)
    if len(leaves) != len(tree_leaves(template)):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(template))}")
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            filled = {k: rec(node[k]) for k in sorted(node)}
            return type(node)((k, filled[k]) for k in node)
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)

    return rec(template)


def params_to_numpy(tree: Any) -> Any:
    """The same tree with every tensor leaf as a float32/int host numpy
    array (bf16 leaves are widened to float32) — the form the JAX
    package takes, for carrying port weights back and for tests."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(host, tree)


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        raise ValueError(f"parameter leaf of type {type(a).__name__} "
                         f"(dtype {arr.dtype}) is not a numeric array")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's `variables["params"]`
    (or the whole `variables` dict), given as host arrays — e.g.
    `jax.device_get(variables["params"])` — on `device` (None → the
    GPU, see utils/device.py). Any tree of nested dicts of arrays
    carries across unchanged, each leaf keeping its dtype (the
    `Sequential` trees of models/rnn.py, `nn.quantize`'s int8
    `qweight` leaves, say). A Transformer-LM's `blocks` may be stacked
    `(L, ...)` leaves or a per-layer list of dicts (the serving
    layout); it comes out stacked, the port's canonical layout."""
    dev = resolve_device(device)
    if "params" in tree:
        tree = tree["params"]
    out = dict(tree)
    blocks = out.get("blocks")
    if isinstance(blocks, (list, tuple)):
        out["blocks"] = {k: np.stack([np.asarray(layer[k])
                                      for layer in blocks])
                         for k in blocks[0]}
    return tree_map(lambda a: _to_tensor(a, dev), out)


def variables_from_jax(variables: Dict[str, Any],
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The port's whole variable tree `{"params": ..., "state": ...}`
    from the JAX package's `variables` as host arrays (e.g.
    `jax.device_get(model.init(key))`), on `device` (None → the GPU):
    the params as `params_from_jax` carries them, and the state — batch
    norm's running statistics — leaf for leaf beside them."""
    dev = resolve_device(device)
    return {"params": params_from_jax(variables["params"], dev),
            "state": tree_map(lambda a: _to_tensor(a, dev),
                              variables.get("state", {}))}
