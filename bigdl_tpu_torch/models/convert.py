"""Parameter trees: moving them between packages and devices.

No single JAX counterpart: the JAX package's parameters are pytrees
(`jax.tree_util`); the port keeps the same nested dicts of tensors, so
a JAX tree carries across unchanged — same names, shapes and layouts
(`Linear` weights `(in, out)`, blocks stacked `(L, ...)`). Nothing here
imports JAX: the input is the JAX tree fetched to host arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply `fn` to every leaf of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        raise ValueError(f"parameter leaf of type {type(a).__name__} "
                         f"(dtype {arr.dtype}) is not a numeric array; "
                         "quantized leaves are not ported yet")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's `variables["params"]`
    (or the whole `variables` dict), given as host arrays — e.g.
    `jax.device_get(variables["params"])`. `blocks` may be stacked
    `(L, ...)` leaves or a per-layer list of dicts (the serving layout);
    the result is always stacked, the port's canonical layout, on
    `device` (None → the GPU, see utils/device.py)."""
    dev = resolve_device(device)
    if "params" in tree:
        tree = tree["params"]
    out = {k: v for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    if isinstance(blocks, (list, tuple)):
        blocks = {k: np.stack([np.asarray(layer[k]) for layer in blocks])
                  for k in blocks[0]}
    out["blocks"] = blocks
    return tree_map(lambda a: _to_tensor(a, dev), out)
