"""Numerical-debug helpers.

Ports bigdl_tpu/utils/debug.py (reference: SURVEY.md §5.2 — the
reference has no sanitizers, JVM memory safety and tensor confinement
standing in; the JAX package's equivalents are NaN trapping and
deterministic seeding, and so are the port's).

`debug_nans` is the counterpart of `jax_debug_nans`: a
`TorchDispatchMode` checks every floating-point output of every op and
raises `FloatingPointError` at the op that produced a NaN, naming it;
autograd's anomaly mode (NaN check on) covers the backward, whose ops
may run on autograd's own threads.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["debug_nans", "assert_all_finite", "deterministic"]


class _NanTrap(TorchDispatchMode):
    """Raise at the first op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.device.type != "meta" and bool(t.isnan().any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func} "
                    f"(output of shape {tuple(t.shape)} on {t.device})")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Trap NaNs at their producing op: any op, forward or backward,
    that produces a NaN raises with the op's name. Synchronises after
    every op — expensive, test/debug only. `enable=False` runs the body
    untrapped."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True), _NanTrap():
        yield


def _key_str(path: Tuple[Any, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _leaves_with_path(tree: Any, path: Tuple[Any, ...] = ()
                      ) -> List[Tuple[Tuple[Any, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves_with_path(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves_with_path(v, path + (i,)))
        return out
    return [(path, tree)]


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Eager finite-ness check over a tree (params, grads, …) of
    tensors or arrays; the error names each bad leaf's key path."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and \
                    not bool(torch.isfinite(leaf).all()):
                bad.append(_key_str(path))
        elif hasattr(leaf, "dtype") and np.issubdtype(leaf.dtype,
                                                      np.floating):
            if not bool(np.isfinite(leaf).all()):
                bad.append(_key_str(path))
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name} at: {', '.join(bad)}")


@contextlib.contextmanager
def deterministic(seed: int = 0) -> Iterator[torch.Generator]:
    """Deterministic-seed test mode: yields a CPU `torch.Generator`
    seeded with `seed` (what the port's `init` takes) and turns on
    `torch.use_deterministic_algorithms` — with the cuBLAS workspace
    setting it needs on the card — restoring both on exit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    prev_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if prev_ws is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield torch.Generator().manual_seed(seed)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        if prev_ws is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
