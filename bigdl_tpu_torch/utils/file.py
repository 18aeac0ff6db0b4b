"""Object/tensor file IO.

Ports bigdl_tpu/utils/file.py (reference: utils/File.scala —
`File.save`/`File.load` with HDFS-aware paths). The scheme dispatch
covers local paths and remote ones through fsspec when it is installed
(gated, not required); objects serialize with pickle, for parity with
the reference's Java serialization, and trees of arrays with
`save_tensors`/`load_tensors` (npz). A torch tensor, on any device, is
written as its numpy array, so a file written by either package loads
in the other (load gives numpy arrays).
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save", "load", "save_tensors", "load_tensors"]


def _open(path: str, mode: str):
    if "://" in path and not path.startswith("file://"):
        try:
            import fsspec

            return fsspec.open(path, mode).open()
        except ImportError as e:
            raise NotImplementedError(
                f"remote path {path!r} needs fsspec installed") from e
    path = path[len("file://"):] if path.startswith("file://") else path
    if "w" in mode:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return open(path, mode)


def _host(obj: Any) -> Any:
    """`obj` with every torch tensor in its dicts, lists and tuples
    replaced by its numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return type(obj)((k, _host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_host(v) for v in obj)
    return obj


def save(obj: Any, path: str, overwrite: bool = True) -> None:
    """Serialize any python object (reference: File.save)."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    with _open(path, "wb") as f:
        pickle.dump(_host(obj), f)


def load(path: str) -> Any:
    """Inverse of `save` (reference: File.load)."""
    with _open(path, "rb") as f:
        return pickle.load(f)


def save_tensors(tree: Dict[str, Any], path: str) -> None:
    """Save a flat dict (or tree flattened by '/'-joined keys) of
    arrays or tensors as npz."""
    flat: Dict[str, np.ndarray] = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(_host(node))

    rec("", tree)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    with _open(path, "wb") as f:
        f.write(buf.getvalue())


def load_tensors(path: str) -> Dict[str, Any]:
    """Inverse of `save_tensors`; '/'-joined keys rebuild the nesting."""
    with _open(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    out: Dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = data[key]
    return out
