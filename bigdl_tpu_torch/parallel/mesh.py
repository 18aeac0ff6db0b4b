"""The process mesh of data-parallel training.

Ports bigdl_tpu/parallel/mesh.py. The JAX package's mesh is a
`jax.sharding.Mesh` over the devices of one program; here each rank of
a mesh is a process of a `torch.distributed` group (NCCL on CUDA, gloo
on the CPU), one device per rank. `Mesh` holds the axis names and
sizes, this process's rank and the `data` axis's process group.

`parse_axes` is the JAX package's. `make_mesh` builds only the `data`
axis (ROADMAP.md queue A.8, steps 1-3); a `model`, `seq`, `expert` or
`pipe` axis larger than 1 waits for A.8 step 5 and raises. A data axis
of 1 opens a one-rank group itself when none is initialised (a
`file://` store in a fresh temporary directory); a larger axis needs a
process group of that size that the launcher initialised — `torchrun
--nproc_per_node N`, or the tests' `parallel/launch.py` — and raises,
saying so, otherwise. On a CUDA device the group is NCCL or the mesh
raises: it never falls back to gloo on the card.

`replicated`, `sharded`, `host_to_global` and `place_global` keep the
JAX package's names as the placement helpers of a process mesh:
broadcast from rank 0, and this rank's slice of a global array.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

# the JAX package's axis names whose strategies wait for queue A.8 step 5
_LATER_AXES = ("model", "seq", "expert", "pipe")


def parse_axes(s: str) -> Dict[str, int]:
    """Parse a CLI mesh string like ``"data=8"`` or ``"data=4,model=2"``."""
    out: Dict[str, int] = {}
    for part in s.split(","):
        name, eq, size = part.partition("=")
        name = name.strip()
        if not eq or not name:
            raise ValueError(
                f"bad mesh spec {part!r} in {s!r}; expected name=size")
        try:
            out[name] = int(size)
        except ValueError:
            raise ValueError(
                f"bad mesh size {size!r} for axis {name!r} in {s!r}")
    return out


class Mesh:
    """A data-parallel process mesh: `shape[axis]` sizes, this process's
    `rank` on the data axis, its `device`, and the axis's process
    `group` (None is the default group)."""

    def __init__(self, axes: Dict[str, int], device: torch.device,
                 group=None, store: Optional[str] = None):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.device = device
        self.group = group
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self._store = store  # the rendezvous directory of an own group

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def close(self) -> None:
        """Destroy the group if this mesh opened it (a one-rank data
        axis); a launcher's group is the launcher's to destroy."""
        if self._store is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store, ignore_errors=True)
            self._store = None

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              device: DeviceLike = None) -> Mesh:
    """Build a mesh from {axis_name: size} over the process group (one
    axis may be -1 to absorb the rest). `device`: None → the card."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not axes:
        axes = {"data": world}
    axes = dict(axes)
    for name, size in axes.items():
        if name in _LATER_AXES and size != 1:
            raise NotImplementedError(
                f"mesh axis {name!r}: only data parallelism is ported to "
                "bigdl_tpu_torch yet; tensor, sequence, expert and "
                "pipeline axes wait for ROADMAP.md queue A.8, step 5")
        if name != "data" and name not in _LATER_AXES:
            raise ValueError(f"unknown mesh axis {name!r}")
    if "data" not in axes:
        axes["data"] = 1
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        axes[list(axes)[sizes.index(-1)]] = world // known
    n = axes["data"]
    store = None
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a data axis of {n} needs {n} processes: launch with "
                f"`torchrun --nproc_per_node {n} ...` (or "
                "bigdl_tpu_torch.parallel.launch.spawn) so that "
                "torch.distributed is initialised before make_mesh")
        store = tempfile.mkdtemp(prefix="bigdl-mesh-")
        dist.init_process_group(_backend_for(device),
                                init_method=f"file://{store}/rendezvous",
                                rank=0, world_size=1)
    elif dist.get_world_size() != n:
        raise ValueError(f"mesh {axes} != {dist.get_world_size()} "
                         "processes")
    backend = dist.get_backend()
    if device.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(
                f"a mesh on {device} needs the NCCL backend, got "
                f"{backend!r}")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend != "gloo":
        raise RuntimeError(f"a mesh on the CPU needs the gloo backend, "
                           f"got {backend!r}")
    return Mesh(axes, device, store=store)


def _broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.detach().to(mesh.device).contiguous().clone()
    if mesh.shape["data"] > 1:
        dist.broadcast(t, src=0, group=mesh.group)
    return t


def replicated(mesh: Mesh, tree: Any) -> Any:
    """Every tensor leaf of `tree` on the mesh's device, with rank 0's
    values on every rank."""
    return tree_map(lambda t: _broadcast(mesh, torch.as_tensor(t))
                    if isinstance(t, (torch.Tensor, np.ndarray)) else t, tree)


def sharded(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's slice of `x` along dim 0 (which divides by the
    axis size)."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                         f"the {axis!r} axis size {n}")
    rows = x.shape[0] // n
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def host_to_global(mesh: Mesh, array, axis: str = "data"):
    """This rank's rows of a global host batch (an array, or a tuple of
    arrays for multi-input models), on the mesh's device — each rank
    feeds only its own rows, as each device of the JAX mesh does."""
    if isinstance(array, tuple):
        return tuple(host_to_global(mesh, a, axis) for a in array)
    x = array if isinstance(array, torch.Tensor) else np.asarray(array)
    return torch.as_tensor(sharded(mesh, x, axis)).to(mesh.device)


def place_global(mesh: Mesh, tree: Any, axis: Optional[str] = None) -> Any:
    """A host tree that every rank holds alike (a seeded init, the same
    checkpoint files) placed on the mesh's device, as the JAX package
    places it by a PartitionSpec: with no `axis` replicated, rank 0's
    values winning (P()); with an axis, each leaf's slice of this rank
    along dim 0, a copy (P(axis))."""
    if axis is None:
        return replicated(mesh, tree)
    return tree_map(lambda t: torch.as_tensor(sharded(mesh, t, axis)).to(
        mesh.device).clone(), tree)
