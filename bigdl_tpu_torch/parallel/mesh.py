"""The process mesh of distributed training.

Ports bigdl_tpu/parallel/mesh.py. The JAX package's mesh is a
`jax.sharding.Mesh` over the devices of one program; here each rank of
a mesh is a process of a `torch.distributed` group (NCCL on CUDA, gloo
on the CPU), one device per rank. `Mesh` holds the axis names and
sizes, this process's coordinates and one process group per axis.

Axes are the JAX package's: `data` (data parallelism), `model`
(tensor), `seq` (sequence), `expert` (expert) and `pipe` (pipeline),
of any sizes whose product is the world size (one may be -1 to absorb
the rest). A rank's coordinates follow the JAX mesh's device order:
row-major over the axes in the order given (`np.unravel_index`). The
group of an axis holds the ranks that differ from this one only along
that axis, ordered by their coordinate on it, so a rank's rank in the
group is its coordinate. Every rank creates every group of every axis
in the same order (`dist.new_subgroups_by_enumeration`), as
`torch.distributed` requires; an axis that spans the whole world uses
the default group. `mesh.group` and `mesh.rank` are the `data` axis's
(the data-parallel plane's names); `mesh.groups[axis]`,
`mesh.coord(axis)` and `mesh.size_of(axis)` serve every axis.

A one-rank world opens its own group when none is initialised (a
`file://` store in a fresh temporary directory) — on CUDA an NCCL group
with every axis 1; a larger world needs a process group of that size
that the launcher initialised — `torchrun --nproc_per_node N`, or the
tests' `parallel/launch.py` — and raises, saying so, otherwise. On a
CUDA device the group is NCCL or the mesh raises: it never falls back
to gloo on the card.

`P` spells a PartitionSpec as the JAX package does; the spec trees of
tensor_parallel.py, pipeline.py and moe.py are trees of it.
`replicated`, `sharded`, `host_to_global` and `place_global` keep the
JAX package's names as the placement helpers of a process mesh:
broadcast from rank 0, and this rank's slice of a global array along
an axis.
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

# the JAX package's axis names, each the parallelism it carries
AXES = ("data", "model", "seq", "expert", "pipe")


class P:
    """A PartitionSpec, as `jax.sharding.PartitionSpec` spells it: per
    dim of a leaf the mesh axis it is split over, or None. A leaf of a
    spec tree (not a tuple, so the tree walks of models/convert.py stop
    at it)."""

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"


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
    """A process mesh: `shape[axis]` sizes, this process's `coords`,
    its `device`, and one process group per axis (`groups[axis]`; None
    is the default group). `rank` and `group` are the data axis's."""

    def __init__(self, axes: Dict[str, int], device: torch.device,
                 groups: Optional[Dict[str, Any]] = None,
                 store: Optional[str] = None):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.device = device
        self.groups = dict(groups or {a: None for a in axes})
        world = dist.get_world_size() if dist.is_initialized() else 1
        me = dist.get_rank() if dist.is_initialized() else 0
        if int(np.prod(list(self.shape.values()))) != world:
            raise ValueError(f"mesh {self.shape} != {world} processes")
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                               np.unravel_index(me, list(
                                   self.shape.values())))))
        self.group = self.groups["data"]
        self.rank = self.coords["data"]
        self.backend = dist.get_backend()
        self._store = store  # the rendezvous directory of an own group

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def size_of(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        """This rank's coordinate (index) on `axis`."""
        return self.coords[axis]

    def close(self) -> None:
        """Destroy the group if this mesh opened it (a one-rank world);
        a launcher's group is the launcher's to destroy."""
        if self._store is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store, ignore_errors=True)
            self._store = None

    def __repr__(self):
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _axis_groups(names, sizes) -> Dict[str, Any]:
    """{axis: this rank's group}. Every rank enumerates every group of
    every axis in the same order: an axis of size 1 is a group of one
    rank, an axis spanning the world the default group (None)."""
    world = int(np.prod(sizes))
    order = np.arange(world).reshape(sizes)
    groups = {}
    for i, name in enumerate(names):
        if sizes[i] == world:
            groups[name] = None
            continue
        # the ranks that differ only along axis i, by their coordinate
        lines = np.moveaxis(order, i, -1).reshape(-1, sizes[i])
        groups[name], _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in line] for line in lines])
    return groups


def make_mesh(axes: Optional[Dict[str, int]] = None,
              device: DeviceLike = None) -> Mesh:
    """Build a mesh from {axis_name: size} over the process group (one
    axis may be -1 to absorb the rest; a missing `data` axis is 1).
    `device`: None → the card."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not axes:
        axes = {"data": world}
    axes = dict(axes)
    for name in axes:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; expected one "
                             f"of {AXES}")
    if "data" not in axes:
        axes["data"] = 1
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        axes[list(axes)[sizes.index(-1)]] = world // known
    n = int(np.prod(list(axes.values())))
    store = None
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks ({axes}) needs {n} processes: launch "
                f"with `torchrun --nproc_per_node {n} ...` (or "
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
    groups = _axis_groups(list(axes), list(axes.values()))
    return Mesh(axes, device, groups, store=store)


def _broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.detach().to(mesh.device).contiguous().clone()
    if mesh.size > 1:
        dist.broadcast(t, src=0)
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
    i = mesh.coord(axis)
    return x[i * rows:(i + 1) * rows]


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
