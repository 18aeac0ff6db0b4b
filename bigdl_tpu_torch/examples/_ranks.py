"""The process group of the rank-parallel examples: under `torchrun`
(MASTER_ADDR, RANK, WORLD_SIZE) each process joins it through
`Engine.init_distributed` (NCCL with one card a rank, LOCAL_RANK's; gloo
on the CPU); alone, a process is world size 1 and `make_mesh` opens its
own group. No JAX counterpart: a JAX example drives every device of its
mesh from one process."""

import os

import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.engine import Engine


def join(device: str):
    """(this rank's device, world size) after joining the launcher's
    group, if there is one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    Engine.init_distributed(backend="nccl" if dev.type == "cuda"
                            else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return dev, world
