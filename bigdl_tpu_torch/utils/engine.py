"""Engine — runtime/topology discovery and global configuration.

Ports bigdl_tpu/utils/engine.py (reference: utils/Engine.scala —
Engine.init, coreNumber, nodeNumber, the Engine.model/Engine.default
thread pools — and utils/ThreadPool.scala). The reference discovers
Spark executor/core topology; the JAX package discovers its PJRT
devices and processes; the port discovers the CUDA devices of this
process and the `torch.distributed` process group (one device per
rank, parallel/mesh.py). Thread pools are unnecessary, intra-op
parallelism belonging to torch and the card, so `core_number` reports
host CPUs for the input pipeline only.

The JAX module's `ensure_cpu_platform` has no port: it steers JAX's
backend selection (`JAX_PLATFORMS=cpu` on images whose PJRT plugin
would win), and the port chooses its device per call instead
(`device="cpu"`, utils/device.py), as tpu_probe.py has no port.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Engine:
    """Process-wide runtime info. All methods are class-level, mirroring the
    reference's singleton `Engine` object."""

    _initialized = False
    _node_number: int = 1
    _core_number: int = 1

    @classmethod
    def init(cls) -> None:
        """Discover topology. Safe to call repeatedly.

        Reference parity: utils/Engine.scala#Engine.init — there it
        validates spark conf / executor cores; here it reads the
        process group's world size (1 without one) and host cores.
        """
        cls._node_number = dist.get_world_size() \
            if dist.is_available() and dist.is_initialized() else 1
        cls._core_number = os.cpu_count() or 1
        cls._initialized = True

    @classmethod
    def init_distributed(
        cls,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        backend: Optional[str] = None,
    ) -> None:
        """Multi-process bring-up: one process per card (the reference ran
        one Spark executor per node; utils/Engine.scala#Engine.init).

        Joins the `torch.distributed` group (NCCL with a card, gloo
        without; `backend` overrides): at `coordinator_address`
        ("host:port", tcp://) with `num_processes` and `process_id`;
        else from BIGDL_COORDINATOR / BIGDL_NUM_PROCESSES /
        BIGDL_PROCESS_ID, which must be set together; else from the
        launcher's environment (`torchrun`: MASTER_ADDR, RANK,
        WORLD_SIZE; env://). With none of these, or a group already
        initialised, it stays as it is (one process).
        """
        if coordinator_address is None:
            coordinator_address = os.environ.get("BIGDL_COORDINATOR")
            if coordinator_address is not None:
                n = os.environ.get("BIGDL_NUM_PROCESSES")
                pid = os.environ.get("BIGDL_PROCESS_ID")
                if n is None or pid is None:
                    raise ValueError(
                        "BIGDL_COORDINATOR is set but "
                        f"BIGDL_NUM_PROCESSES={n!r} / "
                        f"BIGDL_PROCESS_ID={pid!r}; all three must be set "
                        "together")
                num_processes = int(n)
                process_id = int(pid)
        if not dist.is_initialized():
            backend = backend or ("nccl" if torch.cuda.is_available()
                                  else "gloo")
            if coordinator_address is not None:
                if num_processes is None or process_id is None:
                    raise ValueError("coordinator_address needs "
                                     "num_processes and process_id")
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
            elif all(k in os.environ for k in ("MASTER_ADDR", "RANK",
                                               "WORLD_SIZE")):
                dist.init_process_group(backend, init_method="env://")
        cls.init()

    @classmethod
    def node_number(cls) -> int:
        if not cls._initialized:
            cls.init()
        return cls._node_number

    @classmethod
    def core_number(cls) -> int:
        if not cls._initialized:
            cls.init()
        return cls._core_number

    @classmethod
    def device_count(cls) -> int:
        """The devices of the whole job: one a rank under a process
        group, else this process's CUDA devices."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return cls.local_device_count()

    @classmethod
    def local_device_count(cls) -> int:
        """This process's CUDA devices (0 without a card)."""
        return torch.cuda.device_count()

    @classmethod
    def default_mesh(cls, axis_names: Sequence[str] = ("data",),
                     device=None):
        """Build the default mesh over all ranks (parallel/mesh.py; a
        one-rank world opens its own group, which `mesh.close()` ends).

        With one axis this is pure data parallelism — the direct analogue of
        the reference's partition-per-executor layout
        (parameters/AllReduceParameter.scala#AllReduceParameter.init).
        `device`: None → the card.
        """
        from bigdl_tpu_torch.parallel.mesh import make_mesh

        if len(axis_names) != 1:
            raise ValueError(
                "default_mesh builds 1-D meshes; build multi-axis meshes via "
                "bigdl_tpu_torch.parallel.mesh.make_mesh"
            )
        world = dist.get_world_size() if dist.is_initialized() else 1
        return make_mesh({axis_names[0]: world}, device)
