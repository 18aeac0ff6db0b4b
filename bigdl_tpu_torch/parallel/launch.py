"""Run a function on every rank of a local process group.

No JAX counterpart (one JAX program drives every device of its mesh).
`spawn(fn, world_size, workdir, *args)` starts `world_size` Python
processes (`python -m bigdl_tpu_torch.parallel.launch`, so no caller's
main module is re-run), joins them into a gloo group through a
`file://` rendezvous under `workdir` (no TCP port, so several runs can
share a host), calls `fn(rank, world_size, *args)` in each with one
intra-op thread, and returns the ranks' results in rank order.
`backend="nccl"` joins an NCCL group instead, rank r on card r: it
needs one card a rank and raises with fewer. `fn` is
found again by its module and name, with the caller's `sys.path`, so
its module must be importable and must not import JAX: each rank
imports it. A rank that raises fails the call with its traceback.
`torchrun --nproc_per_node N` is the launcher for scripts; this one is
for tests and tools.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import traceback
from typing import Any, Callable, List


def spawn(fn: Callable, world_size: int, workdir: str, *args,
          timeout: float = 300.0, backend: str = "gloo") -> List[Any]:
    if fn.__module__ == "__main__":
        raise ValueError("spawn needs a function of an importable module")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected gloo or nccl")
    if backend == "nccl":
        import torch

        have = torch.cuda.device_count()
        if have < world_size:
            raise RuntimeError(f"an NCCL group of {world_size} ranks needs "
                               f"one card a rank; torch sees {have}")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "call.pkl"), "wb") as f:
        pickle.dump((list(sys.path), fn.__module__, fn.__qualname__, args),
                    f)
    procs = [subprocess.Popen([sys.executable, "-m",
                               "bigdl_tpu_torch.parallel.launch", workdir,
                               str(r), str(world_size), backend])
             for r in range(world_size)]
    try:
        for p in procs:
            p.wait(timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {world_size} left no result "
                               f"(exit code {p.returncode})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world_size} failed:\n{value}")
        results.append(value)
    return results


def _rank_main(workdir: str, rank: int, world: int,
               backend: str = "gloo") -> None:
    with open(os.path.join(workdir, "call.pkl"), "rb") as f:
        path, module, qualname, args = pickle.load(f)
    sys.path[:] = path
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        fn = importlib.import_module(module)
        for part in qualname.split("."):
            fn = getattr(fn, part)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
            world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               *sys.argv[4:5])
