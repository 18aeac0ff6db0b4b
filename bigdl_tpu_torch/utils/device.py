"""Device selection for the port's entry points.

No JAX counterpart: JAX places arrays on its default backend. The port
is explicit instead — an entry point runs on `cuda` unless its caller
names another device, and it never drops to the CPU on its own, so a
run that meant to measure the card cannot silently measure the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` → `cuda:0`; a string or `torch.device` passes through.
    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and this process has no CUDA device — pass
    `device="cpu"` to run the plain PyTorch path on the host."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; bigdl_tpu_torch entry "
                "points run on the GPU by default — pass device='cpu' "
                "to run the plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
