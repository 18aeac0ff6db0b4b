"""Profiling / tracing.

Ports bigdl_tpu/utils/profiler.py (reference: SURVEY.md §5.1 — the
reference has no tracer, only per-iteration `optim/Metrics` counters
and the `*OptimizerPerf` harness). The JAX package's `jax.profiler`
traces become `torch.profiler` ones (host and, on a card, CUDA
kernels), its annotations `record_function` ranges, and its fence a
device synchronise.

Usage::

    with profiler.trace("/tmp/tb"):            # host + CUDA trace
        for batch in data:
            with profiler.step(i):             # marks step boundaries
                step_fn(...)

    t = profiler.FencedTimer()
    with t:
        out = step_fn(...)
        t.fence(out)                           # device-honest timing
    logger.info("step %.3fs", t.elapsed)

The trace is a `*.pt.trace.json` file under `log_dir`, which
TensorBoard's profiler plugin and Chrome's trace viewer read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import torch
from torch.utils._pytree import tree_flatten

__all__ = ["trace", "step", "annotate", "FencedTimer", "device_sync"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (host ops, and CUDA kernels when
    a card is present) into `log_dir`."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


def step(step_num: int):
    """Annotate one training step inside a trace() region; a range
    named `train_step#<n>` in the trace."""
    return torch.profiler.record_function(f"train_step#{step_num}")


def annotate(name: str):
    """Named host-side trace region (record_function)."""
    return torch.profiler.record_function(name)


def device_sync(*values: Any) -> None:
    """Block until the device work producing `values` (tensors in any
    nesting of lists, tuples and dicts) is complete: one synchronise of
    each CUDA device they live on."""
    devices = {t.device for t in tree_flatten(values)[0]
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class FencedTimer:
    """Wall-clock timer whose stop is fenced by a device synchronise, so
    it measures completed device work, not dispatch."""

    def __init__(self):
        self.elapsed: Optional[float] = None
        self._t0: Optional[float] = None
        self._fenced = False

    def __enter__(self) -> "FencedTimer":
        self._t0 = time.perf_counter()
        self._fenced = False
        return self

    def fence(self, *values: Any) -> None:
        device_sync(*values)
        self.elapsed = time.perf_counter() - self._t0
        self._fenced = True

    def __exit__(self, *exc) -> None:
        if not self._fenced:
            self.elapsed = time.perf_counter() - self._t0
