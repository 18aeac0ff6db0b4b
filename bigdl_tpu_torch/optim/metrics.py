"""Per-iteration training metrics.

Ports `Metrics` and `Timer` from bigdl_tpu/optim/metrics.py
(reference: optim/Metrics.scala — `set`, `add`, `summary`): host-side
running aggregates for the per-iteration log line. The JAX package
also mirrors every entry into its `obs` telemetry registry and span
tracer; `obs` is not ported yet (ROADMAP.md), so here they are plain
host aggregates.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple


class Metrics:
    def __init__(self):
        self._data: Dict[str, Tuple[float, int]] = {}

    def set(self, name: str, value: float) -> None:
        self._data[name] = (float(value), 1)

    def add(self, name: str, value: float) -> None:
        total, n = self._data.get(name, (0.0, 0))
        self._data[name] = (total + float(value), n + 1)

    def get(self, name: str) -> float:
        total, n = self._data.get(name, (0.0, 0))
        return total / max(n, 1)

    def summary(self) -> str:
        return " ".join(f"{k}={total / max(n, 1):.4g}"
                        for k, (total, n) in self._data.items())

    def reset(self) -> None:
        self._data.clear()


class Timer:
    """Context-manager stopwatch feeding a Metrics entry (host clock:
    with eager CUDA work inside, it measures the enqueue, not the
    device)."""

    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter() - self._t0)
        return False
