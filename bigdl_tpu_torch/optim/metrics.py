"""Per-iteration training metrics.

Ports `Metrics` and `Timer` from bigdl_tpu/optim/metrics.py
(reference: optim/Metrics.scala — `set`, `add`, `summary`): host-side
running aggregates for the per-iteration log line. Every `add` and `set`
also mirrors into the process-wide telemetry registry (obs/): phase
stopwatches become label series of the `training_phase_seconds`
histogram, scalar sets become the `training_metric` gauge. `Timer` also
records a host span into the active tracer, so the training phases
(data_fetch, dispatch, ...) sit on the Chrome-trace timeline beside the
serving spans.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

from bigdl_tpu_torch import obs


class Metrics:
    def __init__(self):
        self._data: Dict[str, Tuple[float, int]] = {}
        self._hist = obs.get_registry().histogram(
            "training_phase_seconds",
            "per-step phase stopwatches (optim.Metrics timers)",
            labelnames=("phase",))
        self._gauges = obs.get_registry().gauge(
            "training_metric", "optim.Metrics scalar sets",
            labelnames=("name",))

    def set(self, name: str, value: float) -> None:
        self._data[name] = (float(value), 1)
        if obs.enabled():
            self._gauges.labels(name=name).set(float(value))

    def add(self, name: str, value: float) -> None:
        total, n = self._data.get(name, (0.0, 0))
        self._data[name] = (total + float(value), n + 1)
        if obs.enabled():
            self._hist.labels(phase=name).observe(float(value))

    def get(self, name: str) -> float:
        total, n = self._data.get(name, (0.0, 0))
        return total / max(n, 1)

    def summary(self) -> str:
        return " ".join(f"{k}={total / max(n, 1):.4g}"
                        for k, (total, n) in self._data.items())

    def reset(self) -> None:
        self._data.clear()


class Timer:
    """Context-manager stopwatch feeding a Metrics entry, and, when the
    span tracer is enabled, a host span of the same name (host clock:
    with eager CUDA work inside, it measures the enqueue, not the
    device)."""

    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self._span = obs.get_tracer().span(self.name.removesuffix("_s"),
                                           cat="train")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter() - self._t0)
        self._span.__exit__(None, None, None)
        return False
