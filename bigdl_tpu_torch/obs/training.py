"""One emission path for per-step training telemetry.

Ports `StepTelemetry` from bigdl_tpu/obs/training.py: the training
loop hands it one already-fetched step record and it writes the
TrainSummary scalars (Loss, Throughput, LearningRate) and parameter
histograms, if a summary is configured, and the log line. The JAX
package's class also feeds its metrics registry and event log; those
halves wait for the port of `obs/` (ROADMAP.md, queue A.9), so until
then this behaves as the reference does with `obs.enabled()` false.

Sync discipline: callers pass host floats they already fetched (the
loop reads a step's loss one step late, so the read overlaps the next
step's device work); this module never touches a device tensor.
"""

from __future__ import annotations

import logging
from typing import Optional

__all__ = ["StepTelemetry"]

logger = logging.getLogger("bigdl_tpu_torch.optim")


class StepTelemetry:
    """Per-run fan-out for step records.

    `summary` — an optional TrainSummary-like sink (anything with
    `add_scalar(tag, value, step)`); `log_every` — the log line's
    step interval. The JAX class's `plane` label and the step fields
    only its registry and events read (records, update_applied,
    gnorm) come with them."""

    def __init__(self, summary=None, log_every: int = 1):
        self.summary = summary
        self.log_every = max(int(log_every), 1)

    def emit_step(self, *, epoch: int, step: int,
                  loss: Optional[float], lr: float, throughput: float,
                  hists=None, metrics_summary: str = "") -> None:
        """`loss` must already be a host float, or None: on a step where
        nothing fenced the loss (no summary sink, not a log step) the
        loop does not fetch it. `hists` is pre-materialized (name,
        ndarray) pairs for the TrainSummary parameter-histogram
        trigger."""
        if self.summary is not None and loss is not None:
            self.summary.add_scalar("Loss", float(loss), step)
            self.summary.add_scalar("Throughput", throughput, step)
            self.summary.add_scalar("LearningRate", lr, step)
            for name, data in (hists or ()):
                self.summary.add_histogram(name, data, step)
        if step % self.log_every == 0 and loss is not None:
            logger.info(
                "epoch %d iter %d loss %.6f lr %.5g %.1f rec/s [%s]",
                epoch, step, float(loss), lr, throughput,
                metrics_summary)
