"""One emission path for per-step training telemetry.

Ports `StepTelemetry` from bigdl_tpu/obs/training.py: the training
loop hands it one already-fetched step record and it fans out to (1)
the metrics registry (`training_steps_total`,
`training_updates_applied_total`, `training_records_total` and the
loss, learning-rate and throughput gauges), (2) the structured event
log (one `train_step` event a step), (3) the TrainSummary sink if
configured (Loss, Throughput, LearningRate, parameter histograms) and
(4) the log line.

Sync discipline: callers pass host floats they already fetched (the
loop reads a step's loss one step late, so the read overlaps the next
step's device work); this module never touches a device tensor.
"""

from __future__ import annotations

import logging
from typing import Optional

from bigdl_tpu_torch import obs

__all__ = ["StepTelemetry"]

logger = logging.getLogger("bigdl_tpu_torch.optim")


class StepTelemetry:
    """Per-run fan-out for step records.

    `summary` — an optional TrainSummary-like sink (anything with
    `add_scalar(tag, value, step)`); the registry and event emission do
    not depend on it. `log_every` — the log line's step interval.
    `plane` labels the events, so a process hosting several runs stays
    legible."""

    def __init__(self, summary=None, log_every: int = 1,
                 plane: str = "training"):
        self.summary = summary
        self.log_every = max(int(log_every), 1)
        self.plane = plane
        reg = obs.get_registry()
        self._steps = reg.counter(
            "training_steps_total", "optimizer steps observed")
        self._updates = reg.counter(
            "training_updates_applied_total",
            "optimizer updates actually applied (guard-discarded "
            "steps excluded)")
        self._records = reg.counter(
            "training_records_total", "training records consumed")
        self._loss = reg.gauge("training_loss", "last step loss")
        self._lr = reg.gauge("training_learning_rate",
                             "last step learning rate")
        self._thr = reg.gauge("training_throughput_records_per_sec",
                              "last step throughput")

    def emit_step(self, *, epoch: int, step: int,
                  loss: Optional[float], lr: float, throughput: float,
                  records: int, update_applied: bool = True,
                  gnorm: Optional[float] = None,
                  hists=None, metrics_summary: str = "") -> None:
        """`loss` and `gnorm` must already be host floats, or None: on a
        step where nothing else fenced the loss (no summary sink, not a
        log step) the loop does not read it for telemetry alone, so the
        event carries every host-side field and omits `loss`. `hists`
        is pre-materialized (name, ndarray) pairs for the TrainSummary
        parameter-histogram trigger."""
        if obs.enabled():
            self._steps.inc()
            self._records.inc(records)
            if update_applied:
                self._updates.inc()
            if loss is not None:
                self._loss.set(loss)
            self._lr.set(lr)
            self._thr.set(throughput)
            fields = {"plane": self.plane, "epoch": epoch, "step": step,
                      "lr": float(lr),
                      "throughput": round(float(throughput), 3),
                      "update_applied": bool(update_applied)}
            if loss is not None:
                fields["loss"] = float(loss)
            if gnorm is not None:
                fields["gnorm"] = float(gnorm)
            obs.emit_event("train_step", **fields)
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
