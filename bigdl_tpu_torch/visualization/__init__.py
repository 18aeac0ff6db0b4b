"""Training visualization: TensorBoard summaries.

A copy of bigdl_tpu/visualization/__init__.py (reference:
bigdl/visualization/). `Optimizer.set_train_summary` and
`set_validation_summary` take these (or a log-dir string).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_events


class Summary:
    """Base for Train/Validation summaries
    (reference: visualization/Summary.scala)."""

    def __init__(self, log_dir: str, app_name: str, suffix: str):
        self.log_dir = os.path.join(log_dir, app_name, suffix)
        self.writer = FileWriter(self.log_dir)
        self._triggers: Dict[str, object] = {}

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[str, float, int]]:
        """Read back scalars for `tag` (reference: Summary.readScalar)."""
        self.writer.flush()
        out = []
        for fname in sorted(os.listdir(self.log_dir)):
            if "tfevents" in fname:
                out.extend(e for e in read_events(os.path.join(self.log_dir, fname))
                           if e[0] == tag)
        return out

    def close(self) -> None:
        self.writer.close()


class TrainSummary(Summary):
    """Loss / Throughput / LearningRate scalars, optional parameter
    histograms (reference: visualization/TrainSummary.scala)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        """Enable extra summaries; name in {"Parameters", "LearningRate",
        "Loss", "Throughput"} (reference: TrainSummary.setSummaryTrigger)."""
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Validation scalars keyed by ValidationMethod name
    (reference: visualization/ValidationSummary.scala)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")
