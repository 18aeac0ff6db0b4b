"""Utilities of the port (counterpart: bigdl_tpu/utils/). `Engine`,
`Shape`, `redirect_logs` and `profiler` wait for ROADMAP.md queue
A.10."""

from bigdl_tpu_torch.utils.table import Table, T
from bigdl_tpu_torch.utils.torch_file import load_t7, save_t7
from bigdl_tpu_torch.utils.anomaly import AnomalyError, AnomalyGuard
from bigdl_tpu_torch.utils.faults import FaultInjected, FaultPlan
from bigdl_tpu_torch.utils import precision

__all__ = ["Table", "T", "precision", "load_t7", "save_t7",
           "AnomalyError", "AnomalyGuard", "FaultInjected", "FaultPlan"]
