"""Utilities of the port (counterpart: bigdl_tpu/utils/): the same
names as the JAX package's, and the Caffe and TensorFlow interop in
`utils.caffe` and `utils.tf`."""

from bigdl_tpu_torch.utils.table import Table, T
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.shape import Shape
from bigdl_tpu_torch.utils.logger_filter import redirect_logs
from bigdl_tpu_torch.utils.torch_file import load_t7, save_t7
from bigdl_tpu_torch.utils.anomaly import AnomalyError, AnomalyGuard
from bigdl_tpu_torch.utils.faults import FaultInjected, FaultPlan
from bigdl_tpu_torch.utils import profiler, precision

__all__ = ["Table", "T", "Engine", "Shape", "redirect_logs", "profiler",
           "precision", "load_t7", "save_t7", "AnomalyError",
           "AnomalyGuard", "FaultInjected", "FaultPlan"]
