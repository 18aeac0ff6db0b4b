"""TensorFlow model interop (ports bigdl_tpu/utils/tf/; reference:
utils/tf/ — TensorflowLoader, TensorflowSaver, per-op converters), on
the port's own protobuf codec."""

from bigdl_tpu_torch.utils.tf.loader import TensorflowLoader, load
from bigdl_tpu_torch.utils.tf.saver import TensorflowSaver, save

__all__ = ["TensorflowLoader", "TensorflowSaver", "load", "save"]
