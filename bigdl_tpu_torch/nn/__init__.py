"""Layers and criteria of the port (counterpart: bigdl_tpu/nn/)."""

from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.nn.criterion import ChunkedSoftmaxCE
from bigdl_tpu_torch.nn.normalization import layer_norm
