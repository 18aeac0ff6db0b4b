"""bigdl_tpu_torch.dataset — host-side data plane (counterpart:
bigdl_tpu/dataset/): Samples, MiniBatches, in-memory datasets and the
synthetic LM data of the training slice, and the MNIST and CIFAR-10
loaders with their synthetic stand-ins."""

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch, Transformer
from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet,
)
from bigdl_tpu_torch.dataset import cifar, mnist, text
