"""bigdl_tpu_torch.dataset — host-side data plane (counterpart:
bigdl_tpu/dataset/): Samples, MiniBatches, in-memory datasets and the
synthetic LM data of the training slice."""

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch, Transformer
from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet,
)
from bigdl_tpu_torch.dataset import text
