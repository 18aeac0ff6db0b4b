"""bigdl_tpu_torch.dataset — host-side data plane (counterpart:
bigdl_tpu/dataset/): Samples and MiniBatches; in-memory, sharded,
transformed and prefetching datasets with transformer chains (`>>`);
the text pipeline of the LM path; the image transforms and the vision
pipeline (ImageFrame); BDLS record shards and TFRecord files on disk,
read through the C++ plane (dataset/native.py) when it builds; the
MNIST and CIFAR-10 loaders with their synthetic stand-ins; the Spark
adapter (`spark_adapter`, duck-typed: pyspark is not a dependency)."""

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, MapTransformer, SampleToMiniBatch, Transformer, chain,
)
from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet, PrefetchDataSet, ShardedDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset import (
    cifar, image, mnist, native, spark_adapter, text, vision,
)
from bigdl_tpu_torch.dataset.records import (
    RecordFileDataSet, read_header, resolve_shards, write_shards,
)
from bigdl_tpu_torch.dataset.tfrecord import (
    TFRecordDataSet, decode_example, encode_example, read_tfrecords,
    write_image_examples, write_tfrecords,
)
from bigdl_tpu_torch.dataset.vision import ImageFeature, ImageFrame
