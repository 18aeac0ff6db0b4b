"""Caffe model interop (ports bigdl_tpu/utils/caffe/; reference:
utils/caffe/ — CaffeLoader.scala, CaffePersister.scala,
Converter.scala), on the port's own protobuf codec."""

from bigdl_tpu_torch.utils.caffe.loader import (  # noqa: F401
    CaffeLoader,
    CaffePersister,
    load,
    persist,
)
