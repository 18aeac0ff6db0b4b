"""Keras-style model-building API of the port.

Ports bigdl_tpu/keras/ (reference: the reference line's `nn/keras`
package — Keras-1-shaped layer wrappers over the core module library:
Sequential/Model with `compile`/`fit`/`evaluate`/`predict`, layers
inferring their input shapes from the previous layer). Thin sugar over
`bigdl_tpu_torch.nn` and the port's `Optimizer`/`Evaluator`/
`Predictor`: everything lowers to the same training path, so `LSTM`,
`GRU` and `Bidirectional` run the fused recurrent CUDA kernels on a
card (nn.Recurrent / nn.BiRecurrent's `impl=None` routing).
"""

from bigdl_tpu_torch.keras.layers import (
    Activation, AveragePooling2D, BatchNormalization, Conv2D, Convolution2D,
    Dense, Dropout, Embedding, Flatten, GlobalAveragePooling2D, InputLayer,
    LSTM, MaxPooling2D, Reshape,
)
from bigdl_tpu_torch.keras.layers_extra import (
    Bidirectional, Conv3D, Cropping2D, GRU, GlobalMaxPooling2D,
    MaxPooling3D, Permute, RepeatVector, SimpleRNN, UpSampling2D,
    ZeroPadding2D,
)
from bigdl_tpu_torch.keras.models import Sequential
from bigdl_tpu_torch.keras.functional import (
    Add, Average, Concatenate, Dot, Input, KTensor, Maximum, Minimum,
    Model, Multiply, Subtract, merge,
)

__all__ = [
    "Sequential", "Dense", "Conv2D", "Convolution2D", "MaxPooling2D",
    "AveragePooling2D", "GlobalAveragePooling2D", "Flatten", "Activation",
    "Dropout", "Embedding", "BatchNormalization", "LSTM", "Reshape",
    "InputLayer", "Conv3D", "MaxPooling3D", "UpSampling2D",
    "GlobalMaxPooling2D", "SimpleRNN", "GRU", "Bidirectional",
    "ZeroPadding2D", "Cropping2D", "Permute", "RepeatVector",
    # functional API
    "Model", "Input", "KTensor", "merge", "Add", "Multiply", "Subtract",
    "Average", "Maximum", "Minimum", "Concatenate", "Dot",
]
