"""AlexNet (OWT single-tower variant).

Ports bigdl_tpu/models/alexnet.py (reference:
models/alexnet/AlexNet.scala, AlexNet_OWT: the one-weird-trick
single-GPU layout). Same layers, names and trees as the JAX package's.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn


def build(class_num: int = 1000, has_dropout: bool = True) -> nn.Sequential:
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 11, 11, 4, 4, 2, 2).set_name("conv1"),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"),
        nn.SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2).set_name("conv2"),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"),
        nn.SpatialConvolution(192, 384, 3, 3, 1, 1, 1, 1).set_name("conv3"),
        nn.ReLU(),
        nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1).set_name("conv4"),
        nn.ReLU(),
        nn.SpatialConvolution(256, 256, 3, 3, 1, 1, 1, 1).set_name("conv5"),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"),
        nn.Reshape([256 * 6 * 6]),
        nn.Linear(256 * 6 * 6, 4096).set_name("fc6"),
        nn.ReLU(),
    )
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096).set_name("fc7"))
    m.add(nn.ReLU())
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num).set_name("fc8"))
    m.add(nn.LogSoftMax())
    return m


AlexNet = build
