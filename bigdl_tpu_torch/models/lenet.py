"""LeNet-5.

Ports `build`/`LeNet5` of bigdl_tpu/models/lenet.py (reference:
models/lenet/LeNet5.scala#LeNet5.apply): conv(1→6, 5x5) → tanh →
maxpool 2 → conv(6→12, 5x5) → tanh → maxpool 2 → flatten →
linear(12·4·4 → 100) → tanh → linear(100 → classNum) → logsoftmax, on
NHWC (28, 28, 1) input; `graph` is the same network as an
`nn.Graph` (reference: LeNet5.graph).
"""

from __future__ import annotations

from bigdl_tpu_torch import nn


def build(class_num: int = 10) -> nn.Sequential:
    return nn.Sequential(
        nn.SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Reshape([12 * 4 * 4]),
        nn.Linear(12 * 4 * 4, 100).set_name("fc_1"),
        nn.Tanh(),
        nn.Linear(100, class_num).set_name("score"),
        nn.LogSoftMax(),
    )


LeNet5 = build


def graph(class_num: int = 10) -> nn.Graph:
    """Same network as an explicit Graph (reference: LeNet5.graph)."""
    x = nn.Input()
    h = nn.SpatialConvolution(1, 6, 5, 5)(x)
    h = nn.Tanh()(h)
    h = nn.SpatialMaxPooling(2, 2, 2, 2)(h)
    h = nn.SpatialConvolution(6, 12, 5, 5)(h)
    h = nn.Tanh()(h)
    h = nn.SpatialMaxPooling(2, 2, 2, 2)(h)
    h = nn.Reshape([12 * 4 * 4])(h)
    h = nn.Linear(12 * 4 * 4, 100)(h)
    h = nn.Tanh()(h)
    h = nn.Linear(100, class_num)(h)
    y = nn.LogSoftMax()(h)
    return nn.Graph(x, y)
