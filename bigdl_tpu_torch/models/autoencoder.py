"""Fully-connected autoencoder.

Ports bigdl_tpu/models/autoencoder.py (reference:
models/autoencoder/Autoencoder.scala): a 784 -> 32 -> 784 MLP with a
sigmoid output, trained with MSE on MNIST.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn


def build(class_num: int = 32, input_size: int = 784) -> nn.Sequential:
    return nn.Sequential(
        nn.Reshape([input_size]),
        nn.Linear(input_size, class_num).set_name("encoder"),
        nn.ReLU(),
        nn.Linear(class_num, input_size).set_name("decoder"),
        nn.Sigmoid(),
    )


Autoencoder = build
