"""VGG.

Ports bigdl_tpu/models/vgg.py (reference: models/vgg/Vgg_16.scala,
Vgg_19.scala for ImageNet, and VggForCifar10.scala: conv-bn-relu
stacks). Same layers and trees as the JAX package's.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn

_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def build(depth: int = 16, class_num: int = 1000,
          with_bn: bool = False, image_size: int = 224) -> nn.Sequential:
    """(reference: models/vgg/Vgg_16.scala#Vgg_16.apply)"""
    m = nn.Sequential()
    n_in = 3
    for v in _CFG[depth]:
        if v == "M":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            m.add(nn.SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1))
            if with_bn:
                m.add(nn.SpatialBatchNormalization(v))
            m.add(nn.ReLU())
            n_in = v
    feat = image_size // 32
    m.add(nn.Reshape([512 * feat * feat]))
    m.add(nn.Linear(512 * feat * feat, 4096))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num))
    m.add(nn.LogSoftMax())
    return m


def build_cifar(class_num: int = 10) -> nn.Sequential:
    """(reference: models/vgg/VggForCifar10.scala) conv-bn-relu stacks with
    512-unit head."""
    m = nn.Sequential()
    n_in = 3
    for v in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]:
        if v == "M":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            m.add(nn.SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1))
            m.add(nn.SpatialBatchNormalization(v))
            m.add(nn.ReLU())
            n_in = v
    m.add(nn.Reshape([512]))
    m.add(nn.Linear(512, 512))
    m.add(nn.BatchNormalization(512))
    m.add(nn.ReLU())
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, class_num))
    m.add(nn.LogSoftMax())
    return m


def Vgg_16(class_num: int = 1000) -> nn.Sequential:
    return build(16, class_num)


def Vgg_19(class_num: int = 1000) -> nn.Sequential:
    return build(19, class_num)
