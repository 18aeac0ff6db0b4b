"""ResNet.

Ports bigdl_tpu/models/resnet.py (reference: models/resnet/ResNet.scala
— `ResNet.apply(classNum, opt)` with `depth`, `shortcutType` (A:
identity and zero-padded channels, B: 1x1 projection on a change of
shape, C: always a projection), the CIFAR-10 basic-block and ImageNet
bottleneck networks, MSRA init and the zero-initialized last batch-norm
gamma of every block). NHWC, the residual add as ConcatTable +
CAddTable (the reference's idiom), the same tree keys as the JAX
package's, so its variables carry across (models/convert.py).
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import MsraFiller


def _conv(n_in, n_out, k, stride=1, pad=0):
    return nn.SpatialConvolution(
        n_in, n_out, k, k, stride, stride, pad, pad, with_bias=False,
        w_init=MsraFiller(variance_norm_average=False))


def _bn(n, zero_gamma=False):
    """Spatial batch norm; `zero_gamma` zeroes its gamma at init, so a
    block's main branch adds exactly 0 until it trains."""
    bn = nn.SpatialBatchNormalization(n)
    if zero_gamma:
        orig = bn.init_params

        def patched(generator=None):
            p = orig(generator)
            p["weight"] = p["weight"] * 0.0
            return p

        bn.init_params = patched
    return bn


def _shortcut(n_in, n_out, stride, shortcut_type="B"):
    use_conv = (shortcut_type == "C"
                or (shortcut_type == "B" and (n_in != n_out or stride != 1)))
    if use_conv:
        return nn.Sequential(_conv(n_in, n_out, 1, stride), _bn(n_out))
    if n_in != n_out or stride != 1:
        # type A: strided identity + zero-padded channels
        return nn.Sequential(
            nn.SpatialAveragePooling(1, 1, stride, stride),
            _ChannelPad(n_out - n_in),
        )
    return nn.Identity()


class _ChannelPad(nn.Module):
    """Zero channels appended at the end of the last (C) axis."""

    def __init__(self, extra: int, name=None):
        super().__init__(name=name)
        self.extra = extra

    def apply(self, variables, x, training=False, rng=None):
        return F.pad(x, (0, self.extra)), variables["state"]


def basic_block(n_in, n_out, stride=1, shortcut_type="B"):
    """3x3 + 3x3 block (reference: ResNet.scala#basicBlock)."""
    main = nn.Sequential(
        _conv(n_in, n_out, 3, stride, 1), _bn(n_out), nn.ReLU(),
        _conv(n_out, n_out, 3, 1, 1), _bn(n_out, zero_gamma=True),
    )
    return nn.Sequential(
        nn.ConcatTable(main, _shortcut(n_in, n_out, stride, shortcut_type)),
        nn.CAddTable(),
        nn.ReLU(),
    )


def bottleneck(n_in, planes, stride=1, shortcut_type="B", expansion=4):
    """1x1 - 3x3 - 1x1 block (reference: ResNet.scala#bottleneck)."""
    n_out = planes * expansion
    main = nn.Sequential(
        _conv(n_in, planes, 1), _bn(planes), nn.ReLU(),
        _conv(planes, planes, 3, stride, 1), _bn(planes), nn.ReLU(),
        _conv(planes, n_out, 1), _bn(n_out, zero_gamma=True),
    )
    return nn.Sequential(
        nn.ConcatTable(main, _shortcut(n_in, n_out, stride, shortcut_type)),
        nn.CAddTable(),
        nn.ReLU(),
    )


def build_cifar(depth: int = 20, class_num: int = 10,
                shortcut_type: str = "A") -> nn.Sequential:
    """CIFAR-10 ResNet (reference: ResNet.apply, cifar10 branch; depth =
    6n + 2 with n blocks a stage)."""
    if (depth - 2) % 6:
        raise ValueError(f"cifar depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    model = nn.Sequential(_conv(3, 16, 3, 1, 1), _bn(16), nn.ReLU())
    n_in = 16
    for planes, stride in [(16, 1), (32, 2), (64, 2)]:
        for b in range(n):
            model.add(basic_block(n_in, planes, stride if b == 0 else 1,
                                  shortcut_type))
            n_in = planes
    model.add(nn.SpatialAveragePooling(8, 8, 1, 1))
    model.add(nn.Reshape([64]))
    model.add(nn.Linear(64, class_num).set_name("fc"))
    model.add(nn.LogSoftMax())
    return model


def build_imagenet(depth: int = 50, class_num: int = 1000,
                   shortcut_type: str = "B",
                   stem: str = "conv7") -> nn.Sequential:
    """ImageNet ResNet (reference: ResNet.apply, imagenet branch).

    stem="s2d": SpaceToDepth(2) and a 4x4/stride-1 conv over 12 channels
    padded (2, 1) — the same stride-2 geometry as the reference's 7x7/
    stride-2 stem (the 4x4 kernel on the s2d grid covers 8x8 >= 7x7)."""
    cfgs = {
        18: (basic_block, [2, 2, 2, 2], 1),
        34: (basic_block, [3, 4, 6, 3], 1),
        50: (bottleneck, [3, 4, 6, 3], 4),
        101: (bottleneck, [3, 4, 23, 3], 4),
        152: (bottleneck, [3, 8, 36, 3], 4),
    }
    block, layers, expansion = cfgs[depth]
    if stem == "s2d":
        model = nn.Sequential(nn.SpaceToDepth(2),
                              _conv(12, 64, 4, 1, (2, 1)).set_name("conv1"))
    elif stem == "conv7":
        model = nn.Sequential(_conv(3, 64, 7, 2, 3).set_name("conv1"))
    else:
        raise ValueError(f"unknown stem {stem!r} (conv7 | s2d)")
    model.add(_bn(64)).add(nn.ReLU())
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    n_in = 64
    for stage, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                              (512, 2)]):
        for b in range(layers[stage]):
            s = stride if b == 0 else 1
            if block is bottleneck:
                model.add(bottleneck(n_in, planes, s, shortcut_type,
                                     expansion))
                n_in = planes * expansion
            else:
                model.add(basic_block(n_in, planes, s, shortcut_type))
                n_in = planes
    model.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    model.add(nn.Reshape([n_in]))
    model.add(nn.Linear(n_in, class_num).set_name("fc"))
    model.add(nn.LogSoftMax())
    return model


def build(depth: int = 50, class_num: int = 1000, dataset: str = "imagenet",
          shortcut_type: Optional[str] = None) -> nn.Sequential:
    if dataset == "cifar10":
        return build_cifar(depth, class_num, shortcut_type or "A")
    return build_imagenet(depth, class_num, shortcut_type or "B")


ResNet = build
