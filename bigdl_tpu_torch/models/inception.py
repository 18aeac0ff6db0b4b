"""Inception v1 (GoogLeNet) and v2 (BN-Inception).

Ports bigdl_tpu/models/inception.py (reference:
models/inception/Inception_v1.scala — `Inception_Layer_v1`, a 4-branch
module of 1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1 concatenated over
channels, and `Inception_v1_NoAuxClassifier` — and
models/inception/Inception_v2.scala). Same layers, names and channel
tables, so the JAX package's trees carry across unchanged. The
convolutions run on cuDNN and the pooling on ATen; no Pallas kernel of
the JAX package lies on this path.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import Xavier


def _conv(n_in, n_out, k, stride=1, pad=0, name=""):
    return nn.Sequential(
        nn.SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                              w_init=Xavier()).set_name(name + f"conv{k}x{k}"),
        nn.ReLU(),
    )


def inception_layer_v1(n_in, config, prefix=""):
    """(reference: Inception_v1.scala#Inception_Layer_v1)
    config = ((c1,), (c3r, c3), (c5r, c5), (pp,))"""
    (c1,), (c3r, c3), (c5r, c5), (pp,) = config
    return nn.Concat(
        4,  # channel axis in NHWC (1-based dim 4)
        _conv(n_in, c1, 1, name=prefix + "1x1/"),
        nn.Sequential(
            _conv(n_in, c3r, 1, name=prefix + "3x3r/"),
            _conv(c3r, c3, 3, pad=1, name=prefix + "3x3/")),
        nn.Sequential(
            _conv(n_in, c5r, 1, name=prefix + "5x5r/"),
            _conv(c5r, c5, 5, pad=2, name=prefix + "5x5/")),
        nn.Sequential(
            nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
            _conv(n_in, pp, 1, name=prefix + "pool/")),
    )


def inception_layer_v1_fused(n_in, config, prefix=""):
    """Branch-fused variant of `inception_layer_v1`, an `nn.Graph`: the
    three 1x1 convolutions that read the layer's input (the 1x1 branch,
    the 3x3 and 5x5 reduces) merge into one with c1+c3r+c5r output
    channels, one larger product instead of three; ReLU commutes with
    the channel slices taken after it. The pool projection reads the
    pooled input and stays separate."""
    (c1,), (c3r, c3), (c5r, c5), (pp,) = config
    x = nn.Input()
    merged = nn.Sequential(
        nn.SpatialConvolution(n_in, c1 + c3r + c5r, 1, 1, 1, 1, 0, 0,
                              w_init=Xavier()
                              ).set_name(prefix + "reduce_merged/conv1x1"),
        nn.ReLU(),
    )(x)
    b1 = nn.Narrow(4, 1, c1)(merged)
    b3 = _conv(c3r, c3, 3, pad=1, name=prefix + "3x3/")(
        nn.Narrow(4, 1 + c1, c3r)(merged))
    b5 = _conv(c5r, c5, 5, pad=2, name=prefix + "5x5/")(
        nn.Narrow(4, 1 + c1 + c3r, c5r)(merged))
    bp = nn.Sequential(
        nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
        _conv(n_in, pp, 1, name=prefix + "pool/"),
    )(x)
    out = nn.JoinTable(4)(b1, b3, b5, bp)
    return nn.Graph(x, out)


def build(class_num: int = 1000, has_dropout: bool = True,
          fused_branches: bool = False) -> nn.Sequential:
    """(reference: Inception_v1.scala#Inception_v1_NoAuxClassifier)

    fused_branches=True swaps each inception layer for the
    reduce-merged variant (the same function, fewer and larger
    products; see inception_layer_v1_fused)."""
    layer = inception_layer_v1_fused if fused_branches \
        else inception_layer_v1
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                              w_init=Xavier()).set_name("conv1/7x7_s2"),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
        _conv(64, 64, 1, name="conv2/3x3_reduce/"),
        _conv(64, 192, 3, pad=1, name="conv2/3x3/"),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        layer(192, ((64,), (96, 128), (16, 32), (32,)), "3a/"),
        layer(256, ((128,), (128, 192), (32, 96), (64,)), "3b/"),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        layer(480, ((192,), (96, 208), (16, 48), (64,)), "4a/"),
        layer(512, ((160,), (112, 224), (24, 64), (64,)), "4b/"),
        layer(512, ((128,), (128, 256), (24, 64), (64,)), "4c/"),
        layer(512, ((112,), (144, 288), (32, 64), (64,)), "4d/"),
        layer(528, ((256,), (160, 320), (32, 128), (128,)), "4e/"),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        layer(832, ((256,), (160, 320), (32, 128), (128,)), "5a/"),
        layer(832, ((384,), (192, 384), (48, 128), (128,)), "5b/"),
        nn.SpatialAveragePooling(7, 7, 1, 1),
    )
    if has_dropout:
        m.add(nn.Dropout(0.4))
    m.add(nn.Reshape([1024]))
    m.add(nn.Linear(1024, class_num).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m


Inception_v1 = build


# --------------------------------------------------------------- Inception v2

def _conv_bn(n_in, n_out, k, stride=1, pad=0, name=""):
    """conv + SpatialBatchNormalization + ReLU — the v2 building block
    (reference: Inception_v2.scala — every conv is followed by
    SpatialBatchNormalization(nOut, 1e-3) + ReLU(true))."""
    return nn.Sequential(
        nn.SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                              w_init=Xavier()).set_name(name + f"conv{k}x{k}"),
        nn.SpatialBatchNormalization(n_out, eps=1e-3).set_name(name + "bn"),
        nn.ReLU(),
    )


def inception_layer_v2(n_in, config, prefix=""):
    """(reference: Inception_v2.scala#Inception_Layer_v2)

    config = ((c1,), (c3r, c3), (d3r, d3), (pool_kind, pp)) with the v2
    branch set: 1x1 / 1x1->3x3 / 1x1->3x3->3x3 (double-3x3 replaces v1's
    5x5) / pool->proj. ``c1 == 0`` selects the stride-2 ("pass-through")
    variant: the 1x1 branch disappears, both conv branches stride 2, the
    pool branch max-pools stride 2 with no projection.
    """
    (c1,), (c3r, c3), (d3r, d3), (pool_kind, pp) = config
    stride = 2 if c1 == 0 else 1
    branches = []
    if c1 > 0:
        branches.append(_conv_bn(n_in, c1, 1, name=prefix + "1x1/"))
    branches.append(nn.Sequential(
        _conv_bn(n_in, c3r, 1, name=prefix + "3x3r/"),
        _conv_bn(c3r, c3, 3, stride=stride, pad=1, name=prefix + "3x3/")))
    branches.append(nn.Sequential(
        _conv_bn(n_in, d3r, 1, name=prefix + "d3x3r/"),
        _conv_bn(d3r, d3, 3, pad=1, name=prefix + "d3x3a/"),
        _conv_bn(d3, d3, 3, stride=stride, pad=1, name=prefix + "d3x3b/")))
    if pool_kind == "max":
        pool = nn.SpatialMaxPooling(3, 3, stride, stride,
                                    *(() if stride == 2 else (1, 1))).ceil()
    else:
        pool = nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil()
    if pp > 0:
        branches.append(nn.Sequential(
            pool, _conv_bn(n_in, pp, 1, name=prefix + "pool/")))
    else:
        branches.append(pool)
    return nn.Concat(4, *branches)


def build_v2(class_num: int = 1000, has_dropout: bool = True) -> nn.Sequential:
    """BN-Inception (reference: models/inception/Inception_v2.scala —
    channel configs per inception_3a..5b of that graph)."""
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                              w_init=Xavier()).set_name("conv1/7x7_s2"),
        nn.SpatialBatchNormalization(64, eps=1e-3),
        nn.ReLU(),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        _conv_bn(64, 64, 1, name="conv2/3x3_reduce/"),
        _conv_bn(64, 192, 3, pad=1, name="conv2/3x3/"),
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        inception_layer_v2(192, ((64,), (64, 64), (64, 96), ("avg", 32)), "3a/"),
        inception_layer_v2(256, ((64,), (64, 96), (64, 96), ("avg", 64)), "3b/"),
        inception_layer_v2(320, ((0,), (128, 160), (64, 96), ("max", 0)), "3c/"),
        inception_layer_v2(576, ((224,), (64, 96), (96, 128), ("avg", 128)), "4a/"),
        inception_layer_v2(576, ((192,), (96, 128), (96, 128), ("avg", 128)), "4b/"),
        inception_layer_v2(576, ((160,), (128, 160), (128, 160), ("avg", 96)), "4c/"),
        inception_layer_v2(576, ((96,), (128, 192), (160, 192), ("avg", 96)), "4d/"),
        inception_layer_v2(576, ((0,), (128, 192), (192, 256), ("max", 0)), "4e/"),
        inception_layer_v2(1024, ((352,), (192, 320), (160, 224), ("avg", 128)), "5a/"),
        inception_layer_v2(1024, ((352,), (192, 320), (192, 224), ("max", 128)), "5b/"),
        nn.SpatialAveragePooling(7, 7, 1, 1),
    )
    if has_dropout:
        m.add(nn.Dropout(0.4))
    m.add(nn.Reshape([1024]))
    m.add(nn.Linear(1024, class_num).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m


Inception_v2 = build_v2
