"""The rest of the port's nn/ layers against the JAX package's: PReLU,
SReLU and RReLU (nn/activation.py); CMul, CAdd, Bilinear, Cosine and
Euclidean (nn/linear.py); MM, MV, DotProduct and CosineDistance
(nn/table_ops.py); the nearest and bilinear upsampling layers
(nn/upsampling.py); and the volumetric convolution and pooling layers
(nn/volumetric.py).

One parametrised test runs every layer through
tests/test_torch_cnn_layers.py's harness: seeded JAX variables carried
across with `variables_from_jax`, the same seeded inputs, the loss the
sum of each output times a seeded cotangent. Tolerances (fp32):
forward rtol 1e-4 / atol 1e-5, gradients (every parameter and input)
within 1e-4 of each gradient's largest entry. RReLU is compared in
evaluation (its training slopes are torch's draws, not threefry's);
in training its slopes lie in [lower, upper] and repeat with the
generator.
"""

import pytest
import torch

import test_torch_cnn_layers as cl
from bigdl_tpu_torch import nn as tnn

# name -> (factory(nn), input shapes, table packing)
LAYERS = {
    "prelu_shared": (lambda nn: nn.PReLU(), [(4, 5, 3)], None),
    "prelu_channel": (lambda nn: nn.PReLU(3), [(4, 5, 3)], None),
    "srelu": (lambda nn: nn.SReLU((5, 3)), [(4, 5, 3)], None),
    "rrelu_eval": (lambda nn: nn.RReLU(0.1, 0.4), [(4, 5, 3)], None),
    "cmul": (lambda nn: nn.CMul((1, 6)), [(4, 6)], None),
    "cadd": (lambda nn: nn.CAdd((6,)), [(4, 6)], None),
    "bilinear": (lambda nn: nn.Bilinear(4, 3, 5), [(6, 4), (6, 3)], "list"),
    "bilinear_table": (lambda nn: nn.Bilinear(4, 3, 5, with_bias=False),
                       [(6, 4), (6, 3)], "table"),
    "cosine": (lambda nn: nn.Cosine(6, 4), [(5, 6)], None),
    "euclidean": (lambda nn: nn.Euclidean(6, 4), [(5, 6)], None),
    "mm": (lambda nn: nn.MM(), [(2, 3, 4), (2, 4, 5)], "list"),
    "mm_trans": (lambda nn: nn.MM(True, True), [(2, 4, 3), (2, 5, 4)],
                 "list"),
    "mv": (lambda nn: nn.MV(), [(2, 3, 4), (2, 4)], "list"),
    "mv_trans": (lambda nn: nn.MV(True), [(2, 4, 3), (2, 4)], "list"),
    "dot_product": (lambda nn: nn.DotProduct(), [(5, 6), (5, 6)], "list"),
    "cosine_distance": (lambda nn: nn.CosineDistance(), [(5, 6), (5, 6)],
                        "table"),
    "upsample_nearest": (lambda nn: nn.SpatialUpSamplingNearest(2),
                         [(2, 3, 4, 2)], None),
    "upsample_bilinear_align": (lambda nn: nn.SpatialUpSamplingBilinear(2),
                                [(2, 3, 4, 2)], None),
    "upsample_bilinear_half": (lambda nn: nn.SpatialUpSamplingBilinear(
        3, align_corners=False), [(2, 3, 4, 2)], None),
    "volumetric_conv": (lambda nn: nn.VolumetricConvolution(
        3, 4, 3, 3, 3, 1, 1, 1, 1, 1, 1), [(2, 5, 6, 7, 3)], None),
    "volumetric_conv_strided": (lambda nn: nn.VolumetricConvolution(
        3, 4, 2, 3, 2, 2, 1, 2, 0, 1, 0, with_bias=False),
        [(2, 5, 6, 7, 3)], None),
    "volumetric_conv_same": (lambda nn: nn.VolumetricConvolution(
        3, 4, 3, 3, 3, 2, 2, 2, pad_w=-1), [(2, 5, 6, 7, 3)], None),
    "volumetric_max_pool": (lambda nn: nn.VolumetricMaxPooling(2, 2, 2),
                            [(2, 4, 6, 6, 3)], None),
    "volumetric_max_pool_padded": (lambda nn: nn.VolumetricMaxPooling(
        3, 3, 3, 2, 2, 2, 1, 1, 1), [(2, 5, 6, 7, 3)], None),
    "volumetric_avg_pool": (lambda nn: nn.VolumetricAveragePooling(
        2, 2, 2, 1, 2, 2), [(2, 4, 6, 6, 3)], None),
    "volumetric_avg_pool_padded": (lambda nn: nn.VolumetricAveragePooling(
        3, 2, 3, 2, 2, 1, 1, 0, 1), [(2, 5, 6, 7, 3)], None),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    factory, shapes, table = LAYERS[case]
    cl._run_case(factory, shapes, table=table)


def test_rrelu_training_slopes():
    """In training each negative input takes its own slope in [lower,
    upper], drawn from the generator (the same generator seed, the same
    slopes); positives pass; without an rng it raises."""
    m = tnn.RReLU(0.1, 0.4)
    x = -torch.rand(64, 32) - 0.5
    pos = torch.rand(64, 32)
    y, _ = m.apply({"params": {}, "state": {}}, x, training=True,
                   rng=torch.Generator().manual_seed(3))
    y2, _ = m.apply({"params": {}, "state": {}}, x, training=True,
                    rng=torch.Generator().manual_seed(3))
    slopes = y / x
    assert torch.equal(y, y2)
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() <= 0.4 + 1e-6
    assert slopes.std() > 0.05
    yp, _ = m.apply({"params": {}, "state": {}}, pos, training=True,
                    rng=torch.Generator().manual_seed(3))
    assert torch.equal(yp, pos)
    ye, _ = m.apply({"params": {}, "state": {}}, x)
    assert torch.allclose(ye, 0.25 * x)
    with pytest.raises(ValueError, match="needs an rng"):
        m.apply({"params": {}, "state": {}}, x, training=True)


def test_param_shapes_and_inits():
    """The JAX package's param names, shapes and initial values."""
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tnn.PReLU().init_params(g)["weight"],
                       torch.full((1,), 0.25))
    assert tnn.PReLU(7).init_params(g)["weight"].shape == (7,)
    s = tnn.SReLU((2, 3)).init_params(g)
    assert sorted(s) == ["a_left", "a_right", "t_left", "t_right"]
    assert torch.equal(s["t_right"], torch.ones(2, 3))
    assert tnn.Bilinear(4, 3, 5).init_params(g)["weight"].shape == (5, 4, 3)
    lim = 1 / 6 ** 0.5
    for m, shape in ((tnn.Cosine(6, 4), (4, 6)), (tnn.Euclidean(6, 4),
                                                  (6, 4))):
        w = m.init_params(g)["weight"]
        assert w.shape == shape and w.abs().max() <= lim
    v = tnn.VolumetricConvolution(3, 8, 1, 2, 3).init_params(g)
    assert v["weight"].shape == (1, 3, 2, 3, 8) and not v["bias"].any()
    assert torch.equal(tnn.CMul((2, 3)).init_params(g)["weight"],
                       torch.ones(2, 3))
