"""The port's INT8 layers (bigdl_tpu_torch/nn/quantized.py) against the
JAX package's (bigdl_tpu/nn/quantized.py), on the same seeded inputs
and weights.

The int8 x int8 products accumulate in int32 in both packages (here the
exact fp64 product on CPU tensors), so the accumulators are held bit
for bit, as are the quantized weights and activations; the fp32
outputs within 1e-6 of each output's largest entry. `quantize` keeps
the JAX tree's structure and keys, its int8 tree carries across with
`params_from_jax`, and the weights shrink as
tests/test_quantized.py:58 says (below 0.35 of the fp32 bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.serving.quant import quantize_weight

OUT_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _seeded(module, seed):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)


def test_quantize_weight_and_act_bitwise():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 4, 8).astype(np.float32)
    w[..., 5] = 0.0                       # an all-zero channel: the floor
    for axis in (0, (0, 1, 2), 3):
        jw, js = jq._quantize_weight(jnp.asarray(w), axis)
        tw, ts = tq._quantize_weight(torch.from_numpy(w), axis)
        assert tw.dtype == torch.int8 and ts.shape == js.shape
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        sw = quantize_weight(torch.from_numpy(w), axis)
        assert torch.equal(sw.q, tw) and torch.equal(sw.scale, ts)
    x = (rng.randn(5, 7) * 3).astype(np.float32)
    jx, jxs = jq._quantize_act(jnp.asarray(x))
    tx, txs = tq._quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert float(txs) == float(jxs)


def test_int8_matmul_is_exact():
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, (37, 4099)).astype(np.int8)
    b = rng.randint(-127, 128, (4099, 13)).astype(np.int8)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("with_bias", [True, False])
def test_quantized_linear_matches_jax(with_bias):
    jl = jnn.Linear(24, 10, with_bias=with_bias, name="fc")
    tl = tnn.Linear(24, 10, with_bias=with_bias, name="fc")
    jv = _seeded(jl, 2)
    tv = {"params": params_from_jax(jv, device="cpu"), "state": {}}
    jm, jqv = jq.QuantizedLinear.from_float(jl, jv)
    tm, tqv = tq.QuantizedLinear.from_float(tl, tv)
    for k in jqv["params"]:
        np.testing.assert_array_equal(tqv["params"][k].numpy(),
                                      np.asarray(jqv["params"][k]))
    x = np.random.RandomState(3).randn(2, 5, 24).astype(np.float32)
    xq, _ = jq._quantize_act(jnp.asarray(x))
    jacc = lax.dot_general(xq, jqv["params"]["qweight"],
                           (((2,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    tacc, _ = tm.accumulate(tqv, torch.from_numpy(x))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    jy, _ = jm.apply(jqv, jnp.asarray(x))
    ty, _ = tm.apply(tqv, torch.from_numpy(x))
    assert _rel(ty, jy) <= OUT_TOL


# name -> conv factory(nn), input shape (NHWC)
CONVS = {
    "plain": (lambda nn: nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
              (2, 9, 10, 3)),
    "strided_rect": (lambda nn: nn.SpatialConvolution(4, 6, 3, 5, 2, 1, 1,
                                                      2), (2, 11, 12, 4)),
    "same": (lambda nn: nn.SpatialConvolution(4, 8, 4, 4, 2, 2, -1),
             (2, 9, 10, 4)),
    "grouped": (lambda nn: nn.SpatialConvolution(8, 12, 3, 3, 1, 1, 1, 1,
                                                 n_group=4), (2, 7, 8, 8)),
    "asymmetric_pad": (lambda nn: nn.SpatialConvolution(
        4, 8, 4, 4, 1, 1, (2, 1), (2, 1), with_bias=False), (2, 8, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quantized_conv_matches_jax(case):
    factory, shape = CONVS[case]
    jc, tc = factory(jnn), factory(tnn)
    jv = _seeded(jc, 4)
    tv = {"params": params_from_jax(jv, device="cpu"), "state": {}}
    jm, jqv = jq.QuantizedSpatialConvolution.from_float(jc, jv)
    tm, tqv = tq.QuantizedSpatialConvolution.from_float(tc, tv)
    assert sorted(tqv["params"]) == sorted(jqv["params"])
    for k in jqv["params"]:
        np.testing.assert_array_equal(tqv["params"][k].numpy(),
                                      np.asarray(jqv["params"][k]))
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    xq, _ = jq._quantize_act(jnp.asarray(x))
    jacc = lax.conv_general_dilated(
        xq, jqv["params"]["qweight"], window_strides=(jc.stride_h,
                                                      jc.stride_w),
        padding=jc._pad(), dimension_numbers=jc._dn,
        feature_group_count=jc.n_group, preferred_element_type=jnp.int32)
    tacc, _ = tm.accumulate(tqv, torch.from_numpy(x))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    jy, _ = jm.apply(jqv, jnp.asarray(x))
    ty, _ = tm.apply(tqv, torch.from_numpy(x))
    assert _rel(ty, jy) <= OUT_TOL


def test_dilated_conv_is_quantized_with_its_dilation():
    """The port's twin keeps a dilated convolution's dilation (the JAX
    layer drops it): its accumulator is the fp64 dilated convolution of
    the int8 operands, exactly."""
    c = tnn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, dilation_w=2)
    v = c.init(torch.Generator().manual_seed(0), "cpu")
    m, qv = tq.quantize(c, v)
    x = torch.randn(2, 9, 9, 3, generator=torch.Generator().manual_seed(1))
    acc, _ = m.accumulate(qv, x)
    xq, _ = tq._quantize_act(x)
    want = torch.nn.functional.conv2d(
        xq.double().permute(0, 3, 1, 2),
        qv["params"]["qweight"].double().permute(3, 2, 0, 1), padding=2,
        dilation=2).permute(0, 2, 3, 1)
    assert torch.equal(acc, want.to(torch.int32))


def test_quantize_lenet_keeps_the_tree_and_the_predictions():
    """quantize() of LeNet-5 in both packages from the same weights: the
    same tree structure and keys, int8 leaves bit for bit, log-probs
    within 1e-6, most predictions those of the fp32 model, and weights
    below 0.35 of the fp32 bytes."""
    jmodel, tmodel = jlenet.build(10), tlenet.build(10)
    jv = _seeded(jmodel, 6)
    tv = {"params": params_from_jax(jv["params"], device="cpu"),
          "state": params_from_jax(jv["state"], device="cpu")}
    jqm, jqv = jq.quantize(jmodel, jv)
    tqm, tqv = tq.quantize(tmodel, tv)
    assert type(tqm) is tnn.Sequential and tqm._keys == tmodel._keys
    jpaths = [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jqv["params"])[0]]
    tpaths = [tuple(map(str, path))
              for path, _ in tree_leaves_with_path(tqv["params"])]
    assert tpaths == jpaths
    assert set(tqv["params"]) == set(jv["params"])
    for a, b in zip(tree_leaves(tqv["params"]),
                    jax.tree_util.tree_leaves(jqv["params"])):
        assert a.shape == b.shape and str(a.dtype).split(".")[-1] \
            == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the JAX int8 tree carries across as it is (int8 leaves kept)
    carried = params_from_jax(jax.device_get(jqv["params"]), device="cpu")
    for a, b in zip(tree_leaves(carried), tree_leaves(tqv["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    x = np.random.RandomState(7).randn(32, 28, 28, 1).astype(np.float32)
    jy, _ = jqm.apply(jqv, jnp.asarray(x))
    ty, _ = tqm.apply(tqv, torch.from_numpy(x))
    assert _rel(ty, jy) <= OUT_TOL
    ref, _ = tmodel.apply(tv, torch.from_numpy(x))
    agree = (ref.argmax(-1) == ty.argmax(-1)).float().mean().item()
    assert agree > 0.9

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    assert nbytes(tqv["params"]) < 0.35 * nbytes(tv["params"])
    assert any(t.dtype == torch.int8 for t in tree_leaves(tqv["params"]))
