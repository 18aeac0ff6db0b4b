"""The port's TensorFlow interop (bigdl_tpu_torch/utils/tf/) against the
JAX package's (bigdl_tpu/utils/tf/), on the CPU.

tests/test_tf_interop.py, the JAX package's own, skips without
TensorFlow, so these GraphDefs are built here: through the JAX
package's protoc messages (`bigdl_tf_pb2`), op for op as
tf.compat.v1 freezes them, and through the JAX saver. The cases are
test_tf_interop.py's (an MLP, a CNN with FusedBatchNorm, depthwise
convolution and average pooling, branches with ConcatV2 and Mean, the
saver round trips, the NHWC guard) and the converters a frozen
MobileNet reaches (folded constant arithmetic of a decomposed batch
norm, Relu6, Pad, Squeeze, ExpandDims, LRN, bf16 and splat constants).
The checks: imported variables equal bit for bit, forward outputs
within 1e-5 (fp32), each refusal the same exception and message, and
both savers' GraphDefs equal as `google.protobuf` messages.

Named apart from tests/test_tf_interop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import tf as jtf
from bigdl_tpu.utils.tf import bigdl_tf_pb2 as gpb
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models.convert import (tree_leaves_with_path,
                                            variables_from_jax)
from bigdl_tpu_torch.utils import tf as ptf
from bigdl_tpu_torch.utils.tf.loader import _require_nhwc

TOL = dict(atol=1e-5, rtol=1e-5)


class _G:
    """A GraphDef under construction, as tf.compat.v1 freezes one."""

    def __init__(self):
        self.gd = gpb.GraphDef()
        self.gd.versions.producer = 27

    def node(self, name, op, inputs=(), t=gpb.DT_FLOAT, **attrs):
        n = self.gd.node.add()
        n.name, n.op = name, op
        n.input.extend(inputs)
        if t is not None:
            n.attr["T"].type = t
        for k, v in attrs.items():
            a = n.attr[k]
            if isinstance(v, bool):
                a.b = v
            elif isinstance(v, bytes):
                a.s = v
            elif isinstance(v, float):
                a.f = v
            elif isinstance(v, int):
                a.i = v
            else:
                a.list.i.extend(v)
        return name

    def placeholder(self, name, shape):
        n = self.gd.node.add()
        n.name, n.op = name, "Placeholder"
        n.attr["dtype"].type = gpb.DT_FLOAT
        for d in shape:
            n.attr["shape"].shape.dim.add().size = d
        return name

    def const(self, name, arr, how="content"):
        arr = np.asarray(arr)
        dt = {np.dtype(np.float32): gpb.DT_FLOAT,
              np.dtype(np.int32): gpb.DT_INT32,
              np.dtype(np.int64): gpb.DT_INT64}[arr.dtype]
        n = self.gd.node.add()
        n.name, n.op = name, "Const"
        n.attr["dtype"].type = dt if how != "bf16" else gpb.DT_BFLOAT16
        t = n.attr["value"].tensor
        t.dtype = n.attr["dtype"].type
        for d in arr.shape:
            t.tensor_shape.dim.add().size = d
        if how == "content":
            t.tensor_content = arr.tobytes()
        elif how == "bf16":
            t.tensor_content = (arr.astype(np.float32).view(np.uint32)
                                >> 16).astype(np.uint16).tobytes()
        elif how == "splat":
            getattr(t, {gpb.DT_FLOAT: "float_val", gpb.DT_INT32: "int_val",
                        gpb.DT_INT64: "int64_val"}[dt]).append(
                arr.ravel()[0].item())
        else:
            getattr(t, {gpb.DT_FLOAT: "float_val", gpb.DT_INT32: "int_val",
                        gpb.DT_INT64: "int64_val"}[dt]).extend(
                arr.ravel().tolist())
        return name

    def write(self, path):
        path.write_bytes(self.gd.SerializeToString())
        return str(path)


def _w(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mlp(rng, g):
    x = g.placeholder("input", [-1, 10])
    h = g.node("MatMul", "MatMul", [x, g.const("w1", _w(rng, 10, 16))],
               transpose_a=False, transpose_b=False)
    h = g.node("BiasAdd", "BiasAdd", [h, g.const("b1", _w(rng, 16))],
               data_format=b"NHWC")
    h = g.node("h", "Relu", [h])
    h = g.node("MatMul_1", "MatMul", [h, g.const("w2", _w(rng, 4, 16))],
               transpose_a=False, transpose_b=True)
    h = g.node("BiasAdd_1", "BiasAdd", [h, g.const("b2", _w(rng, 4),
                                                   how="list")])
    g.node("prob", "Softmax", [h])
    return [(3, 10)]


def _cnn(rng, g):
    x = g.placeholder("input", [-1, 8, 8, 2])
    h = g.node("Conv2D", "Conv2D", [x, g.const("wc", _w(rng, 3, 3, 2, 5,
                                                         scale=0.3))],
               strides=[1, 1, 1, 1], padding=b"SAME", data_format=b"NHWC",
               dilations=[1, 1, 1, 1])
    h = g.node("BiasAdd", "BiasAdd", [h, g.const("bc", _w(rng, 5))])
    h = g.node("FusedBatchNormV3", "FusedBatchNormV3", [
        h, g.const("scale", rng.uniform(0.5, 1.5, 5).astype(np.float32)),
        g.const("offset", _w(rng, 5)), g.const("mean", _w(rng, 5)),
        g.const("var", rng.uniform(0.5, 2.0, 5).astype(np.float32))],
        epsilon=1e-3, is_training=False, data_format=b"NHWC")
    h = g.node("Relu", "Relu", [h])
    h = g.node("MaxPool", "MaxPool", [h], ksize=[1, 2, 2, 1],
               strides=[1, 2, 2, 1], padding=b"VALID", data_format=b"NHWC")
    h = g.node("Reshape", "Reshape", [h, g.const(
        "shape", np.asarray([-1, 80], np.int32))], Tshape=gpb.DT_INT32)
    g.node("logits", "MatMul", [h, g.const("wf", _w(rng, 80, 7,
                                                      scale=0.2))])
    return [(2, 8, 8, 2)]


def _depthwise_avgpool(rng, g):
    x = g.placeholder("input", [-1, 6, 6, 4])
    h = g.node("depthwise", "DepthwiseConv2dNative", [
        x, g.const("wd", _w(rng, 3, 3, 4, 2, scale=0.4))],
        strides=[1, 1, 1, 1], padding=b"SAME")
    g.node("out", "AvgPool", [h], ksize=[1, 2, 2, 1],
           strides=[1, 2, 2, 1], padding=b"SAME")
    return [(2, 6, 6, 4)]


def _branches(rng, g):
    x = g.placeholder("input", [-1, 4, 4, 3])
    a = g.node("Relu", "Relu", [x])
    b = g.node("Tanh", "Tanh", [x])
    c = g.node("concat", "ConcatV2", [a, b, g.const(
        "concat/axis", np.asarray(3, np.int32))], N=2, Tidx=gpb.DT_INT32)
    g.node("gap", "Mean", [c, g.const("axes", np.asarray([1, 2],
                                                         np.int32))],
           keep_dims=False)
    return [(2, 4, 4, 3)]


def _mobilenet_ops(rng, g):
    """The ops a frozen keras MobileNet carries: Pad, a dilated Conv2D
    with bf16 weights, a batch norm decomposed into Rsqrt/Mul/Sub over
    constants (folded at load), Relu6, Identity, LeakyRelu, Maximum,
    scalar arithmetic, LRN, Mean with keep_dims, Squeeze, ExpandDims,
    a splat constant and a legacy Concat."""
    x = g.placeholder("input", [-1, 7, 7, 3])
    p = g.node("pad", "Pad", [x, g.const("paddings", np.asarray(
        [[0, 0], [1, 1], [2, 0], [0, 0]], np.int32))],
        Tpaddings=gpb.DT_INT32)
    w = _w(rng, 3, 3, 3, 4, scale=0.4)
    h = g.node("conv", "Conv2D", [p, g.const("w", w, how="bf16")],
               strides=[1, 1, 1, 1], padding=b"VALID",
               dilations=[1, 2, 2, 1])
    var = g.const("bn/var", rng.uniform(0.5, 2.0, 4).astype(np.float32))
    eps = g.const("bn/eps", np.asarray(1e-3, np.float32))
    r = g.node("bn/rsqrt", "Rsqrt", [g.node("bn/add", "AddV2", [var, eps])])
    sc = g.node("bn/mul", "Mul", [r, g.const("bn/gamma", _w(rng, 4))])
    h = g.node("bn/mul_1", "Mul", [h, sc])
    shift = g.node("bn/sub", "Sub", [g.const("bn/beta", _w(rng, 4)),
                                     g.node("bn/mul_2", "Mul", [
                                         g.const("bn/mean", _w(rng, 4)),
                                         sc])])
    h = g.node("bn/add_1", "AddV2", [h, shift])
    h = g.node("relu6", "Relu6", [h])
    h = g.node("ident", "Identity", [h])
    lk = g.node("leaky", "LeakyRelu", [h], alpha=0.2)
    h = g.node("max", "Maximum", [h, lk])
    h = g.node("scaled", "Mul", [h, g.const("half", np.asarray(
        0.5, np.float32))])
    h = g.node("shifted", "Sub", [h, g.const("quarter", np.full(
        (1,), 0.25, np.float32), how="splat")])
    h = g.node("lrn", "LRN", [h], depth_radius=1, alpha=1e-2, beta=0.75,
               bias=1.0)
    h = g.node("avg", "Mean", [h, g.const("hw", np.asarray([1, 2],
                                                        np.int32))],
               keep_dims=True)
    h = g.node("squeeze", "Squeeze", [h], squeeze_dims=[1, 2])
    h = g.node("expand", "ExpandDims", [h, g.const("ax", np.asarray(
        1, np.int32))])
    g.node("out", "Concat", [g.const("cat_axis", np.asarray(1, np.int32)),
                             h, h], N=2)
    return [(2, 7, 7, 3)]


LOADS = {"mlp": _mlp, "cnn_fused_bn": _cnn,
         "depthwise_avgpool": _depthwise_avgpool,
         "branches_concat_mean": _branches, "mobilenet_ops": _mobilenet_ops}


def _assert_same_variables(tv, jv):
    want = variables_from_jax(jax.device_get(jv), device="cpu")
    got, ref = tree_leaves_with_path(tv), tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _forward(jm, jv, tm, tv, shapes, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jout, _ = jm.apply(jv, *[jnp.asarray(x) for x in xs], training=False)
    with torch.no_grad():
        tout, _ = tm.apply(tv, *[torch.from_numpy(x) for x in xs],
                           training=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    return tout


@pytest.mark.parametrize("case", sorted(LOADS))
def test_both_loaders_agree(case, tmp_path):
    g = _G()
    shapes = LOADS[case](np.random.default_rng(0), g)
    path = g.write(tmp_path / "g.pb")
    jm, jv = jtf.load(path)
    tm, tv = ptf.load(path, device="cpu")
    assert [type(n.module).__name__ for n in tm._order] == \
        [type(n.module).__name__ for n in jm._order]
    _assert_same_variables(tv, jv)
    _forward(jm, jv, tm, tv, shapes, 1)


def test_named_inputs_and_outputs(tmp_path):
    g = _G()
    _branches(np.random.default_rng(0), g)
    path = g.write(tmp_path / "g.pb")
    for name in ("gap", "concat:0"):
        jm, jv = jtf.load(path, inputs=["input"], outputs=[name])
        tm, tv = ptf.load(path, inputs=["input"], outputs=[name],
                          device="cpu")
        _forward(jm, jv, tm, tv, [(2, 4, 4, 3)], 2)


def _bad(op_fn):
    def build(rng, g):
        x = g.placeholder("input", [-1, 4, 4, 3])
        op_fn(g, x)
    return build


REFUSALS = {
    "unknown_op": (_bad(lambda g, x: g.node("f", "FancyOp", [x])),
                   NotImplementedError, "FancyOp"),
    "nchw_conv": (_bad(lambda g, x: g.node("c", "Conv2D", [
        x, g.const("w", np.ones((1, 1, 3, 2), np.float32))],
        strides=[1, 1, 1, 1], padding=b"SAME", data_format=b"NCHW")),
        NotImplementedError, "only NHWC"),
    "matmul_transpose_a": (_bad(lambda g, x: g.node("m", "MatMul", [
        x, g.const("w", np.ones((3, 2), np.float32))], transpose_a=True,
        transpose_b=False)), NotImplementedError, "transpose_a"),
    "dynamic_reshape": (_bad(lambda g, x: g.node("r", "Reshape", [
        x, g.node("s", "Shape", [x])])), NotImplementedError,
        "dynamic shape"),
    "non_const_bn": (_bad(lambda g, x: g.node("bn", "FusedBatchNorm", [
        x, x, x, x, x], epsilon=1e-3)), NotImplementedError, "non-const"),
    "string_const": (_bad(lambda g, x: g.node("a", "Add", [x, g.node(
        "k", "Const", [], t=None, dtype=gpb.DT_STRING)])),
        NotImplementedError, "TF dtype"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_are_the_same(case, tmp_path):
    build, exc, match = REFUSALS[case]
    g = _G()
    build(np.random.default_rng(0), g)
    if case == "string_const":
        g.gd.node[-2].attr["value"].tensor.dtype = gpb.DT_STRING
    path = g.write(tmp_path / "g.pb")
    with pytest.raises(exc, match=match) as jerr:
        jtf.load(path)
    with pytest.raises(exc, match=match) as terr:
        ptf.load(path, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_nhwc_guard_on_node_views():
    class _Attr:
        def __init__(self, s):
            self.s = s

    class _Node:
        def __init__(self, fmt):
            self.name = "conv1"
            self.attr = {} if fmt is None else {"data_format": _Attr(fmt)}

    with pytest.raises(NotImplementedError, match="NHWC"):
        _require_nhwc(_Node(b"NCHW"))
    _require_nhwc(_Node(b"NHWC"))
    _require_nhwc(_Node(None))


# ------------------------------------------------------------ savers


def _lenet_like(nn):
    return nn.Sequential(
        nn.SpatialConvolution(1, 4, 5, 5).set_name("c1"),
        nn.Tanh().set_name("tanh"),
        nn.SpatialMaxPooling(2, 2, 2, 2).set_name("pool"),
        nn.Reshape([4 * 12 * 12]).set_name("flat"),
        nn.Linear(4 * 12 * 12, 10).set_name("fc"),
        nn.LogSoftMax().set_name("logp"),
    ), (1, 28, 28, 1), (2, 28, 28, 1)


def _branch_graph(nn):
    x = nn.Input()
    h = nn.SpatialConvolution(2, 3, 3, 3, 1, 1, -1, -1).set_name("c")(x)
    a = nn.ReLU().set_name("a")(h)
    b = nn.Tanh().set_name("b")(h)
    j = nn.CAddTable().set_name("j")(a, b)
    y = nn.SoftMax().set_name("sm")(nn.Reshape([3 * 16]).set_name("r")(j))
    return nn.Graph(x, y), (1, 4, 4, 2), (2, 4, 4, 2)


def _saver_zoo(nn):
    """The saver's other emitters: explicit conv padding (a Pad node),
    a dilated convolution, batch norm, SAME pooling, LRN, the element
    ops, dropout (an Identity) and a leaky ReLU."""
    x = nn.Input()
    h = nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1).set_name("c")(x)
    h = nn.SpatialBatchNormalization(4).set_name("bn")(h)
    h = nn.SpatialDilatedConvolution(4, 4, 3, 3, 1, 1, -1, -1, 2, 2) \
        .set_name("dil")(h)
    h = nn.SpatialCrossMapLRN(3, 1e-2, 0.75, 1.0).set_name("lrn")(h)
    h = nn.SpatialAveragePooling(2, 2, 2, 2, -1, -1).set_name("ave")(h)
    a = nn.ReLU6().set_name("r6")(h)
    b = nn.LeakyReLU(0.1).set_name("lk")(h)
    m = nn.CMaxTable().set_name("mx")(a, b)
    s = nn.CSubTable().set_name("sub")(m, a)
    p = nn.CMulTable().set_name("mul")(s, b)
    cat = nn.JoinTable(4).set_name("cat")(p, m)
    y = nn.CAdd((8,)).set_name("bias")(nn.Dropout(0.5).set_name("d")(cat))
    return nn.Graph(x, y), (1, 8, 8, 3), (2, 8, 8, 3)


SAVES = {"lenet_like": _lenet_like, "branch_graph": _branch_graph,
         "saver_zoo": _saver_zoo}


@pytest.mark.parametrize("case", sorted(SAVES))
def test_both_savers_write_equal_graphs(case, tmp_path):
    jm, in_shape, x_shape = SAVES[case](jnn)
    tm, _, _ = SAVES[case](pnn)
    jv = jm.init(jax.random.PRNGKey(0))
    tv = variables_from_jax(jax.device_get(jv), device="cpu")
    jpath, tpath = str(tmp_path / "j.pb"), str(tmp_path / "t.pb")
    jtf.save(jm, jv, jpath, in_shape)
    ptf.save(tm, tv, tpath, in_shape)
    a, b = gpb.GraphDef(), gpb.GraphDef()
    a.ParseFromString(open(tpath, "rb").read())
    b.ParseFromString(open(jpath, "rb").read())
    assert a == b
    jl, jlv = jtf.load(jpath)
    tl, tlv = ptf.load(jpath, device="cpu")
    _assert_same_variables(tlv, jlv)
    out = _forward(jl, jlv, tl, tlv, [x_shape], 4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x_shape).astype(np.float32))
    with torch.no_grad():
        want, _ = tm.apply(tv, x, training=False)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


def test_saver_refusals_are_the_same(tmp_path):
    for build, match in (
            (lambda nn: nn.Sequential(nn.SpatialMaxPooling(
                2, 2, 2, 2, 1, 1).set_name("p")), "explicitly-padded"),
            (lambda nn: nn.Sequential(nn.Sigmoid().set_name("s"),
                                      nn.Mean(2).set_name("m")),
             "TF export of Mean")):
        jm, tm = build(jnn), build(pnn)
        jv = jm.init(jax.random.PRNGKey(0))
        tv = variables_from_jax(jax.device_get(jv), device="cpu")
        with pytest.raises(NotImplementedError, match=match) as jerr:
            jtf.save(jm, jv, str(tmp_path / "j.pb"), (1, 4, 4, 3))
        with pytest.raises(NotImplementedError, match=match) as terr:
            ptf.save(tm, tv, str(tmp_path / "t.pb"), (1, 4, 4, 3))
        assert str(terr.value) == str(jerr.value)
