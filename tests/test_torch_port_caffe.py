"""The port's Caffe interop (bigdl_tpu_torch/utils/caffe/) against the JAX
package's (bigdl_tpu/utils/caffe/), case for case with
tests/test_caffe_interop.py, on the CPU.

Both loaders read the same files (built with the JAX package's protoc
module or written by its persister). The checks:
- imported variables are equal bit for bit, key path for key path
  (`models/convert.variables_from_jax` maps one tree onto the other);
- forward outputs agree within 1e-5 (fp32, atol and rtol);
- each refusal is the same exception with the same message;
- prototxt-only loads (fresh init: the port's draws are its own) agree
  in key paths, shapes and `unmatched`, and, given the JAX package's
  variables, in outputs;
- both persisters' files parse with `google.protobuf` to equal messages
  (the caffemodel binary, the prototxt through `text_format`).

Named apart from tests/test_caffe_interop.py, the JAX package's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import text_format

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.caffe import bigdl_caffe_pb2 as gpb
from bigdl_tpu.utils.caffe import loader as jcaffe
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models.convert import (tree_leaves_with_path,
                                            variables_from_jax)
from bigdl_tpu_torch.utils import caffe as pcaffe

TOL = dict(atol=1e-5, rtol=1e-5)


def _blob(layer, arr):
    b = layer.blobs.add()
    b.shape.dim.extend(arr.shape)
    b.data.extend(np.asarray(arr, np.float32).ravel().tolist())


def _layer(net, name, type_, bottoms, top=None):
    l = net.layer.add()
    l.name, l.type = name, type_
    l.bottom.extend(bottoms)
    l.top.append(top or name)
    return l


def _simple(rng, net=None):
    """conv(3, 3x3, pad 1) → relu → maxpool 2 → fc(10) → softmax over
    1x2x8x8 (tests/test_caffe_interop.py's _simple_net)."""
    net = net or gpb.NetParameter()
    net.name = "tiny"
    net.input.append("data")
    net.input_shape.add().dim.extend([1, 2, 8, 8])
    conv = _layer(net, "conv1", "Convolution", ["data"])
    cp = conv.convolution_param
    cp.num_output = 3
    cp.kernel_size.append(3)
    cp.pad.append(1)
    cp.stride.append(1)
    _blob(conv, rng.standard_normal((3, 2, 3, 3)))
    _blob(conv, rng.standard_normal(3))
    _layer(net, "relu1", "ReLU", ["conv1"], "conv1")
    pool = _layer(net, "pool1", "Pooling", ["conv1"])
    pool.pooling_param.pool = gpb.PoolingParameter.MAX
    pool.pooling_param.kernel_size = 2
    pool.pooling_param.stride = 2
    fc = _layer(net, "fc1", "InnerProduct", ["pool1"])
    fc.inner_product_param.num_output = 10
    _blob(fc, rng.standard_normal((10, 48)))
    _blob(fc, rng.standard_normal(10))
    _layer(net, "prob", "Softmax", ["fc1"])
    return net


def _v1(rng):
    net = gpb.NetParameter()
    net.name = "v1net"
    net.input.append("data")
    net.input_dim.extend([1, 3, 4, 4])
    fc = net.layers.add()
    fc.name, fc.type = "ip", gpb.V1LayerParameter.INNER_PRODUCT
    fc.bottom.append("data")
    fc.top.append("ip")
    fc.inner_product_param.num_output = 5
    _blob(fc, rng.standard_normal((5, 48)))
    _blob(fc, rng.standard_normal(5))
    sm = net.layers.add()
    sm.name, sm.type = "prob", gpb.V1LayerParameter.SOFTMAX
    sm.bottom.append("ip")
    sm.top.append("prob")
    return net


def _bn_scale_eltwise_concat(rng):
    net = gpb.NetParameter()
    net.input.append("data")
    net.input_shape.add().dim.extend([2, 4, 5, 5])
    bn = _layer(net, "bn", "BatchNorm", ["data"])
    _blob(bn, rng.standard_normal(4))
    _blob(bn, np.abs(rng.standard_normal(4)) + 0.5)
    _blob(bn, np.asarray([2.0]))           # moving-average scale factor
    sc = _layer(net, "scale", "Scale", ["bn"])
    sc.scale_param.bias_term = True
    _blob(sc, rng.standard_normal(4))
    _blob(sc, rng.standard_normal(4))
    _layer(net, "sum", "Eltwise", ["scale", "data"])
    _layer(net, "cat", "Concat", ["sum", "data"])
    return net


def _transpose_ip(rng):
    net = gpb.NetParameter()
    net.input.append("data")
    net.input_shape.add().dim.extend([1, 6])
    fc = _layer(net, "fc", "InnerProduct", ["data"])
    fc.inner_product_param.num_output = 4
    fc.inner_product_param.transpose = True
    _blob(fc, rng.standard_normal((6, 4)))
    _blob(fc, rng.standard_normal(4))
    return net


def _accuracy(rng):
    net = _simple(rng)
    _layer(net, "accuracy", "Accuracy", ["prob", "label"])
    return net


def _concat_negative(rng):
    net = gpb.NetParameter()
    net.input.append("a")
    net.input_shape.add().dim.extend([1, 2, 4, 4])
    net.input.append("b")
    net.input_shape.add().dim.extend([1, 3, 4, 4])
    cat = _layer(net, "cat", "Concat", ["a", "b"])
    cat.concat_param.axis = -3
    return net


def _deconv(rng, group=1, dilation=1):
    net = gpb.NetParameter()
    net.name = "deconv_net"
    net.input.append("data")
    c_in = 3 if group == 1 else 4
    net.input_shape.add().dim.extend([1, c_in, 5, 5])
    dc = _layer(net, "up1", "Deconvolution", ["data"])
    cp = dc.convolution_param
    n_out = 4 if group == 1 else 6
    k = 4 if group == 1 else 3
    cp.num_output = n_out
    cp.kernel_size.append(k)
    cp.stride.append(2)
    cp.pad.append(1)
    if group > 1:
        cp.group = group
    if dilation > 1:
        cp.dilation.append(dilation)
    _blob(dc, rng.standard_normal((c_in, n_out // group, k, k)))
    _blob(dc, rng.standard_normal(n_out))
    return net


def _dilated_lrn_pool(rng):
    """The converters the JAX tests reach only through the persister:
    a dilated convolution, LRN, Dropout, Power, leaky ReLU, TanH,
    Sigmoid, average and global pooling, Flatten, Eltwise PROD/MAX."""
    net = gpb.NetParameter()
    net.input.append("data")
    net.input_shape.add().dim.extend([2, 3, 9, 9])
    conv = _layer(net, "dil", "Convolution", ["data"])
    cp = conv.convolution_param
    cp.num_output = 4
    cp.kernel_size.append(3)
    cp.dilation.append(2)
    cp.pad.append(2)
    _blob(conv, rng.standard_normal((4, 3, 3, 3)))
    _blob(conv, rng.standard_normal(4))
    lrn = _layer(net, "lrn", "LRN", ["dil"])
    lrn.lrn_param.local_size = 3
    lrn.lrn_param.alpha = 1e-2
    _layer(net, "drop", "Dropout", ["lrn"])
    pw = _layer(net, "pw", "Power", ["drop"])
    pw.power_param.scale = 0.5
    pw.power_param.shift = 0.25
    lk = _layer(net, "leaky", "ReLU", ["pw"])
    lk.relu_param.negative_slope = 0.1
    _layer(net, "th", "TanH", ["leaky"])
    _layer(net, "sg", "Sigmoid", ["leaky"])
    prod = _layer(net, "prod", "Eltwise", ["th", "sg"])
    prod.eltwise_param.operation = gpb.EltwiseParameter.PROD
    mx = _layer(net, "mx", "Eltwise", ["prod", "th"])
    mx.eltwise_param.operation = gpb.EltwiseParameter.MAX
    ave = _layer(net, "ave", "Pooling", ["mx"])
    ave.pooling_param.pool = gpb.PoolingParameter.AVE
    ave.pooling_param.kernel_size = 3
    ave.pooling_param.stride = 2
    gp = _layer(net, "gp", "Pooling", ["ave"])
    gp.pooling_param.global_pooling = True
    _layer(net, "flat", "Flatten", ["gp"])
    return net


LOADS = {
    # name: (net builder, write prototxt?, load kwargs, input shapes)
    "binary_caffemodel": (_simple, False, {}, [(2, 8, 8, 2)]),
    "prototxt_plus_model_nchw": (_simple, True, {"input_layout": "NCHW"},
                                 [(2, 2, 8, 8)]),
    "v1_legacy_layers": (_v1, False, {}, [(1, 4, 4, 3)]),
    "batchnorm_scale_eltwise_concat": (_bn_scale_eltwise_concat, False, {},
                                       [(2, 5, 5, 4)]),
    "inner_product_transpose": (_transpose_ip, False, {}, [(3, 6)]),
    "accuracy_keeps_output": (_accuracy, False, {}, [(1, 8, 8, 2)]),
    "concat_negative_axis": (_concat_negative, False, {},
                             [(1, 4, 4, 2), (1, 4, 4, 3)]),
    "deconvolution": (_deconv, False, {}, [(2, 5, 5, 3)]),
    "grouped_dilated_deconvolution": (
        lambda rng: _deconv(rng, group=2, dilation=2), False, {},
        [(2, 5, 5, 4)]),
    "dilated_lrn_pool_eltwise": (_dilated_lrn_pool, True, {},
                                 [(2, 9, 9, 3)]),
}


def _write(tmp_path, net, prototxt):
    mp = tmp_path / "m.caffemodel"
    mp.write_bytes(net.SerializeToString())
    kw = {"model_path": str(mp)}
    if prototxt:
        arch = gpb.NetParameter()
        arch.CopyFrom(net)
        for l in arch.layer:
            del l.blobs[:]
        dp = tmp_path / "m.prototxt"
        dp.write_text(text_format.MessageToString(arch))
        kw["def_path"] = str(dp)
    return kw


def _assert_same_variables(tv, jv, exact=True):
    want = variables_from_jax(jax.device_get(jv), device="cpu")
    got = tree_leaves_with_path(tv)
    ref = tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if exact:
            assert torch.equal(a, b), path


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
    build, prototxt, extra, shapes = LOADS[case]
    kw = _write(tmp_path, build(np.random.default_rng(0)), prototxt)
    jl = jcaffe.CaffeLoader(**kw, **extra)
    jm, jv = jl.load()
    tl = pcaffe.CaffeLoader(**kw, **extra, device="cpu")
    tm, tv = tl.load()
    assert type(tm).__name__ == type(jm).__name__
    assert tl.unmatched == jl.unmatched == []
    _assert_same_variables(tv, jv)
    _forward(jm, jv, tm, tv, shapes, 1)


def test_prototxt_only_fresh_init(tmp_path):
    net = _simple(np.random.default_rng(8))
    for l in net.layer:
        del l.blobs[:]
    dp = tmp_path / "arch.prototxt"
    dp.write_text(text_format.MessageToString(net))
    jl = jcaffe.CaffeLoader(def_path=str(dp))
    jm, jv = jl.load()
    tl = pcaffe.CaffeLoader(def_path=str(dp), device="cpu")
    tm, tv = tl.load()
    assert set(tl.unmatched) == set(jl.unmatched) == {"conv1", "fc1"}
    _assert_same_variables(tv, jv, exact=False)
    # the port's own seeded init, and the JAX package's draws through it
    again, _ = pcaffe.CaffeLoader(def_path=str(dp), device="cpu").load()
    out = _forward(jm, jv, tm, variables_from_jax(jax.device_get(jv),
                                                  device="cpu"),
                   [(2, 8, 8, 2)], 2)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)
    with torch.no_grad():
        a, _ = tm.apply(tv, torch.ones(1, 8, 8, 2))
        b, _ = again.apply(
            pcaffe.CaffeLoader(def_path=str(dp), device="cpu").load()[1],
            torch.ones(1, 8, 8, 2))
    assert torch.equal(a, b)


def _unsupported(rng):
    net = gpb.NetParameter()
    net.input.append("data")
    net.input_shape.add().dim.extend([1, 2, 3, 3])
    _layer(net, "mystery", "FancyNewLayer", ["data"], "out")
    return net


def _within_channel_lrn(rng):
    net = _unsupported(rng)
    l = net.layer[0]
    l.type = "LRN"
    l.lrn_param.norm_region = gpb.LRNParameter.WITHIN_CHANNEL
    return net


def _eltwise_coeff(rng):
    net = _concat_negative(rng)
    net.input_shape[1].dim[1] = 2
    e = _layer(net, "e", "Eltwise", ["a", "b"])
    e.eltwise_param.coeff.extend([0.5, 2.0])
    return net


def _reshape_3d(rng):
    net = _unsupported(rng)
    l = net.layer[0]
    l.type = "Reshape"
    l.reshape_param.shape.dim.extend([0, 2, -1])
    return net


def _no_bottom(rng):
    net = _unsupported(rng)
    net.layer[0].type = "ReLU"
    net.layer[0].bottom[0] = "nowhere"
    return net


@pytest.mark.parametrize("build, exc, match", [
    (_unsupported, NotImplementedError, "FancyNewLayer"),
    (_within_channel_lrn, NotImplementedError, "WITHIN_CHANNEL"),
    (_eltwise_coeff, NotImplementedError, "coeff"),
    (_reshape_3d, NotImplementedError, "only flatten forms"),
    (_no_bottom, ValueError, "unknown bottoms"),
], ids=["unsupported", "within_channel_lrn", "eltwise_coeff",
        "reshape_3d", "unknown_bottom"])
def test_refusals_are_the_same(build, exc, match, tmp_path):
    kw = _write(tmp_path, build(np.random.default_rng(0)), False)
    with pytest.raises(exc, match=match) as jerr:
        jcaffe.load(**kw)
    with pytest.raises(exc, match=match) as terr:
        pcaffe.load(**kw, device="cpu")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ persisters


def _seq_model(nn):
    seq = nn.Sequential()
    seq.add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1).set_name("c1"))
    seq.add(nn.ReLU().set_name("r1"))
    seq.add(nn.SpatialMaxPooling(2, 2, 2, 2).set_name("p1"))
    flat = nn.Sequential()   # named: default names count modules made
    flat.add(nn.Transpose(((2, 4), (3, 4))).set_name("flat"))
    flat.add(nn.Reshape((-1,), batch_mode=True))
    seq.add(flat)
    seq.add(nn.Linear(4 * 3 * 3, 7).set_name("fc"))
    seq.add(nn.SoftMax().set_name("prob"))
    return seq, (1, 3, 6, 6), (2, 6, 6, 3)


def _graph_model(nn):
    x = nn.Input()
    c1 = nn.SpatialConvolution(2, 3, 1, 1).set_name("b1")(x)
    c2 = nn.SpatialConvolution(2, 3, 1, 1).set_name("b2")(x)
    cat = nn.JoinTable(dimension=4, n_input_dims=4).set_name("cat")(c1, c2)
    s = nn.CAddTable().set_name("add")(cat, cat)
    return nn.Graph(x, s), (1, 2, 4, 4), (2, 4, 4, 2)


def _floor_pool_model(nn):
    return nn.Sequential(
        nn.SpatialConvolution(2, 3, 3, 3).set_name("c"),
        nn.SpatialMaxPooling(2, 2, 2, 2, ceil_mode=False).set_name("p"),
    ), (1, 7, 7, 2), (1, 7, 7, 2)


def _bn_layers_model(nn):
    """BatchNorm (affine: + Scale), CMul, CAdd, Identity, LRN, Power,
    leaky ReLU, a dilated convolution and global pooling halves through
    the persister."""
    return nn.Sequential(
        nn.SpatialDilatedConvolution(3, 4, 3, 3, 1, 1, 2, 2, 2, 2)
        .set_name("dil"),
        nn.SpatialBatchNormalization(4).set_name("bn"),
        nn.CMul((4,)).set_name("cm"), nn.CAdd((4,)).set_name("ca"),
        nn.Identity().set_name("id"),
        nn.SpatialCrossMapLRN(3, 1e-2, 0.75, 1.0).set_name("lrn"),
        nn.Power(1.0, 0.5, 0.25).set_name("pw"),
        nn.LeakyReLU(0.1).set_name("leaky"),
        nn.SpatialAveragePooling(3, 3, 2, 2).set_name("ave"),
        nn.Mean(dimension=2, squeeze=False).set_name("gh"),
        nn.Mean(dimension=3, squeeze=False).set_name("gw"),
    ), (1, 3, 9, 9), (2, 9, 9, 3)


PERSISTS = {"sequential": _seq_model, "graph_branches": _graph_model,
            "floor_pooling": _floor_pool_model,
            "bn_and_friends": _bn_layers_model}


@pytest.mark.parametrize("case", sorted(PERSISTS))
def test_both_persisters_write_equal_messages(case, tmp_path):
    jm, in_shape, x_shape = PERSISTS[case](jnn)
    tm, _, _ = PERSISTS[case](pnn)
    jv = jm.init(jax.random.PRNGKey(7))
    if case == "bn_and_friends":        # non-trivial running statistics
        jv["state"]["1_bn"] = {
            "running_mean": jnp.linspace(-1.0, 1.0, 4),
            "running_var": jnp.linspace(0.5, 2.0, 4)}
    tv = variables_from_jax(jax.device_get(jv), device="cpu")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jcaffe.persist(str(jdir / "m.prototxt"), str(jdir / "m.caffemodel"),
                   jm, jv, in_shape)
    pcaffe.persist(str(tdir / "m.prototxt"), str(tdir / "m.caffemodel"),
                   tm, tv, in_shape)
    a, b = gpb.NetParameter(), gpb.NetParameter()
    a.ParseFromString((tdir / "m.caffemodel").read_bytes())
    b.ParseFromString((jdir / "m.caffemodel").read_bytes())
    assert a == b
    a, b = gpb.NetParameter(), gpb.NetParameter()
    text_format.Merge((tdir / "m.prototxt").read_text(), a)
    text_format.Merge((jdir / "m.prototxt").read_text(), b)
    assert a == b and not any(l.blobs for l in a.layer)
    # the JAX package's files through both loaders, and the port's
    # reload against the module it saved
    kw = {"def_path": str(jdir / "m.prototxt"),
          "model_path": str(jdir / "m.caffemodel")}
    jl, jlv = jcaffe.load(**kw)
    tl, tlv = pcaffe.load(**kw, device="cpu")
    _assert_same_variables(tlv, jlv)
    out = _forward(jl, jlv, tl, tlv, [x_shape], 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        x_shape).astype(np.float32))
    with torch.no_grad():
        want, _ = tm.apply(tv, x, training=False)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


def test_persister_refusals_are_the_same(tmp_path):
    def asym(nn):
        return nn.Sequential(nn.SpatialConvolution(
            3, 4, 2, 2, 2, 2, pad_w=(0, 1), pad_h=(0, 1)).set_name("s2d"))

    def non_flatten(nn):
        return nn.Sequential(nn.Transpose([(2, 3)]).set_name("t"),
                             nn.Reshape((4, -1)).set_name("r"))

    for build, exc, match, shape in (
            (asym, ValueError, "asymmetric", (1, 3, 8, 8)),
            (non_flatten, NotImplementedError, "no converter for Transpose",
             (1, 2, 2, 4))):
        jm, tm = build(jnn), build(pnn)
        jv = jm.init(jax.random.PRNGKey(0))
        tv = variables_from_jax(jax.device_get(jv), device="cpu")
        with pytest.raises(exc, match=match) as jerr:
            jcaffe.persist(str(tmp_path / "j.prototxt"),
                           str(tmp_path / "j.caffemodel"), jm, jv, shape)
        with pytest.raises(exc, match=match) as terr:
            pcaffe.persist(str(tmp_path / "t.prototxt"),
                           str(tmp_path / "t.caffemodel"), tm, tv, shape)
        assert str(terr.value) == str(jerr.value)


def test_dropout_persists_its_ratio(tmp_path):
    """The JAX persister reads `Dropout.init_p`, which its Dropout does
    not have (bigdl_tpu/utils/caffe/loader.py:790), so no model with a
    Dropout exports; the port writes the ratio, as the reference's
    CaffePersister does, and reloads it (ROADMAP.md §C, seen in the
    reference)."""
    def build(nn):
        return nn.Sequential(nn.Linear(6, 4).set_name("fc"),
                             nn.Dropout(0.25).set_name("drop"))

    jm, tm = build(jnn), build(pnn)
    jv = jm.init(jax.random.PRNGKey(0))
    tv = variables_from_jax(jax.device_get(jv), device="cpu")
    with pytest.raises(AttributeError, match="init_p"):
        jcaffe.persist(str(tmp_path / "j.prototxt"),
                       str(tmp_path / "j.caffemodel"), jm, jv, (1, 6))
    kw = {"def_path": str(tmp_path / "t.prototxt"),
          "model_path": str(tmp_path / "t.caffemodel")}
    pcaffe.persist(kw["def_path"], kw["model_path"], tm, tv, (1, 6))
    net = gpb.NetParameter()
    net.ParseFromString((tmp_path / "t.caffemodel").read_bytes())
    assert [l.type for l in net.layer] == ["InnerProduct", "Dropout"]
    assert net.layer[1].dropout_param.dropout_ratio == 0.25
    for loader, dev in ((jcaffe.load, {}), (pcaffe.load,
                                            {"device": "cpu"})):
        m, _ = loader(**kw, **dev)
        drop = m._order[-1].module
        assert type(drop).__name__ == "Dropout" and drop.p == 0.25


def test_loader_places_variables_on_the_device(tmp_path):
    kw = _write(tmp_path, _simple(np.random.default_rng(0)), False)
    _, tv = pcaffe.load(**kw, device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for _, t in tree_leaves_with_path(tv))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pcaffe.load(**kw)
