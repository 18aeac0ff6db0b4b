"""The port's Torch7 `.t7` reader and writer (bigdl_tpu_torch/utils/
torch_file.py) against the wire format and against the JAX package's.

Named apart from tests/test_torch_file.py, the JAX package's own test of
bigdl_tpu/utils/torch_file.py, whose byte-packing helpers this file
imports: the hand-authored fixtures check the reader against the wire
format itself. Files move both ways: a module (and its weights) the JAX
package writes loads in the port with the weights equal bit for bit and
the outputs within fp32 rtol 1e-5, atol 1e-6; one the port writes loads
in the JAX package alike; the port's own round trip is bitwise."""

import jax
import numpy as np
import pytest
import torch

import test_torch_file as t7fix
from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import torch_file as jtf
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models.convert import tree_leaves, variables_from_jax
from bigdl_tpu_torch.utils.torch_file import TorchObject, load_t7, save_t7

FWD = dict(rtol=1e-5, atol=1e-6)
_i, _l, _d, _s = t7fix._i, t7fix._l, t7fix._d, t7fix._s


def test_load_hand_authored_bytes(tmp_path):
    """A Sequential{Linear(3->2), ReLU} .t7 built byte by byte."""
    w = np.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    b = np.asarray([0.5, -0.5], np.float32)
    linear = _i(4) + _i(10) + _s("V 1") + _s("nn.Linear")
    linear += _i(3) + _i(11) + _i(2)
    linear += _i(2) + _s("weight") + t7fix._float_tensor(12, w)
    linear += _i(2) + _s("bias") + t7fix._float_tensor(14, b)
    relu = _i(4) + _i(20) + _s("V 1") + _s("nn.ReLU")
    relu += _i(3) + _i(21) + _i(0)
    modules = _i(3) + _i(30) + _i(2)
    modules += _i(1) + _d(1) + linear
    modules += _i(1) + _d(2) + relu
    seq = _i(4) + _i(40) + _s("V 1") + _s("nn.Sequential")
    seq += _i(3) + _i(41) + _i(1) + _i(2) + _s("modules") + modules
    path = tmp_path / "seq.t7"
    path.write_bytes(seq)
    module, variables = load_t7(str(path), device="cpu")
    x = torch.tensor([[1.0, -1.0, 2.0]])
    out, _ = module.apply(variables, x)
    np.testing.assert_allclose(out.numpy(),
                               np.maximum(x.numpy() @ w.T + b, 0.0),
                               rtol=1e-6)


def test_raw_tensor_table_and_strides(tmp_path):
    data = _i(3) + _i(1) + _i(2)
    data += _i(2) + _s("t") + t7fix._float_tensor(
        2, np.arange(6).reshape(2, 3))
    data += _i(2) + _s("n") + _i(1) + _d(7)
    (tmp_path / "tbl.t7").write_bytes(data)
    obj = load_t7(str(tmp_path / "tbl.t7"))
    assert obj["n"] == 7
    np.testing.assert_array_equal(obj["t"], np.arange(
        6, dtype=np.float32).reshape(2, 3))
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = _i(4) + _i(1) + _s("V 1") + _s("torch.FloatTensor")
    out += _i(2) + _l(3) + _l(2) + _l(1) + _l(3) + _l(1)
    out += _i(4) + _i(2) + _s("V 1") + _s("torch.FloatStorage")
    out += _l(arr.size) + arr.tobytes()
    (tmp_path / "tr.t7").write_bytes(out)
    np.testing.assert_array_equal(load_t7(str(tmp_path / "tr.t7")), arr.T)


def test_malformed_files_are_rejected(tmp_path):
    out = _i(4) + _i(1) + _s("V 1") + _s("torch.FloatTensor")
    out += _i(2) + _l(1000) + _l(1000) + _l(1000) + _l(1) + _l(1)
    out += _i(4) + _i(2) + _s("V 1") + _s("torch.FloatStorage")
    out += _l(4) + np.zeros(4, np.float32).tobytes()
    (tmp_path / "evil.t7").write_bytes(out)
    with pytest.raises(ValueError, match="exceeds its storage"):
        load_t7(str(tmp_path / "evil.t7"))
    out = _i(4) + _i(1) + _s("V 1") + _s("torch.FloatStorage")
    out += _l(100) + np.zeros(4, np.float32).tobytes()
    (tmp_path / "trunc.t7").write_bytes(out)
    with pytest.raises(ValueError, match="truncated"):
        load_t7(str(tmp_path / "trunc.t7"))
    save_t7(str(tmp_path / "bad.t7"), TorchObject("nn.FancyUnknownLayer",
                                                  {}))
    with pytest.raises(ValueError, match="FancyUnknownLayer"):
        load_t7(str(tmp_path / "bad.t7"), device="cpu")


@pytest.mark.parametrize("kind", ["f32", "i64", "tensor", "scalar"])
def test_tensor_roundtrip_and_jax_reads_it(tmp_path, kind):
    arr = {"f32": np.random.RandomState(0).rand(4, 5).astype(np.float32),
           "i64": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
           "tensor": np.random.RandomState(1).rand(3, 2).astype(np.float32),
           "scalar": np.asarray(3.5, np.float64)}[kind]
    obj = torch.from_numpy(arr) if kind == "tensor" else arr
    p = str(tmp_path / "t.t7")
    save_t7(p, obj)
    for got in (load_t7(p), jtf.load_t7(p)):
        if kind == "scalar":
            assert got == 3.5
        else:
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)


def test_tables_shared_references_and_binary_strings(tmp_path):
    shared = np.ones((2, 2), np.float32)
    payload = bytes(range(256)).decode("utf-8", errors="surrogateescape")
    obj = {"a": shared, "b": shared, "n": 3, "flag": True,
           "nested": {"x": "hello"}, "blob": payload,
           "raw": bytes(range(256)), "seq": [1, 2.5, "z"]}
    p = str(tmp_path / "tbl.t7")
    save_t7(p, obj)
    with open(p, "rb") as f:
        ours = f.read()
    jtf.save_t7(str(tmp_path / "j.t7"), obj)
    assert (tmp_path / "j.t7").read_bytes() == ours   # the same bytes
    got = load_t7(p, to_module=False)
    assert got["n"] == 3 and got["flag"] is True
    assert got["nested"]["x"] == "hello" and got["a"] is got["b"]
    assert got["seq"] == {1: 1, 2: 2.5, 3: "z"}
    for k in ("blob", "raw"):
        assert got[k].encode("utf-8", errors="surrogateescape") \
            == bytes(range(256))


def _mlp(nn):
    return nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Dropout(0.3),
                         nn.Linear(8, 4), nn.LogSoftMax())


def _convnet(nn):
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
        nn.SpatialBatchNormalization(8), nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape([8 * 4 * 4]),
        nn.Linear(8 * 4 * 4, 5), nn.Tanh())


def _lenet(nn):
    return nn.Sequential(
        nn.SpatialConvolution(1, 6, 5, 5), nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2), nn.SpatialConvolution(6, 12, 5, 5),
        nn.Tanh(), nn.SpatialAveragePooling(2, 2, 2, 2),
        nn.Reshape([12 * 4 * 4]), nn.Linear(192, 100), nn.Sigmoid(),
        nn.Linear(100, 10), nn.SoftMax())


MODELS = {"mlp": (_mlp, (3, 6)), "convnet": (_convnet, (2, 8, 8, 3)),
          "lenet": (_lenet, (2, 28, 28, 1))}


def _seeded(jm, seed=0):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        if str(path[-1].key) == "running_var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (rng.randn(*a.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_modules_move_both_ways(tmp_path, name):
    build, shape = MODELS[name]
    jm, pm = build(jnn), build(pnn)
    jv = _seeded(jm)
    pv = variables_from_jax(jv, device="cpu")
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    jout = np.asarray(jm.apply(jv, x)[0])
    pout = pm.apply(pv, torch.from_numpy(x))[0]
    # JAX writes, the port reads
    jtf.save_t7(str(tmp_path / "j.t7"), jm, jv)
    lm, lv = load_t7(str(tmp_path / "j.t7"), device="cpu")
    for a, b in zip(tree_leaves(lv), tree_leaves(pv)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(lm.apply(lv, torch.from_numpy(x))[0].numpy(),
                               jout, **FWD)
    # the port writes: the port reads it back bitwise, the JAX package
    # reads the same file
    save_t7(str(tmp_path / "p.t7"), pm, pv)
    assert (tmp_path / "p.t7").read_bytes() \
        == (tmp_path / "j.t7").read_bytes()
    rm, rv = load_t7(str(tmp_path / "p.t7"), device="cpu")
    assert torch.equal(rm.apply(rv, torch.from_numpy(x))[0], pout)
    jl, jlv = jtf.load_t7(str(tmp_path / "p.t7"))
    np.testing.assert_allclose(np.asarray(jl.apply(jlv, x)[0]),
                               pout.numpy(), **FWD)


def test_conv_layout_against_torch_oracle(tmp_path):
    rng = np.random.RandomState(3)
    w = rng.rand(4, 3, 3, 3).astype(np.float32)       # OIHW
    b = rng.rand(4).astype(np.float32)
    save_t7(str(tmp_path / "conv.t7"), TorchObject(
        "nn.SpatialConvolution", {
            "nInputPlane": 3, "nOutputPlane": 4, "kW": 3, "kH": 3,
            "dW": 1, "dH": 1, "padW": 1, "padH": 1,
            "weight": w, "bias": b}))
    module, variables = load_t7(str(tmp_path / "conv.t7"), device="cpu")
    x = rng.rand(2, 6, 6, 3).astype(np.float32)       # NHWC
    out, _ = module.apply(variables, torch.from_numpy(x))
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(w),
        torch.from_numpy(b), padding=1)
    np.testing.assert_allclose(out.numpy(),
                               ref.numpy().transpose(0, 2, 3, 1),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="asymmetric padding"):
        save_t7(str(tmp_path / "asym.t7"), pnn.SpatialConvolution(
            3, 4, 3, 3, pad_w=(1, 0)), {"params": {"weight": torch.zeros(
                3, 3, 3, 4)}, "state": {}})
