"""The port's torch.nn import (bigdl_tpu_torch/utils/torch_interop.py
`from_torch`) and op-list flattening (utils/interop.py `linearize`)
against the JAX package's, and `from_torch` against the torch model
itself (the reference's Torch-as-oracle strategy, SURVEY.md §4).

Named apart from tests/test_torch_interop.py, which is the JAX
package's own test of bigdl_tpu/utils/torch_interop.py. Both packages
convert the same torch model: their variables are equal leaf for leaf
(the same transposes of the same weights), their outputs agree within
fp32 atol 1e-5, rtol 1e-4, and the port's output matches the torch
model's within the same tolerance (NCHW in, NHWC out, transposed back)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.interop import linearize as jlinearize
from bigdl_tpu.utils.torch_interop import from_torch as jfrom_torch
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models.convert import tree_leaves, variables_from_jax
from bigdl_tpu_torch.utils.interop import linearize
from bigdl_tpu_torch.utils.torch_interop import from_torch

TOL = dict(atol=1e-5, rtol=1e-4)


def _warm_bn(tm, shape):
    """Push a batch through in train mode so batch-norm running
    statistics are not trivial, then switch to eval."""
    tm.train()
    with torch.no_grad():
        tm(torch.randn(*shape))
    return tm.eval()


CASES = {
    "linear": (lambda: tnn.Linear(12, 5), (3, 12), "NHWC", False),
    "mlp": (lambda: tnn.Sequential(
        tnn.Linear(8, 16), tnn.ReLU(), tnn.Dropout(0.5), tnn.Linear(16, 4),
        tnn.LogSoftmax(dim=-1)), (6, 8), "NHWC", False),
    "activations": (lambda: tnn.Sequential(
        tnn.Linear(6, 6), tnn.ReLU6(), tnn.Linear(6, 6), tnn.GELU(),
        tnn.Linear(6, 6), tnn.Tanh(), tnn.Sigmoid(), tnn.Identity(),
        tnn.Softmax(dim=-1)), (4, 6), "NHWC", False),
    "conv_bn_pool": (lambda: tnn.Sequential(
        tnn.Conv2d(3, 8, 3, stride=1, padding=1), tnn.BatchNorm2d(8),
        tnn.ReLU(), tnn.MaxPool2d(2), tnn.Conv2d(8, 4, 3),
        tnn.AvgPool2d(2)), (2, 3, 16, 16), "NCHW", True),
    "strided_grouped_ceil": (lambda: tnn.Sequential(
        tnn.Conv2d(4, 8, (3, 5), stride=(2, 1), padding=(1, 2), groups=2,
                   bias=False),
        tnn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True),
        tnn.AvgPool2d(2, padding=1, count_include_pad=False)),
        (2, 4, 11, 9), "NCHW", False),
    "conv_to_linear": (lambda: tnn.Sequential(
        tnn.Conv2d(3, 6, 5, padding=2), tnn.BatchNorm2d(6), tnn.ReLU(),
        tnn.MaxPool2d(8), tnn.Flatten(), tnn.Linear(6, 10),
        tnn.BatchNorm1d(10)), (4, 3, 8, 8), "NCHW", True),
}


def _torch_ref(tm, x, layout):
    with torch.no_grad():
        ref = tm(x).numpy()
    return ref.transpose(0, 2, 3, 1) if layout == "NCHW" and ref.ndim == 4 \
        else ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_from_torch_matches_torch_and_jax(name):
    build, shape, layout, bn = CASES[name]
    torch.manual_seed(0)
    tm = build()
    tm = _warm_bn(tm, shape) if bn else tm.eval()
    x = torch.randn(*shape)
    ref = _torch_ref(tm, x, layout)

    m, variables = from_torch(tm, input_layout=layout, device="cpu")
    m.evaluate()
    out, _ = m.apply(variables, x, training=False)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)

    jm, jv = jfrom_torch(tm, input_layout=layout)
    jout, _ = jm.apply(jv, jnp.asarray(x.numpy()), training=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert type(m).__name__ == type(jm).__name__
    want = variables_from_jax(jax.device_get(jv), device="cpu")
    got_leaves, want_leaves = tree_leaves(variables), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)


def test_embedding_matches_torch():
    torch.manual_seed(0)
    tm = tnn.Embedding(20, 6).eval()
    idx = torch.randint(0, 20, (4, 7))
    with torch.no_grad():
        ref = tm(idx).numpy()
    m, variables = from_torch(tm, device="cpu")
    out, _ = m.apply(variables, idx)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_variables_are_copies_on_the_device():
    tm = tnn.Linear(3, 2)
    _, variables = from_torch(tm, device="cpu")
    w = variables["params"]["weight"]
    assert w.shape == (3, 2) and not w.requires_grad
    with torch.no_grad():
        tm.weight.add_(1.0)
    assert not torch.equal(w, tm.weight.detach().T)


def test_unsupported_layer_raises():
    with pytest.raises(NotImplementedError,
                       match="no bigdl_tpu_torch mapping"):
        from_torch(tnn.TransformerEncoderLayer(16, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="start_dim"):
        from_torch(tnn.Flatten(start_dim=2), device="cpu")


def _graph(nn):
    inp = nn.Input()
    a = nn.ReLU()(nn.Linear(8, 3)(inp))
    b = nn.Sequential(nn.Linear(8, 3), nn.Tanh())(inp)
    join = nn.CAddTable()(a, b)
    return nn.Sequential(nn.Graph(inp, join), nn.Linear(3, 2))


def test_linearize_matches_jax():
    jm = _graph(jnn)
    pm = _graph(pnn)
    jv = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pv = variables_from_jax(jv, device="cpu")
    jentries, jouts = jlinearize(jm, jv)
    entries, outs = linearize(pm, pv)
    assert outs == jouts
    assert [(type(m).__name__, ids) for m, _, ids in entries] \
        == [(type(m).__name__, ids) for m, _, ids in jentries]
    for (_, v, _), (_, jvv, _) in zip(entries, jentries):
        for a, b in zip(tree_leaves(v), jax.tree_util.tree_leaves(jvv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # two graph inputs map to entry ids -1 and -2
    inp1, inp2 = pnn.Input(), pnn.Input()
    g = pnn.Graph([inp1, inp2], pnn.CMulTable()(inp1, inp2))
    entries, outs = linearize(g, g.init(device="cpu"), n_inputs=2)
    assert [ids for _, _, ids in entries] == [[-1, -2]] and outs == [0]
