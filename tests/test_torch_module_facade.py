"""The eager facade of the port's Module (bigdl_tpu_torch/nn/module.py)
against the JAX package's (bigdl_tpu/nn/module.py:151-237):
`get_parameters` (one flat vector in `parameters()` order), the eager
`forward` and `__call__` in training and eval mode (batch norm's state
stored back, dropout at p = 0), `training()` and the no-argument
`evaluate()` returning the module, `is_training()`, and torch's own
`train()`/`eval()` and `training` attribute, which the port's mode is.

Tolerance: fp32 outputs and running statistics rtol 1e-5, atol 1e-6;
the parameter vector bit for bit (it is a concatenation).
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models.convert import tree_leaves, variables_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _net(nn):
    return nn.Sequential(nn.Linear(4, 6), nn.BatchNormalization(6),
                         nn.ReLU(), nn.Dropout(0.0), nn.Linear(6, 3),
                         nn.LogSoftMax())


def _built():
    jm = _net(jnn).build(jax.random.PRNGKey(1))
    tm = _net(tnn)
    tm.variables = variables_from_jax(jax.device_get(jm.variables),
                                      device="cpu")
    return jm, tm


def _x(seed):
    return np.random.RandomState(seed).randn(8, 4).astype(np.float32)


def _assert_state_equal(tm, jm):
    ts, js = tree_leaves(tm.variables["state"]), \
        jax.tree_util.tree_leaves(jm.variables["state"])
    assert len(ts) == len(js) == 2                 # running mean and var
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_get_parameters_matches_jax():
    jm, tm = _built()
    v = tm.get_parameters()
    assert v.dim() == 1 and v.dtype == torch.float32
    np.testing.assert_array_equal(v.numpy(), np.asarray(jm.get_parameters()))
    assert v.numel() == sum(t.numel() for _, t in tm.parameters()) \
        == 4 * 6 + 6 + 6 + 6 + 6 * 3 + 3
    lenet = tlenet.build(10).build(device="cpu")
    assert lenet.get_parameters().numel() == sum(
        t.numel() for t in tree_leaves(lenet.variables["params"]))
    relu = tnn.ReLU().build(device="cpu")
    assert relu.get_parameters().shape == (0,) == \
        jnn.ReLU().build().get_parameters().shape
    with pytest.raises(ValueError, match="build"):
        tnn.Linear(2, 2).get_parameters()


def test_eager_forward_matches_jax_in_both_modes():
    jm, tm = _built()
    state0 = [t.clone() for t in tree_leaves(tm.variables["state"])]
    for seed in (0, 1):                            # training: state moves
        tout = tm(torch.from_numpy(_x(seed)))
        jout = jm(jax.numpy.asarray(_x(seed)))
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   **TOL)
        _assert_state_equal(tm, jm)
    assert all(not torch.equal(a, b) for a, b in
               zip(state0, tree_leaves(tm.variables["state"])))
    params = tm.variables["params"]
    trained = [t.clone() for t in tree_leaves(tm.variables["state"])]
    assert tm.evaluate() is tm and jm.evaluate() is jm
    x = torch.from_numpy(_x(2))
    tout = tm.forward(x)
    np.testing.assert_allclose(tout.numpy(), np.asarray(
        jm.forward(jax.numpy.asarray(_x(2)))), **TOL)
    ref, _ = tm.apply(tm.variables, x, training=False)
    assert torch.equal(tout, ref)                  # evaluate() == apply
    assert all(torch.equal(a, b) for a, b in
               zip(trained, tree_leaves(tm.variables["state"])))
    assert tm.variables["params"] is params        # params left in place


def test_dropout_needs_rng_in_training_mode_above_zero():
    m = tnn.Sequential(tnn.Linear(3, 3), tnn.Dropout(0.5))
    m.build(device="cpu")
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="rng"):
        m(x)
    out = m(x, rng=torch.Generator().manual_seed(0))
    assert out.shape == (2, 3)
    assert torch.equal(m.evaluate()(x), m.apply(m.variables, x)[0])


def test_modes_training_evaluate_and_torch_train_eval():
    m = tnn.Linear(2, 2)
    assert m.is_training() and m.training and m.training == True  # noqa
    assert repr(m.training) == "True"
    assert m.evaluate() is m and not m.is_training() and not m.training
    assert repr(m.training) == "False"
    assert m.training() is m and m.is_training()
    assert m.eval() is m and not m.is_training()   # torch's own switches
    assert m.train() is m and m.is_training()
    m.train(False)
    assert not m.is_training()
    with pytest.raises(ValueError):
        m.train("yes")                             # torch's own check
    j = jnn.Linear(2, 2)
    assert j.is_training() and j.evaluate() is j and not j.is_training()
    assert j.training() is j and j.is_training()


def test_eager_forward_builds_on_the_card_by_default():
    """`variables` builds on first use on the default device, the card;
    without one that raises, and a CPU build runs."""
    m = tnn.Linear(2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m(torch.ones(1, 2))
    m.build(torch.Generator().manual_seed(0), device="cpu")
    y = m(torch.ones(1, 2))
    assert y.shape == (1, 3) and y.device.type == "cpu"
