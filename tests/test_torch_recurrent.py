"""The port's recurrent layers (bigdl_tpu_torch/nn/recurrent.py)
against the JAX package's, on the same numpy inputs and weights
(models/convert.params_from_jax): Recurrent and BiRecurrent over every
cell, concat/add merges, return_state, hoist_inputs, the fused dispatch
(the JAX side with fused="interpret" where a Pallas kernel exists, the
port with its plain versions on the CPU) and TimeDistributed.

Tolerance: fp32 rtol 1e-5 / atol 1e-6 for outputs, rtol 1e-4 /
atol 1e-5 for gradients (T steps of fp32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import (params_from_jax,
                                            tree_leaves_with_path)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)
D, H, N, T = 5, 8, 3, 6


def _cells(pkg, kind):
    return {"rnn": lambda: pkg.RnnCell(D, H),
            "lstm": lambda: pkg.LSTM(D, H, forget_bias=1.0),
            "peephole": lambda: pkg.LSTMPeephole(D, H),
            "gru": lambda: pkg.GRU(D, H)}[kind]()


def _x(seed=0):
    return np.random.RandomState(seed).randn(N, T, D).astype(np.float32)


def _run_pair(jm, tm, x, out_of=lambda o: o, seed=0):
    """Forward and parameter gradients of sum(sin(out) * w) in both
    packages from the JAX weights; returns (jax, port) outputs and
    gradient leaves in jax tree order."""
    variables = jm.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.device_get(variables["params"]),
                              device="cpu")
    jout = out_of(jm.apply(variables, jnp.asarray(x))[0])
    wts = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)

    def jloss(p):
        o = out_of(jm.apply({"params": p, "state": variables["state"]},
                            jnp.asarray(x))[0])
        return jnp.sum(jnp.sin(o) * wts)

    jg = jax.tree_util.tree_leaves(jax.grad(jloss)(variables["params"]))
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(tparams)]
    tout = out_of(tm.apply({"params": tparams, "state": tm.init_state()},
                           torch.tensor(x))[0])
    tg = torch.autograd.grad((torch.sin(tout) * torch.tensor(wts)).sum(),
                             leaves)
    return (np.asarray(jout), tout.detach().numpy()), (jg, tg)


def _assert_pair(outs, grads):
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    assert len(grads[0]) == len(grads[1])
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("kind", ["rnn", "lstm", "peephole", "gru"])
def test_recurrent_matches_jax(kind, hoist):
    jf = "interpret" if kind == "lstm" else None
    jm = jnn.Recurrent(_cells(jnn, kind), hoist_inputs=hoist, fused=jf)
    tm = tnn.Recurrent(_cells(tnn, kind), hoist_inputs=hoist)
    _assert_pair(*_run_pair(jm, tm, _x()))


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_recurrent_loop_route_matches_fused_route(kind):
    """fused=False (the per-step loop) against the fused route's plain
    version inside the port."""
    x = torch.tensor(_x(1))
    m_loop = tnn.Recurrent(_cells(tnn, kind), fused=False)
    m_fused = tnn.Recurrent(_cells(tnn, kind), fused="torch")
    v = m_loop.init(device="cpu")
    a, _ = m_loop.apply(v, x)
    b, _ = m_fused.apply(v, x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
def test_return_state_matches_jax(kind):
    jm = jnn.Recurrent(_cells(jnn, kind), return_state=True)
    tm = tnn.Recurrent(_cells(tnn, kind), return_state=True)
    variables = jm.init(jax.random.PRNGKey(1))
    tv = {"params": params_from_jax(jax.device_get(variables["params"]),
                                    device="cpu"), "state": {}}
    jout, _ = jm.apply(variables, jnp.asarray(_x(2)))
    (tout, carry), _ = tm.apply(tv, torch.tensor(_x(2)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout[1]), **TOL)
    jcarry = jax.tree_util.tree_leaves(jout[2])
    tcarry = carry if isinstance(carry, tuple) else (carry,)
    for a, b in zip(tcarry, jcarry):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("merge", ["concat", "add"])
@pytest.mark.parametrize("kind", ["lstm", "gru", "peephole"])
def test_birecurrent_matches_jax(kind, merge):
    jf = "interpret" if kind == "lstm" else None
    jm = jnn.BiRecurrent(_cells(jnn, kind), merge=merge, fused=jf)
    tm = tnn.BiRecurrent(_cells(tnn, kind), merge=merge)
    _assert_pair(*_run_pair(jm, tm, _x(3), seed=2))


@pytest.mark.parametrize("fused", [None, False])
def test_birecurrent_routes_match_jax_loop(fused):
    """The port's one-call bilstm route (None) and its per-step loops
    (False) both equal the JAX package's lax.scan route."""
    jm = jnn.BiRecurrent(jnn.LSTM(D, H), fused=False)
    tm = tnn.BiRecurrent(tnn.LSTM(D, H), fused=fused)
    _assert_pair(*_run_pair(jm, tm, _x(4), seed=3))


def test_birecurrent_of_unequal_cells_takes_the_loop():
    jm = jnn.BiRecurrent(jnn.LSTM(D, H), jnn.LSTM(D, H + 2), merge="concat")
    tm = tnn.BiRecurrent(tnn.LSTM(D, H), tnn.LSTM(D, H + 2), merge="concat")
    assert tm._fused_bidir(tm.init(device="cpu"), torch.zeros(N, T, D)) \
        is None
    _assert_pair(*_run_pair(jm, tm, _x(5)))


def test_time_distributed_matches_jax():
    jm = jnn.TimeDistributed(jnn.Linear(D, 4))
    tm = tnn.TimeDistributed(tnn.Linear(D, 4))
    _assert_pair(*_run_pair(jm, tm, _x(6)))
    assert tm.init(device="cpu")["state"] == {"inner": {}}


def test_param_tree_layout_matches_jax():
    for kind in ("rnn", "lstm", "peephole", "gru"):
        jv = jnn.Recurrent(_cells(jnn, kind)).init(jax.random.PRNGKey(0))
        tv = tnn.Recurrent(_cells(tnn, kind)).init(device="cpu")
        jshapes = [(tuple(str(getattr(k, "key", k)) for k in p), v.shape)
                   for p, v in jax.tree_util.tree_leaves_with_path(
                       jv["params"])]
        tshapes = [(p, tuple(v.shape))
                   for p, v in tree_leaves_with_path(tv["params"])]
        assert tshapes == jshapes, kind
    bias = tnn.LSTM(D, H, forget_bias=1.0).init_params(
        torch.Generator().manual_seed(0))["bias"]
    assert torch.equal(bias[H:2 * H], torch.ones(H))


def test_refusals():
    x = torch.zeros(2, 3, D)
    gru = tnn.Recurrent(tnn.GRU(D, H), fused="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        gru.apply(gru.init(device="cpu"), x)
    with pytest.raises(NotImplementedError, match="A.4"):
        tnn.ConvLSTMPeephole(3, 4)
    with pytest.raises(ValueError, match="fused"):
        tnn.Recurrent(tnn.LSTM(D, H), fused="pallas")
    lstm = tnn.Recurrent(tnn.LSTM(D, H), fused="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm.apply(lstm.init(device="cpu"), x)


def test_add_and_unroll_parity_surface():
    m = tnn.Recurrent(unroll=4).add(tnn.LSTM(D, H))
    v = m.init(device="cpu")
    out, _ = m.apply(v, torch.tensor(_x(7)))
    assert out.shape == (N, T, H)
