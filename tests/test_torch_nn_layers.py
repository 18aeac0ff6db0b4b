"""The port's module surface and plain layers (bigdl_tpu_torch/nn/:
module, initialization, container, embedding, linear, activation,
criterion) against the JAX package's, on the same numpy inputs and
the same weights (models/convert.params_from_jax).

Tolerance: fp32 rtol 1e-5 / atol 1e-6 for values and gradients (one
or two fp32 ops of different summation order). Initializers are held
to their distributions only: the draws are the generator's, not
threefry's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.nn.module import _fold_rng

TOL = dict(rtol=1e-5, atol=1e-6)
KEY = jax.random.PRNGKey(0)


def _pair(jm, tm, key=KEY):
    variables = jm.init(key)
    tv = {"params": params_from_jax(jax.device_get(variables["params"]),
                                    device="cpu"),
          "state": {}}
    if variables["state"]:
        tv["state"] = params_from_jax(jax.device_get(variables["state"]),
                                      device="cpu")
    return variables, tv


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


ACTIVATIONS = ["ReLU", "ReLU6", "Tanh", "Sigmoid", "SoftMax", "LogSoftMax",
               "SoftPlus", "SoftSign", "ELU", "GELU", "LeakyReLU",
               "HardTanh", "Abs", "Square", "Exp", "HardSigmoid", "Swish",
               "Mish"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name):
    x = _x(3, 7) * 3
    jout, _ = getattr(jnn, name)().apply({"params": {}, "state": {}},
                                         jnp.asarray(x))
    tout, _ = getattr(tnn, name)().apply({"params": {}, "state": {}},
                                         torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("name, args", [("Power", (2.0, 0.5, 1.0)),
                                        ("Clamp", (-0.3, 0.4)),
                                        ("Sqrt", ()), ("Log", ())])
def test_parametrized_activations_match_jax(name, args):
    x = np.abs(_x(4, 5, seed=1)) + 0.1
    jout, _ = getattr(jnn, name)(*args).apply({"params": {}, "state": {}},
                                              jnp.asarray(x))
    tout, _ = getattr(tnn, name)(*args).apply({"params": {}, "state": {}},
                                              torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear_matches_jax_with_grads(with_bias):
    jm, tm = jnn.Linear(6, 3, with_bias=with_bias), \
        tnn.Linear(6, 3, with_bias=with_bias)
    jv, tv = _pair(jm, tm)
    assert tm.init(device="cpu")["params"].keys() == jv["params"].keys()
    x = _x(4, 6)
    jout, _ = jm.apply(jv, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tv["params"].items()}
    tout, _ = tm.apply({"params": tp, "state": {}}, torch.tensor(x))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    jg = jax.grad(lambda p: jnp.sum(jnp.sin(jm.apply(
        {"params": p, "state": {}}, jnp.asarray(x))[0])))(jv["params"])
    tg = torch.autograd.grad(torch.sin(tout).sum(), list(tp.values()))
    for (k, _), g in zip(tp.items(), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **TOL)


@pytest.mark.parametrize("padding_value, max_norm",
                         [(None, None), (2, None), (None, 1.5), (0, 0.7)])
def test_lookup_table_matches_jax(padding_value, max_norm):
    jm = jnn.LookupTable(10, 4, padding_value=padding_value,
                         max_norm=max_norm)
    tm = tnn.LookupTable(10, 4, padding_value=padding_value,
                         max_norm=max_norm)
    jv, tv = _pair(jm, tm)
    idx = np.random.RandomState(2).randint(0, 10, (3, 5)).astype(np.int32)
    idx[0, :3] = [0, 2, 9]
    jout, _ = jm.apply(jv, jnp.asarray(idx))
    tout, _ = tm.apply(tv, torch.tensor(idx))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_sequential_keys_and_forward_match_jax():
    jm = jnn.Sequential(jnn.Linear(5, 8).set_name("fc1"), jnn.Tanh(),
                        jnn.Linear(8, 3), jnn.LogSoftMax())
    tm = tnn.Sequential(tnn.Linear(5, 8).set_name("fc1"), tnn.Tanh(),
                        tnn.Linear(8, 3), tnn.LogSoftMax())
    jv, tv = _pair(jm, tm)
    tinit = tm.init(torch.Generator().manual_seed(3), device="cpu")
    assert list(tinit["params"]) == list(jv["params"]) == [
        "0_fc1", "1_Tanh", "2_Linear", "3_LogSoftMax"]
    assert tinit["state"].keys() == jv["state"].keys()
    x = _x(4, 5, seed=3)
    jout, _ = jm.apply(jv, jnp.asarray(x))
    tout, state = tm.apply(tv, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert list(state) == list(jv["state"])
    assert len(tm) == 4 and tm[0].key_name() == "fc1"


def test_init_distributions_device_and_seed():
    g = torch.Generator().manual_seed(0)
    w = tnn.Xavier()(g, (200, 300), fan_in=200, fan_out=300)
    a = (6.0 / 500) ** 0.5
    assert w.abs().max() <= a and w.abs().max() > 0.95 * a
    assert abs(float(w.mean())) < 0.01
    n = tnn.RandomNormal(1.0, 0.5)(g, (100000,), 1, 1)
    assert abs(float(n.mean()) - 1.0) < 0.01
    assert abs(float(n.std()) - 0.5) < 0.01
    m = tnn.MsraFiller(False)(g, (100000,), 50, 10)
    assert abs(float(m.std()) - (2 / 50) ** 0.5) < 0.005
    u = tnn.RandomUniform()(g, (1000,), 16, 1)
    assert u.abs().max() <= 0.25
    assert torch.equal(tnn.Zeros()(g, (2, 2), 1, 1), torch.zeros(2, 2))
    assert torch.equal(tnn.Ones()(g, (2,), 1, 1), torch.ones(2))
    assert torch.equal(tnn.ConstInitMethod(3.0)(g, (2,), 1, 1),
                       torch.full((2,), 3.0))
    model = tnn.Sequential(tnn.Linear(4, 4), tnn.Linear(4, 4))
    a1 = model.init(torch.Generator().manual_seed(5), device="cpu")
    a2 = model.init(torch.Generator().manual_seed(5), device="cpu")
    b = model.init(torch.Generator().manual_seed(6), device="cpu")
    w0, w1 = (a1["params"][k]["weight"] for k in ("0_Linear", "1_Linear"))
    assert torch.equal(w0, a2["params"]["0_Linear"]["weight"])
    assert not torch.equal(w0, w1)          # children fold their index
    assert not torch.equal(w0, b["params"]["0_Linear"]["weight"])
    assert w0.device.type == "cpu"


def test_fold_rng_is_pure():
    g = torch.Generator().manual_seed(11)
    x = torch.rand(3, generator=_fold_rng(g, 2))
    torch.rand(5, generator=g)            # draws from g do not matter
    assert torch.equal(x, torch.rand(3, generator=_fold_rng(g, 2)))
    assert not torch.equal(x, torch.rand(3, generator=_fold_rng(g, 3)))
    assert _fold_rng(None, 1) is None


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.Linear(2, 2).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.Linear(2, 2).build()


def test_key_name_and_set_name():
    m = tnn.Linear(2, 2)
    assert m.key_name() == "Linear" and m.name.startswith("Linear_")
    assert m.set_name("head") is m and m.key_name() == "head"


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_class_nll_and_cross_entropy_match_jax(size_average, weighted):
    x = _x(6, 4, seed=4)
    y = np.array([0, 3, 1, 2, 3, 0], np.int32)
    w = np.array([0.5, 1.0, 2.0, 0.25], np.float32) if weighted else None
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(x)))
    for jc, tc, inp in (
            (jnn.ClassNLLCriterion(None if w is None else jnp.asarray(w),
                                   size_average),
             tnn.ClassNLLCriterion(w, size_average), logp),
            (jnn.CrossEntropyCriterion(None if w is None
                                       else jnp.asarray(w), size_average),
             tnn.CrossEntropyCriterion(w, size_average), x)):
        jl = jc(jnp.asarray(inp), jnp.asarray(y))
        ti = torch.tensor(inp, requires_grad=True)
        tl = tc(ti, torch.tensor(y))
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        jg = jax.grad(lambda a: jc(a, jnp.asarray(y)))(jnp.asarray(inp))
        (tg,) = torch.autograd.grad(tl, ti)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_class_nll_probabilities_input():
    p = np.abs(_x(5, 3, seed=5)) + 0.01
    y = np.array([0, 1, 2, 1, 0], np.int32)
    jl = jnn.ClassNLLCriterion(logProbAsInput=False)(jnp.asarray(p),
                                                     jnp.asarray(y))
    tl = tnn.ClassNLLCriterion(logProbAsInput=False)(torch.tensor(p),
                                                     torch.tensor(y))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


@pytest.mark.parametrize("outer", [True, False])
@pytest.mark.parametrize("inner", [True, False])
def test_time_distributed_criterion_matches_jax(outer, inner):
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(_x(3, 4, 5, seed=6))))
    y = np.random.RandomState(7).randint(0, 5, (3, 4)).astype(np.int32)
    jl = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(
        size_average=inner), size_average=outer)(jnp.asarray(logp),
                                                 jnp.asarray(y))
    tl = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(
        size_average=inner), size_average=outer)(torch.tensor(logp),
                                                 torch.tensor(y))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
