"""The port's LBFGS (bigdl_tpu_torch/optim/lbfgs.py) against the JAX
package's (bigdl_tpu/optim/lbfgs.py) on the cases of
tests/test_lbfgs.py, each run through both packages from the same
start: a quadratic, Rosenbrock, a problem that converges early, the
tiny XOR net, the strong-Wolfe conditions at an accepted step, an
exhausted bracket that must not ascend, and Wolfe against Armijo.

The comparison runs in fp64 (JAX's x64 switched on and restored): there
the Python loop takes every decision the JAX `lax.while_loop` takes, so
`n_iter` and `.evals` are equal and the final x and loss agree to
rounding (x within 1e-6, the loss within 1e-9; Armijo's 671 Rosenbrock
iterations read 1.2e-8 apart in x). In fp32 the two packages' iterates
part after a few iterations: on Rosenbrock at iterate 3 (Wolfe) and 5
(Armijo) by one or a few ulps, because XLA:CPU and torch round the
gradient's products and the dot products' sums differently; from there
each run takes its own, equally valid path (Wolfe: 33 iterations both,
49 evaluations in JAX and 48 in the port). So fp32 is held to the
convergence the JAX tests ask for, not to JAX's iterates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import lbfgs as jlbfgs
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_map)
from bigdl_tpu_torch.optim import lbfgs as tlbfgs

X_TOL, F_TOL = 1e-6, 1e-9
# XLA:CPU's backend optimisation off: the same HLO, half the compile time
O0 = {"xla_backend_optimization_level": 0}


def _jit_o0(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)(*args)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _rosenbrock(p):
    x, y = p[0], p[1]
    return (1 - x) ** 2 + 100.0 * (y - x * x) ** 2


def _quadratic(xp):
    a = xp.asarray([[3.0, 0.5], [0.5, 1.0]])
    b = xp.asarray([1.0, -2.0])
    return lambda x: 0.5 * x @ a @ x - b @ x


class _TorchNp:
    """The bit of the array API `_quadratic` needs, for torch fp64."""

    @staticmethod
    def asarray(v):
        return torch.tensor(v, dtype=torch.float64)


def _xor():
    """The JAX test's net and data: fevals of both packages over the
    same fp64 start."""
    x = [[0, 0], [0, 1], [1, 0], [1, 1]]
    y = [[0.0], [1.0], [1.0], [0.0]]
    jm = jnn.Sequential(jnn.Linear(2, 8), jnn.Tanh(), jnn.Linear(8, 1))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = tnn.Sequential(tnn.Linear(2, 8), tnn.Tanh(), tnn.Linear(8, 1))
    jx, jy = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    tx, ty = (torch.tensor(a, dtype=torch.float64) for a in (x, y))

    def jf(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]}, jx)
        return jnp.mean((out - jy) ** 2)

    def tf(p):
        out, _ = tm.apply({"params": p, "state": tm.init_state()}, tx)
        return torch.mean((out - ty) ** 2)

    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                jax.device_get(jv["params"]))
    return jf, tf, p0


def _problem(case):
    """(jax feval, port feval, x0 as numpy or a numpy tree, kwargs)."""
    if case == "quadratic":
        return _quadratic(jnp), _quadratic(_TorchNp), np.zeros(2), \
            dict(max_iter=50)
    if case in ("rosenbrock", "rosenbrock_armijo"):
        ls = "armijo" if case.endswith("armijo") else "wolfe"
        return _rosenbrock, _rosenbrock, np.asarray([-1.2, 1.0]), \
            dict(max_iter=800, history_size=10, line_search=ls)
    if case == "converges_early":
        return (lambda x: jnp.sum((x - 3.0) ** 2),
                lambda x: torch.sum((x - 3.0) ** 2), np.zeros(5),
                dict(max_iter=30))
    if case == "xor":
        return (*_xor(), dict(max_iter=200))
    if case == "fixed_step":
        return _quadratic(jnp), _quadratic(_TorchNp), np.zeros(2), \
            dict(max_iter=40, learningrate=0.3, line_search=False)
    raise KeyError(case)


def _to_torch(tree):
    if isinstance(tree, dict):
        return tree_map(lambda t: t.double(),
                        params_from_jax(tree, device="cpu"))
    return torch.tensor(tree, dtype=torch.float64)


def _leaves(tree):
    if isinstance(tree, dict):
        return [np.asarray(v) for v in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, tree))]
    return [np.asarray(tree)]


@pytest.mark.parametrize("case", ["quadratic", "rosenbrock",
                                  "rosenbrock_armijo", "converges_early",
                                  "xor", "fixed_step"])
def test_minimize_matches_jax_in_fp64(x64, case):
    jf, tf, x0, kw = _problem(case)
    jopt, topt = jlbfgs.LBFGS(**kw), tlbfgs.LBFGS(**kw)

    def jrun(x):
        return (*jopt.minimize(jf, x), jopt.evals)

    jx, jl, jit, jevals = _jit_o0(jrun, jax.tree_util.tree_map(jnp.asarray,
                                                               x0))
    tx, tl, tit = topt.minimize(tf, _to_torch(x0))
    assert tit == int(jit) and topt.evals == int(jevals)
    assert tl.dtype == torch.float64
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=F_TOL)
    tleaves = [t.numpy() for t in tree_leaves(tx)]
    for a, b in zip(tleaves, _leaves(jx)):
        np.testing.assert_allclose(a, b, rtol=0, atol=X_TOL)
    if case == "xor":
        assert float(tl) < 1e-3
    elif case == "converges_early":
        assert tit < 30


def test_strong_wolfe_conditions_match_jax(x64):
    """At the accepted step both strong-Wolfe conditions hold, the
    returned f and g are f(x + t d) and its gradient, and t, f, g and
    the evaluation count are JAX's."""
    a = [[5.0, 1.0], [1.0, 2.0]]
    c1, c2 = 1e-4, 0.9
    A = jnp.asarray(a)
    jvg = jax.value_and_grad(lambda x: 0.5 * x @ A @ x + jnp.sum(jnp.cos(x)))

    def jsearch(x0):
        f0, g0 = jvg(x0)
        return jlbfgs._strong_wolfe(jvg, x0, jnp.asarray(1.0), -g0, f0, g0,
                                    jnp.dot(g0, -g0), c1, c2, 25)

    jt, jf, jg, jn = _jit_o0(jsearch, jnp.asarray([2.0, -3.0]))
    tA = torch.tensor(a, dtype=torch.float64)

    def vg(x):
        x = x.detach().requires_grad_()
        f = 0.5 * x @ tA @ x + torch.sum(torch.cos(x))
        return f.detach(), torch.autograd.grad(f, x)[0]

    x0 = torch.tensor([2.0, -3.0], dtype=torch.float64)
    tf0, tg0 = vg(x0)
    d = -tg0
    gtd0 = torch.dot(tg0, d)
    t, ft, gt, nev = tlbfgs._strong_wolfe(
        vg, x0, torch.tensor(1.0, dtype=torch.float64), d, tf0, tg0, gtd0,
        c1, c2, 25)
    assert float(t) > 0.0
    assert float(ft) <= float(tf0 + c1 * t * gtd0) + 1e-6
    assert abs(float(torch.dot(gt, d))) <= c2 * abs(float(gtd0)) + 1e-6
    fc, gc = vg(x0 + t * d)
    assert float(ft) == float(fc) and torch.equal(gt, gc)
    assert nev == int(jn) >= 1
    np.testing.assert_allclose([float(t), float(ft)], [float(jt), float(jf)],
                               rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=1e-12)


@pytest.mark.parametrize("max_ls", [2, 3, 25])
def test_exhausted_bracket_never_ascends_as_in_jax(x64, max_ls):
    def jf(x):
        t = x[0]
        return -t + jnp.where(t > 1.005, 5e3 * (t - 1.005) ** 2, 0.0)

    def tf(x):
        t = x[0]
        return -t + torch.where(t > 1.005, 5e3 * (t - 1.005) ** 2,
                                torch.zeros_like(t))

    def tvg(x):
        x = x.detach().requires_grad_()
        f = tf(x)
        return f.detach(), torch.autograd.grad(f, x)[0]

    jvg = jax.value_and_grad(jf)

    def jsearch(x0, d):
        f0, g0 = jvg(x0)
        return jlbfgs._strong_wolfe(jvg, x0, jnp.asarray(1.0), d, f0, g0,
                                    jnp.dot(g0, d), 1e-4, 0.9, max_ls)

    jout = _jit_o0(jsearch, jnp.asarray([0.0]), jnp.asarray([1.0]))
    tx0 = torch.zeros(1, dtype=torch.float64)
    td = torch.ones(1, dtype=torch.float64)
    tf0, tg0 = tvg(tx0)
    t, ft, gt, nev = tlbfgs._strong_wolfe(
        tvg, tx0, torch.tensor(1.0, dtype=torch.float64), td, tf0, tg0,
        torch.dot(tg0, td), 1e-4, 0.9, max_ls)
    assert float(ft) <= float(tf0) + 1e-6, "accepted an ascent step"
    assert nev == int(jout[3])
    np.testing.assert_allclose([float(t), float(ft)],
                               [float(jout[0]), float(jout[1])], rtol=1e-12)


def test_wolfe_beats_armijo_on_rosenbrock_in_fp32():
    """The JAX test's claim, on the port alone in fp32: strong-Wolfe
    converges in fewer evaluations than Armijo, both to (1, 1)."""
    x0 = torch.tensor([-1.2, 1.0])
    wolfe = tlbfgs.LBFGS(max_iter=800, line_search="wolfe")
    xw, fw, itw = wolfe.minimize(_rosenbrock, x0)
    armijo = tlbfgs.LBFGS(max_iter=800, line_search="armijo")
    xa, fa, ita = armijo.minimize(_rosenbrock, x0)
    assert xw.dtype == torch.float32
    np.testing.assert_allclose(xw.numpy(), [1.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(xa.numpy(), [1.0, 1.0], atol=1e-3)
    assert float(fw) < 1e-6 and wolfe.evals < armijo.evals and itw <= ita
    assert torch.equal(x0, torch.tensor([-1.2, 1.0]))   # x0 left alone
    assert tlbfgs.LBFGS(line_search=True).line_search == "wolfe"
    with pytest.raises(ValueError, match="unknown line_search"):
        tlbfgs.LBFGS(line_search="backtrack")
