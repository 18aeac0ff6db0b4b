"""`ConvLSTMPeephole` inside `Recurrent` (bigdl_tpu_torch/nn/recurrent.py)
against the JAX package's cell: forward over (N, T, H, W, C) frames and
every parameter gradient, with and without peepholes, at kernels 3, 5
and 2 — the even kernel pads SAME asymmetrically ((k - 1) // 2 before,
k // 2 after), where a symmetric pad would shift every output.

The JAX cell's peepholes start at zero; both sides get the same random
non-zero peepholes here, so the check reaches them. Tolerance (fp32):
outputs rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.
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

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)
N, T, HW, CIN, COUT = 2, 3, 6, 2, 3


def _variables(jm, peephole, seed):
    v = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    if peephole:
        rng = np.random.RandomState(seed + 1)
        for k in ("w_ci", "w_cf", "w_co"):
            v["params"]["cell"][k] = rng.randn(COUT).astype(np.float32) * .5
    return v


@pytest.mark.parametrize("peephole", [True, False],
                         ids=["peephole", "plain"])
@pytest.mark.parametrize("kernel", [3, 5, 2])
def test_convlstm_matches_jax(kernel, peephole):
    jm = jnn.Recurrent(jnn.ConvLSTMPeephole(CIN, COUT, kernel=kernel,
                                            with_peephole=peephole))
    tm = tnn.Recurrent(tnn.ConvLSTMPeephole(CIN, COUT, kernel=kernel,
                                            with_peephole=peephole))
    variables = _variables(jm, peephole, kernel)
    x = np.random.RandomState(kernel).randn(N, T, HW, HW, CIN) \
        .astype(np.float32)
    wts = np.random.RandomState(9).randn(N, T, HW, HW, COUT) \
        .astype(np.float32)

    @jax.jit
    def jrun(p):
        def loss(p):
            out = jm.apply({"params": p, "state": {}}, jnp.asarray(x))[0]
            return jnp.sum(jnp.sin(out) * wts), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        return out, g

    jout, jg = jrun(variables["params"])
    tparams = params_from_jax(variables["params"], device="cpu")
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(tparams)]
    tout = tm.apply({"params": tparams, "state": {}}, torch.tensor(x))[0]
    assert tout.shape == (N, T, HW, HW, COUT)
    tg = torch.autograd.grad((torch.sin(tout) * torch.tensor(wts)).sum(),
                             leaves)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


def test_convlstm_params_and_state_shapes_as_jax():
    jm = jnn.Recurrent(jnn.ConvLSTMPeephole(CIN, COUT, kernel=2),
                       return_state=True)
    tm = tnn.Recurrent(tnn.ConvLSTMPeephole(CIN, COUT, kernel=2),
                       return_state=True)
    jv = jm.init(jax.random.PRNGKey(0))
    tv = tm.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = {p: tuple(a.shape) for p, a in tree_leaves_with_path(
        jax.device_get(jv["params"]))}
    tshapes = {p: tuple(a.shape) for p, a in tree_leaves_with_path(
        tv["params"])}
    assert tshapes == jshapes
    (out, (h, c)), _ = tm.apply(tv, torch.zeros(N, T, HW, HW, CIN))
    assert out.shape == (N, T, HW, HW, COUT)
    assert h.shape == c.shape == (N, HW, HW, COUT)
    assert torch.equal(out[:, -1], h)
