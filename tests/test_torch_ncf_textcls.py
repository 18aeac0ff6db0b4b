"""The port's NeuralCF, TextClassifier and Autoencoder
(bigdl_tpu_torch/models/ncf.py, textclassifier.py, autoencoder.py)
against the JAX package's, at small widths, from the same seeded
weights carried across with `params_from_jax`.

Tolerances (fp32): the loss (ClassNLLCriterion, or MSECriterion for
the autoencoder) within 1e-5 relative, the outputs rtol 1e-5 / atol
1e-6, every parameter's gradient within 1e-4 of its largest entry.
`set_embedding` installs a GloVe-shaped array in both packages alike
and refuses one of the wrong shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import autoencoder as jae
from bigdl_tpu.models import ncf as jncf
from bigdl_tpu.models import textclassifier as jtc
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import autoencoder as tae
from bigdl_tpu_torch.models import ncf as tncf
from bigdl_tpu_torch.models import textclassifier as ttc
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_map)

GRAD_TOL = 1e-4


def _seeded(module, seed):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0))
    return {"params": jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32),
        shapes["params"]), "state": shapes["state"]}      # no leaves


def _check(jm, tm, x, y, criteria):
    jc, tc = criteria
    jv = _seeded(jm, 0)
    tp = params_from_jax(jv["params"], device="cpu")

    @jax.jit
    def jloss(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]},
                          jnp.asarray(x))
        return jc.forward(out, jnp.asarray(y)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jv["params"])
    p = tree_map(lambda t: t.requires_grad_(), tp)
    tout, _ = tm.apply({"params": p, "state": tm.init_state()},
                       torch.from_numpy(x))
    tl = tc(tout, torch.from_numpy(y))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    jl = float(jl)
    assert abs(float(tl.detach()) - jl) <= 1e-5 * max(1.0, abs(jl))
    grads = torch.autograd.grad(tl, tree_leaves(p))
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * max(float(np.abs(b).max()), 1e-12)


@pytest.mark.parametrize("include_mf", [True, False], ids=["gmf", "mlp"])
def test_ncf_matches_jax(include_mf):
    rng = np.random.RandomState(1)
    x = np.stack([rng.randint(0, 30, 16), rng.randint(0, 40, 16)],
                 1).astype(np.int32)
    y = rng.randint(0, 5, 16).astype(np.int32)
    kw = dict(class_num=5, user_embed=6, item_embed=5, hidden_layers=(8, 4),
              include_mf=include_mf, mf_embed=3)
    _check(jncf.build(30, 40, **kw), tncf.build(30, 40, **kw), x, y,
           (jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()))


def test_textclassifier_matches_jax():
    rng = np.random.RandomState(2)
    kw = dict(class_num=4, vocab_size=50, sequence_len=150,
              embedding_dim=8, filters=6)
    x = rng.randint(0, 50, (3, 150)).astype(np.int32)
    y = rng.randint(0, 4, 3).astype(np.int32)
    _check(jtc.build(**kw), ttc.build(**kw), x, y,
           (jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()))


def test_autoencoder_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.rand(5, 7, 7, 1).astype(np.float32)
    _check(jae.build(8, 49), tae.build(8, 49), x, x.reshape(5, 49),
           (jnn.MSECriterion(), tnn.MSECriterion()))


def test_set_embedding_matches_jax():
    kw = dict(class_num=4, vocab_size=50, sequence_len=150,
              embedding_dim=8, filters=6)
    jm, tm = jtc.build(**kw), ttc.build(**kw)
    jv = _seeded(jm, 4)
    tv = {"params": params_from_jax(jv["params"], device="cpu"),
          "state": tm.init_state()}
    glove = np.random.RandomState(5).randn(50, 8)        # float64 rows
    jnew = jtc.set_embedding(jv, glove)
    tnew = ttc.set_embedding(tv, glove)
    key = "0_embedding"
    got = tnew["params"][key]["weight"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnew["params"][key]["weight"]))
    assert tnew["params"]["1_conv1"] is tv["params"]["1_conv1"]
    x = np.random.RandomState(6).randint(0, 50, (2, 150)).astype(np.int32)
    jout, _ = jm.apply(jnew, jnp.asarray(x))
    tout, _ = tm.apply(tnew, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="embedding"):
        ttc.set_embedding(tv, np.zeros((49, 8)))


def test_default_widths():
    """The constructors' defaults are the JAX package's: news20's
    TextClassifier, MNIST's autoencoder, NeuralCF's towers."""
    for jm, tm in ((jtc.build(), ttc.build()), (jae.build(), tae.build()),
                   (jncf.build(6040, 3706), tncf.build(6040, 3706))):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"]
        want = [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
        got = [tuple(t.shape) for t in tree_leaves(tm.init_params(
            torch.Generator().manual_seed(0)))]
        assert got == want
