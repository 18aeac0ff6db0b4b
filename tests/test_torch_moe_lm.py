"""The MoE-FFN Transformer-LM of the port (bigdl_tpu_torch/models/
transformer.py with `moe_experts > 0`, routing through
bigdl_tpu_torch/parallel/moe.py) against the JAX package's, weights
carried across by `models/convert.params_from_jax` (the expert-stacked
block leaves carry across unchanged): `loss()` — the chunked NLL plus
`moe_aux_weight` times the summed load-balancing aux — and its
gradients for top-1 and top-2 routing with a capacity that drops
tokens, and two `Optimizer(...).optimize()` steps with ChunkedSoftmaxCE
against the JAX Optimizer's.

Tolerances (fp32): losses within 1e-5 absolute; gradients within 1e-5
absolute; the two steps' losses within 1e-5 and the weights after them
within 1e-5 relative (1e-6 absolute floor). The tests rely on seeded
random gates having no ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.text import synthetic_next_token as jsyn
from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                          TransformerLM as JLM)
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.text import synthetic_next_token as tsyn
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32,
           moe_experts=4, moe_capacity_factor=1.0)
TOL = 1e-5
STEPS = 2


def _seeded(jm, seed=0):
    """The JAX model's parameter tree, its shapes from `eval_shape` and
    its values seeded numpy draws (a real init compiles a threefry draw
    per leaf): the norms' gains near 1, everything else near 0."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    return {k: ({b: (1.0 if b.endswith("_g") else 0.0)
                 + np.float32(0.1) * rng.randn(*a.shape).astype(np.float32)
                 for b, a in v.items()} if k == "blocks" else
                (1.0 if k.endswith("_g") else 0.0)
                + np.float32(0.1) * rng.randn(*v.shape).astype(np.float32))
            for k, v in shapes.items()}


def _pair(top_k):
    jm = JLM(JCfg(**CFG, moe_top_k=top_k))
    variables = {"params": _seeded(jm), "state": {}}
    tm = TransformerLM(TransformerConfig(**CFG, moe_top_k=top_k),
                       device="cpu")
    return jm, variables, tm, params_from_jax(variables["params"],
                                              device="cpu")


def _tokens():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 61, (4, 32)).astype(np.int32),
            rng.randint(0, 61, (4, 32)).astype(np.int32))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_loss_and_grads_match_jax(top_k):
    jm, variables, tm, params = _pair(top_k)
    x, y = _tokens()

    def jloss(p):
        return jm.loss({"params": p, "state": {}}, jnp.asarray(x),
                       jnp.asarray(y), chunk=8)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    p = params
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_()
    tl = tm.loss({"params": p}, torch.from_numpy(x), torch.from_numpy(y),
                 chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL,
                               rtol=0)
    # the aux term is in the loss: the capacity drops tokens
    with torch.no_grad():
        hidden, aux = tm.apply_hidden({"params": p}, torch.from_numpy(x),
                                      with_aux=True)
    assert float(aux) > 0
    assert sum(int(r["dropped_first"]) + int(r.get("dropped_second", 0))
               for r in tm.moe_routes) > 0
    for (path, _), g, jgl in zip(tree_leaves_with_path(p), grads,
                                 jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), atol=TOL,
                                   rtol=0, err_msg=str(path))


def _run(pkg, model):
    if pkg == "jax":
        o = jopt.Optimizer(model, JDataSet.array(jsyn(8, 61, 32)),
                           jnn.ChunkedSoftmaxCE(chunk=8), batch_size=4)
        m = jopt
    else:
        o = topt.Optimizer(model, TDataSet.array(tsyn(8, 61, 32)),
                           tnn.ChunkedSoftmaxCE(chunk=8), batch_size=4)
        m = topt
    losses = []

    def end(state):
        if state["loss"] is not None:
            losses.append(float(state["loss"]))
        return state["neval"] >= STEPS

    o.set_optim_method(m.SGD(0.5, momentum=0.9)).set_precision("fp32") \
        .set_end_when(m.Trigger(end))
    return losses, o.optimize()


def test_two_optimizer_steps_match_jax():
    jm, variables, tm, params = _pair(2)
    jm.variables = {"params": jax.tree_util.tree_map(
        jnp.asarray, variables["params"]), "state": {}}
    tm.variables = {"params": params, "state": {}}
    jl, jm = _run("jax", jm)
    tl, tm = _run("torch", tm)
    assert len(tl) == len(jl) == STEPS
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    for (path, a), b in zip(tree_leaves_with_path(tm.variables["params"]),
                            jax.tree_util.tree_leaves(
                                jm.variables["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-6, err_msg=str(path))
