"""Training half of the port's Transformer-LM
(bigdl_tpu_torch/models/transformer.py) against the JAX package's
TransformerLM, weights carried across by `models/convert.params_from_jax`,
at a tiny size (vocab 61, dim 32, 2 heads, 2 layers, S=32).

Tolerances (fp32): hidden states, log-probs, the fused loss and every
gradient within 1e-4 absolute — two frameworks' fp32 gemms, layer norms
and softmaxes summing in different orders over two layers. The remat
policies change what is recomputed, never the math: each gives the
same loss and gradients as remat off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                          TransformerLM as JLM,
                                          lm_train_matmul_flops_per_token
                                          as jflops)
from bigdl_tpu_torch.models.convert import (params_from_jax,
                                            params_to_numpy, tree_leaves)
from bigdl_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, lm_train_matmul_flops_per_token)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32)
ATOL = 1e-4
REMAT = [(False, "full"), (True, "full"), (True, "attn_saved"),
         (True, "dots")]
REMAT_IDS = ["off", "full", "attn_saved", "dots"]


def _tokens(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 61, (b, s)).astype(np.int32),
            rng.randint(0, 61, (b, s)).astype(np.int32))


def _pair(**kw):
    jm = JLM(JCfg(**CFG, **kw))
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG, **kw), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def test_apply_hidden_and_log_probs_match_jax():
    jm, variables, tm, params = _pair()
    x, _ = _tokens()
    jh = jm.apply_hidden(variables, jnp.asarray(x))
    th = tm.apply_hidden({"params": params}, torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=0)
    jlp, _ = jm.apply(variables, jnp.asarray(x))
    tlp, state = tm.apply({"params": params, "state": {}},
                          torch.from_numpy(x))
    assert state == {}
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("remat, policy", REMAT, ids=REMAT_IDS)
def test_loss_and_grads_match_jax(remat, policy):
    jm, variables, tm, params = _pair(remat=remat, remat_policy=policy)
    x, y = _tokens(1)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        {"params": p, "state": {}}, jnp.asarray(x), jnp.asarray(y),
        chunk=8))(variables["params"])
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    tl = tm.loss({"params": params}, torch.from_numpy(x),
                 torch.from_numpy(y), chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= ATOL
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_remat_policies_agree_inside_the_port():
    """remat off == "full" == "attn_saved" == "dots" on one weight set:
    recomputation changes nothing but memory."""
    *_, params = _pair()
    x, y = _tokens(2)
    ref = None
    for remat, policy in REMAT:
        tm = TransformerLM(TransformerConfig(**CFG, remat=remat,
                                             remat_policy=policy),
                           device="cpu")
        p = {k: v for k, v in params.items()}
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        p = _rebuild(params, leaves)
        loss = tm.loss({"params": p}, torch.from_numpy(x),
                       torch.from_numpy(y), chunk=16)
        got = [loss.detach()] + list(torch.autograd.grad(loss, leaves))
        if ref is None:
            ref = got
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _rebuild(tree, leaves):
    """`tree` with its leaves (jax order) replaced by `leaves`."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(tree)


def test_params_to_numpy_round_trips():
    _, variables, _, params = _pair()
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_dropout_needs_a_generator_and_uses_it():
    tm = TransformerLM(TransformerConfig(**CFG, dropout=0.5), device="cpu")
    p = tm.init_params()
    x, _ = _tokens(3)
    x = torch.from_numpy(x)
    with pytest.raises(ValueError, match="dropout needs rng"):
        tm.apply_hidden({"params": p}, x, training=True)
    a = tm.apply_hidden({"params": p}, x, training=True,
                        rng=torch.Generator().manual_seed(1))
    b = tm.apply_hidden({"params": p}, x, training=True,
                        rng=torch.Generator().manual_seed(1))
    c = tm.apply_hidden({"params": p}, x, training=False)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_flops_per_token_matches_jax():
    for causal in (True, False):
        cfg = dict(vocab_size=32000, dim=512, num_heads=8, num_layers=8,
                   max_len=2048, causal=causal)
        assert lm_train_matmul_flops_per_token(TransformerConfig(**cfg)) \
            == jflops(JCfg(**cfg))


def test_module_surface():
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu", name="lm")
    assert isinstance(tm, torch.nn.Module)
    variables = tm.build(torch.Generator().manual_seed(0)).variables
    assert set(variables) == {"params", "state"}
    names = [n for n, _ in tm.parameters()]
    assert names[0] == "blocks.b1" and "embed" in names
    assert len(names) == len(tree_leaves(variables["params"]))
    with pytest.raises(TypeError, match="tree_map"):
        tm.to("cpu")                  # would move none of the variables
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerConfig(remat_policy="everything")


@pytest.mark.parametrize("what", ["moe", "sp", "tp"])
def test_unported_training_variants_raise(what):
    """The variants that raised before queue A.8 step 5 was ported now
    build (their parity with the JAX package is held in
    test_torch_moe_lm.py, test_torch_ring_attention.py and
    test_torch_tensor_parallel.py); what still raises raises as the
    JAX package does."""
    if what == "moe":
        kw = dict(moe_experts=4, moe_top_k=2)
        tm = TransformerLM(TransformerConfig(**CFG, **kw), device="cpu")
        jm = JLM(JCfg(**CFG, **kw))
        want = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
        got = tm.init_params()
        assert [tuple(t.shape) for t in tree_leaves(got)] == \
            [tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]
        with pytest.raises(NotImplementedError, match="tensor "
                           "parallelism"):
            TransformerLM(TransformerConfig(**CFG, **kw), device="cpu",
                          tp_axis="model")
        with pytest.raises(ValueError, match="moe_top_k"):
            TransformerConfig(**CFG, moe_experts=4, moe_top_k=3)
        return
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu",
                       **{f"{what}_axis": "x"})
    assert getattr(tm, f"{what}_axis") == "x"
    x, _ = _tokens()
    # the axis resolves through a bound mesh, as shard_map binds it
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tm.apply_hidden({"params": tm.init_params()}, torch.from_numpy(x))
    with pytest.raises(ValueError, match="ep_axis requires"):
        TransformerLM(TransformerConfig(**CFG), device="cpu", ep_axis="x")
    with pytest.raises(ValueError, match="zigzag sp_mode requires"):
        TransformerLM(TransformerConfig(**CFG, causal=False),
                      device="cpu", sp_axis="x", sp_mode="zigzag")


def test_model_without_cuda_raises():
    """Entry points run on the GPU unless told otherwise; without CUDA
    they raise instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerConfig(**CFG))
