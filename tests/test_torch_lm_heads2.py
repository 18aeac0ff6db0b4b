"""The trainer's LM at two heads (head_dim 256, chip_smoke.py's lm2h
phase) through the port (bigdl_tpu_torch/models/transformer.py) against
the JAX package's TransformerLM, weights carried across by
`models/convert.params_from_jax`: dim 512 and two heads as on the card,
cut to 2 layers, vocab 61 and S = 32 so that it runs on the CPU.

Attention on both sides is the plain path at D = 256 (the port's
`impl="torch"` on CPU tensors; the JAX package's default on the CPU),
the path whose kernels chip_smoke.py holds to it on the card.

Tolerances (fp32), those of tests/test_torch_transformer_train.py: the
log-probs, the fused loss and every gradient within 1e-4 absolute — two
frameworks' fp32 gemms, layer norms and softmaxes summing in different
orders over two layers of 512 columns. The decode step, through the
port's paged cache, against its own full forward within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import (TransformerConfig as JCfg,
                                          TransformerLM as JLM)
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)

CFG = dict(vocab_size=61, dim=512, num_heads=2, num_layers=2, max_len=32,
           remat=True, remat_policy="attn_saved")
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = JLM(JCfg(**CFG))
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def _tokens(seed, b=2, s=32):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 61, (b, s)).astype(np.int32),
            rng.randint(0, 61, (b, s)).astype(np.int32))


def test_head_dim_is_256(pair):
    _, _, tm, _ = pair
    assert tm.head_dim == 256


def test_log_probs_match_jax(pair):
    jm, variables, tm, params = pair
    x, _ = _tokens(0)
    jlp, _ = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tlp, _ = tm.apply({"params": params, "state": {}}, torch.from_numpy(x))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL,
                               rtol=0)


def test_loss_and_grads_match_jax(pair):
    jm, variables, tm, params = pair
    x, y = _tokens(1)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        {"params": p, "state": {}}, jnp.asarray(x), jnp.asarray(y),
        chunk=8)))(variables["params"])
    p = {k: v for k, v in params.items()}
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        return next(it)

    tl = tm.loss({"params": rebuild(params)}, torch.from_numpy(x),
                 torch.from_numpy(y), chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= ATOL
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_paged_decode_matches_full_forward(pair):
    """The serving path at D = 256 (the plain paged-decode attention,
    what K1 is held to on the card): prefill 20 tokens into the paged
    pools, then decode the 21st; its next-token log-probs equal the
    full forward's at that position."""
    _, _, tm, params = pair
    x, _ = _tokens(2, b=1)
    n, bs = 20, 16
    sp = tm.serving_params({"params": params})
    pools = tm.init_block_pool(3, bs)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    toks = torch.zeros(1, 32, dtype=torch.int32)
    toks[0, :n] = torch.from_numpy(x[0, :n])
    with torch.no_grad():
        pools = tm.prefill_paged(sp, toks, pools, table, table[0], 0)
        logits, _ = tm.decode_step_paged(
            sp, torch.from_numpy(x[0, n:n + 1]),
            torch.tensor([n], dtype=torch.int32), pools, table,
            attn_impl="torch")
        full, _ = tm.apply({"params": params, "state": {}},
                           torch.from_numpy(x[:, :n + 1]))
    np.testing.assert_allclose(
        torch.log_softmax(logits.float(), -1).numpy()[0],
        full.numpy()[0, n], atol=ATOL, rtol=0)
