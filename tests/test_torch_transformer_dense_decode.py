"""The dense-cache decode trio of the port's TransformerLM (`init_cache`,
`prefill`, `decode_step`, bigdl_tpu_torch/models/transformer.py)
against the JAX package's methods, the cases of tests/test_serving.py's
TestDecodeParity, at a tiny size (vocab 50, dim 32, 2 heads, 2 layers,
max_len 64), the JAX weights carried across by
`models/convert.params_from_jax`.

Tolerances: fp32 logits within atol 1e-5 of the JAX methods' (and of
the port's own full forward) — two frameworks' fp32 gemms, layer norms
and softmaxes summing in different orders over two layers; a bf16 cache
within 0.1 of the full forward's log-probs, as the JAX test holds its
own; the stacked and per-layer weight layouts bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.parallel.collectives import bind

CFG = dict(vocab_size=50, dim=32, num_heads=2, num_layers=2, max_len=64)
ATOL = 1e-5
BF16_ATOL = 0.1


@pytest.fixture(scope="module")
def models():
    jm = build_lm(**CFG)
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, 50, shape).astype(
        np.int32)


def _log_softmax(t):
    return torch.log_softmax(t, dim=-1).numpy()


def _jax_log_softmax(a):
    return np.asarray(jax.nn.log_softmax(a))


def test_init_cache_layout(models):
    jm, _, tm, _ = models
    cache = tm.init_cache(3, 40, device="cpu")
    jcache = jm.init_cache(3, 40)
    assert len(cache) == len(jcache) == CFG["num_layers"]
    for layer, jlayer in zip(cache, jcache):
        assert set(layer) == set(jlayer) == {"k", "v"}
        for name in ("k", "v"):
            assert tuple(layer[name].shape) == jlayer[name].shape \
                == (3, 2, 40, 16)
            assert layer[name].dtype == torch.float32
            assert layer[name].device.type == "cpu"
            assert not layer[name].any()
    full = tm.init_cache(1, dtype=torch.bfloat16, device="cpu")
    assert full[0]["k"].shape[2] == CFG["max_len"]
    assert full[0]["v"].dtype == torch.bfloat16


def test_matches_jax_and_full_forward_fp32(models):
    """Prefill of 12 tokens, then 8 decode steps: each step's logits
    equal the JAX methods' and the full forward's at that position."""
    jm, variables, tm, params = models
    toks = _tokens(0, (2, 20))
    full, _ = tm.apply({"params": params}, torch.from_numpy(toks))
    cache = tm.init_cache(2, 64, device="cpu")
    jcache = jm.init_cache(2, 64)
    logits, out = tm.prefill({"params": params},
                             torch.from_numpy(toks[:, :12]), cache)
    assert out is cache                     # written in place, returned
    jlogits, jcache = jm.prefill(variables, jnp.asarray(toks[:, :12]),
                                 jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(_log_softmax(logits), full[:, 11].numpy(),
                               rtol=0, atol=ATOL)
    for layer, jlayer in zip(cache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name][:, :, :12].numpy(),
                                       np.asarray(jlayer[name])[:, :, :12],
                                       rtol=0, atol=ATOL)
    for t in range(12, 20):
        pos = np.full((2,), t, np.int32)
        logits, cache = tm.decode_step({"params": params},
                                       torch.from_numpy(toks[:, t]),
                                       torch.from_numpy(pos), cache)
        jlogits, jcache = jm.decode_step(variables, jnp.asarray(toks[:, t]),
                                         jnp.asarray(pos), jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(_log_softmax(logits),
                                   full[:, t].numpy(), rtol=0, atol=ATOL)


def test_ragged_prefill_lengths(models):
    """Right-padded prompts: each row's logits are its last real
    token's, unaffected by the pad tail, as in the JAX package; decode
    from the ragged clocks continues each row."""
    jm, variables, tm, params = models
    toks = _tokens(1, (2, 12))
    lengths = np.array([5, 9], np.int32)
    full, _ = tm.apply({"params": params}, torch.from_numpy(toks))
    cache = tm.init_cache(2, 64, device="cpu")
    logits, cache = tm.prefill({"params": params}, torch.from_numpy(toks),
                               cache, lengths=torch.from_numpy(lengths))
    jlogits, jcache = jm.prefill(variables, jnp.asarray(toks),
                                 jm.init_cache(2, 64),
                                 lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    lp = _log_softmax(logits)
    np.testing.assert_allclose(lp[0], full[0, 4].numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lp[1], full[1, 8].numpy(), rtol=0,
                               atol=ATOL)
    # the next token of each row at its own clock, over the pad garbage
    nxt = toks[np.arange(2), lengths]
    logits, _ = tm.decode_step({"params": params}, torch.from_numpy(nxt),
                               torch.from_numpy(lengths), cache)
    jlogits, _ = jm.decode_step(variables, jnp.asarray(nxt),
                                jnp.asarray(lengths), jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    lp = _log_softmax(logits)
    np.testing.assert_allclose(lp[0], full[0, 5].numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lp[1], full[1, 9].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("past", [-1, 0, 3], ids=["last", "end", "past"])
def test_clock_at_and_past_the_table(models, past):
    """A decode clock at max_len - 1, max_len and max_len + 3 (row 0;
    row 1 decodes at 12): the JAX step's gather reads the last
    positional row and its dynamic_update_slice writes the cache's last
    slot, while the mask keeps the raw clock. The port matches it,
    logits and cache, and raises nothing."""
    jm, variables, tm, params = models
    toks = _tokens(5, (2, 13))
    cache = tm.init_cache(2, 64, device="cpu")
    jcache = jm.init_cache(2, 64)
    _, cache = tm.prefill({"params": params},
                          torch.from_numpy(toks[:, :12]), cache)
    _, jcache = jm.prefill(variables, jnp.asarray(toks[:, :12]), jcache)
    pos = np.array([CFG["max_len"] + past, 12], np.int32)
    logits, cache = tm.decode_step({"params": params},
                                   torch.from_numpy(toks[:, 12]),
                                   torch.from_numpy(pos), cache)
    jlogits, jcache = jm.decode_step(variables, jnp.asarray(toks[:, 12]),
                                     jnp.asarray(pos), jcache)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    for layer, jlayer in zip(cache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jlayer[name]), rtol=0,
                                       atol=ATOL)


def test_bf16_cache_loose(models):
    jm, variables, tm, params = models
    toks = _tokens(2, (1, 10))
    full, _ = tm.apply({"params": params}, torch.from_numpy(toks))
    jfull, _ = jm.apply(variables, jnp.asarray(toks))
    cache = tm.init_cache(1, 64, dtype=torch.bfloat16, device="cpu")
    jcache = jm.init_cache(1, 64, dtype=jnp.bfloat16)
    assert cache[0]["k"].dtype == torch.bfloat16
    _, cache = tm.prefill({"params": params}, torch.from_numpy(toks[:, :6]),
                          cache)
    _, jcache = jm.prefill(variables, jnp.asarray(toks[:, :6]), jcache)
    for t in range(6, 10):
        pos = np.full((1,), t, np.int32)
        logits, cache = tm.decode_step({"params": params},
                                       torch.from_numpy(toks[:, t]),
                                       torch.from_numpy(pos), cache)
        jlogits, jcache = jm.decode_step(variables, jnp.asarray(toks[:, t]),
                                         jnp.asarray(pos), jcache)
        np.testing.assert_allclose(_log_softmax(logits), full[:, t].numpy(),
                                   rtol=0, atol=BF16_ATOL)
        np.testing.assert_allclose(_jax_log_softmax(jlogits),
                                   np.asarray(jfull[:, t]), rtol=0,
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=BF16_ATOL)


def test_serving_params_layout_identical(models):
    """The per-layer layout is a pure repack: prefill and decode give
    the stacked layout's logits bit for bit."""
    _, _, tm, params = models
    sp = tm.serving_params({"params": params})
    assert isinstance(sp["blocks"], tuple)
    toks = torch.from_numpy(_tokens(3, (2, 10)))
    l1, c1 = tm.prefill({"params": params}, toks,
                        tm.init_cache(2, 64, device="cpu"))
    l2, c2 = tm.prefill({"params": sp}, toks,
                        tm.init_cache(2, 64, device="cpu"))
    assert torch.equal(l1, l2)
    pos = torch.full((2,), 10, dtype=torch.int32)
    d1, _ = tm.decode_step({"params": params}, toks[:, -1], pos, c1)
    d2, _ = tm.decode_step(sp, toks[:, -1], pos, c2)
    assert torch.equal(d1, d2)


def test_guards():
    """The dense trio refuses what the JAX one refuses: `sp_axis`,
    `tp_axis` (the paged trio takes it), MoE, non-causal models and a
    cache longer than the positional table — with the JAX messages."""
    small = dict(vocab_size=8, dim=16, num_heads=2, num_layers=1,
                 max_len=8)
    sp = TransformerLM(TransformerConfig(**small), device="cpu",
                       sp_axis="seq")
    with pytest.raises(NotImplementedError, match="single-mesh"):
        sp.init_cache(1, 8)
    tp = TransformerLM(TransformerConfig(**small), device="cpu",
                       tp_axis="model")
    mesh = SimpleNamespace(shape={"model": 2}, coords={"model": 0},
                           groups={"model": None})
    with bind(mesh):
        assert tp.init_block_pool(3, 4)[0]["k"].shape == (3, 1, 4, 8)
        for call in (lambda: tp.init_cache(1, 8),
                     lambda: tp.prefill({}, torch.zeros(1, 2), ()),
                     lambda: tp.decode_step({}, torch.zeros(1),
                                            torch.zeros(1), ())):
            with pytest.raises(NotImplementedError, match="single-mesh"):
                call()
    moe = TransformerLM(TransformerConfig(**small, moe_experts=2),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.init_cache(1, 8)
    bidir = TransformerLM(TransformerConfig(**small, causal=False),
                          device="cpu")
    with pytest.raises(ValueError, match="causal"):
        bidir.init_cache(1, 8)
    m = TransformerLM(TransformerConfig(**dict(small, max_len=16)),
                      device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        m.init_cache(1, 32)
