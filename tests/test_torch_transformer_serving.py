"""Serving half of the port's Transformer-LM
(bigdl_tpu_torch/models/transformer.py) against the JAX package's
TransformerLM, with the JAX weights carried across by
`models/convert.params_from_jax`, at a tiny size (vocab 61, dim 32,
2 heads, 2 layers, max_len 32, block_size 4).

Tolerances: the KV pools `prefill_paged` writes agree within atol 1e-5
and the `decode_step_paged` logits within atol 1e-4 over 4 steps — two
frameworks' fp32 gemms, layer norms and softmaxes summing in different
orders, compounding over layers and steps. Inside the port the warm ==
cold promise of the prefix cache holds BITWISE on the CPU: a suffix
prefill after a cached prefix writes the same KV bits as a cold
prefill, and decode over either pool gives the same logits bits."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.parallel.collectives import bind
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32)
BS = 4
NB = CFG["max_len"] // BS
POOL_ATOL = 1e-5
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = build_lm(**CFG)
    variables = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jax.device_get(variables["params"]),
                             device="cpu")
    return jm, variables, tm, params


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 61, (1, n)).astype(
        np.int32)


def _tab(blocks):
    t = np.zeros((1, NB), np.int32)
    t[0, :len(blocks)] = blocks
    return t


def _np_pools(pools):
    return [{k: np.asarray(v, np.float32) for k, v in layer.items()}
            for layer in pools]


def test_params_from_jax_stacked_and_per_layer(models):
    jm, variables, tm, params = models
    per_layer = params_from_jax(jax.device_get(
        jm.serving_params(variables)), device="cpu")
    assert set(params) == {"embed", "pos", "blocks", "lnf_g", "lnf_b"}
    assert params["blocks"]["wq"].shape == (2, 32, 32)
    for k, v in params["blocks"].items():
        assert torch.equal(v, per_layer["blocks"][k]), k
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(variables["params"]["blocks"][k]))
    assert torch.equal(params["embed"], per_layer["embed"])
    assert tm.head(params).shape == (32, 61)


def test_init_params_layout_matches_jax(models):
    jm, variables, tm, _ = models
    fresh = tm.init_params(torch.Generator().manual_seed(1))
    jp = variables["params"]
    assert set(fresh) == set(jp)
    for k, v in fresh["blocks"].items():
        assert tuple(v.shape) == tuple(jp["blocks"][k].shape), k
    # N(0, 1) * fan_in ** -0.5: the gemm weights' spread matches
    assert abs(float(fresh["blocks"]["w1"].std()) - 32 ** -0.5) < 0.02
    assert abs(float(fresh["embed"].std()) - 0.02) < 0.005


def test_unported_variants_raise():
    """An MoE config builds now; decoding an MoE or `sp_axis` model
    raises as the JAX package's does, and a `tp_axis` model's pool
    (A.8 step 6, under the mesh serving/tp.py binds) holds this rank's
    heads only."""
    moe = TransformerLM(TransformerConfig(**CFG, moe_experts=4),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.init_block_pool(NB + 1, BS)
    sp = TransformerLM(TransformerConfig(**CFG), device="cpu",
                       sp_axis="seq")
    with pytest.raises(NotImplementedError, match="single-mesh"):
        sp.init_block_pool(NB + 1, BS)
    tp = TransformerLM(TransformerConfig(**CFG), device="cpu",
                       tp_axis="model")
    whole = TransformerLM(TransformerConfig(**CFG), device="cpu")
    full = whole.init_block_pool(NB + 1, BS)[0]["k"].shape
    for coord in (0, 1):
        mesh = SimpleNamespace(shape={"model": 2}, coords={"model": coord},
                               groups={"model": None})
        with bind(mesh):
            pools = tp.init_block_pool(NB + 1, BS)
        assert len(pools) == CFG["num_layers"]
        for leaf in pools[0].values():
            assert leaf.shape == (full[0], full[1] // 2) + full[2:]


def test_prefill_paged_pools_match_jax(models):
    jm, variables, tm, params = models
    toks = _prompt(0, 16)
    blocks = np.array([3, 1, 6, 2], np.int32)
    jpools = jm.prefill_paged(variables, jnp.asarray(toks),
                              jm.init_block_pool(1 + 2 * NB, BS),
                              jnp.asarray(_tab(blocks)),
                              jnp.asarray(blocks), 0)
    tpools = tm.prefill_paged(params, torch.from_numpy(toks),
                              tm.init_block_pool(1 + 2 * NB, BS),
                              torch.from_numpy(_tab(blocks)),
                              torch.from_numpy(blocks), 0)
    for jl, tl in zip(_np_pools(jpools), _np_pools(tpools)):
        for leaf in ("k", "v"):
            assert np.abs(tl[leaf]).max() > 0.1
            np.testing.assert_allclose(tl[leaf], jl[leaf],
                                       atol=POOL_ATOL, rtol=0)


def test_decode_step_paged_logits_match_jax(models):
    jm, variables, tm, params = models
    n_pool = 1 + 2 * NB
    jpools = jm.init_block_pool(n_pool, BS)
    tpools = tm.init_block_pool(n_pool, BS)
    lens = (13, 6)
    table = np.zeros((2, NB), np.int32)
    for row, n in enumerate(lens):
        padded = np.zeros((1, 4 * BS), np.int32)   # bucket 16: 4 blocks
        padded[0, :n] = _prompt(10 + row, n)
        ids = np.arange(1 + 4 * row, 5 + 4 * row, dtype=np.int32)
        table[row, :4] = ids
        jpools = jm.prefill_paged(variables, jnp.asarray(padded), jpools,
                                  jnp.asarray(table[row:row + 1]),
                                  jnp.asarray(ids), 0)
        tm.prefill_paged(params, torch.from_numpy(padded), tpools,
                         torch.from_numpy(table[row:row + 1].copy()),
                         torch.from_numpy(ids), 0)
    pos = np.array([n - 1 for n in lens], np.int32)
    tok = np.array([_prompt(10 + r, n)[0, -1] for r, n in
                    enumerate(lens)], np.int32)
    for _ in range(4):
        jl, jpools = jm.decode_step_paged(
            variables, jnp.asarray(tok), jnp.asarray(pos), jpools,
            jnp.asarray(table), attn_impl="xla")
        tl, _ = tm.decode_step_paged(
            params, torch.from_numpy(tok), torch.from_numpy(pos), tpools,
            torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1


def test_warm_equals_cold_bitwise_inside_the_port(models):
    """A position's KV from a cold bucket-16 prefill equals, bit for
    bit, the same position from a warm bucket-8 suffix prefill over a
    reused prefix; decoding over either pool gives the same logits."""
    _, _, tm, params = models
    toks = torch.from_numpy(_prompt(4, 16))
    blocks = torch.arange(1, 5, dtype=torch.int32)
    cold = tm.prefill_paged(params, toks, tm.init_block_pool(1 + NB, BS),
                            torch.from_numpy(_tab(blocks.numpy())),
                            blocks, 0)
    warm = tm.init_block_pool(1 + NB, BS)
    tm.prefill_paged(params, toks[:, :8], warm,
                     torch.from_numpy(_tab([1, 2])), blocks[:2], 0)
    tm.prefill_paged(params, toks[:, 8:], warm,
                     torch.from_numpy(_tab(blocks.numpy())), blocks[2:],
                     8)
    for lc, lw in zip(cold, warm):
        for leaf in ("k", "v"):
            assert torch.equal(lc[leaf][1:5], lw[leaf][1:5])
    # decode the last prompt token again (the engine's first step) and
    # two more, with a second row so the gemms have M >= 2
    table = torch.zeros(2, NB, dtype=torch.int32)
    table[0, :4] = blocks
    tok = torch.tensor([int(toks[0, -1]), 7], dtype=torch.int32)
    pos = torch.tensor([15, 0], dtype=torch.int32)
    for _ in range(3):
        lc, _ = tm.decode_step_paged(params, tok, pos, cold, table)
        lw, _ = tm.decode_step_paged(params, tok, pos, warm, table)
        assert torch.equal(lc, lw)
        tok = lc.argmax(-1).to(torch.int32)
        pos = pos + 1
