"""Paged KV primitives of the PyTorch port (bigdl_tpu_torch/ops/kv_cache.py)
against their JAX counterparts (bigdl_tpu/ops/kv_cache.py) on the same
numpy inputs.

Tolerances: the writes and the gather move values without arithmetic,
so they must agree BITWISE. `block_attention` and `paged_attention`
reduce in fp32 in two frameworks whose matmul kernels sum in different
orders: atol 1e-6, rtol 1e-5 (a few fp32 ulps at these magnitudes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import kv_cache as jkv
from bigdl_tpu_torch.ops import kv_cache as tkv

ATOL, RTOL = 1e-6, 1e-5


def _pool(rng, n, h, bs, d):
    return rng.randn(n, h, bs, d).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_init_block_pool_shape_and_zeros():
    k, v = tkv.init_block_pool(5, 2, 4, 8, device=torch.device("cpu"))
    jk, _ = jkv.init_block_pool(5, 2, 4, 8)
    assert tuple(k.shape) == tuple(jk.shape) == (5, 2, 4, 8)
    assert k.dtype == torch.float32 and not k.any() and not v.any()


@pytest.mark.parametrize("s", [8, 6, 1])
def test_write_prompt_blocks_bitwise(s):
    rng = np.random.RandomState(s)
    h, bs, d = 2, 4, 8
    kp, vp = _pool(rng, 9, h, bs, d), _pool(rng, 9, h, bs, d)
    kn = rng.randn(1, h, s, d).astype(np.float32)
    vn = rng.randn(1, h, s, d).astype(np.float32)
    ids = np.array([7, 3][:-(-s // bs)], np.int32)
    jk, jv = jkv.write_prompt_blocks(jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(ids))
    tk, tv = _t(kp), _t(vp)
    tkv.write_prompt_blocks(tk, tv, _t(kn), _t(vn), _t(ids))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_decode_blocks_bitwise():
    rng = np.random.RandomState(1)
    b, h, bs, d = 3, 2, 4, 8
    kp, vp = _pool(rng, 9, h, bs, d), _pool(rng, 9, h, bs, d)
    kn = rng.randn(b, h, 1, d).astype(np.float32)
    vn = rng.randn(b, h, 1, d).astype(np.float32)
    ids = np.array([4, 1, 6], np.int32)
    offs = np.array([0, 3, 2], np.int32)
    jk, jv = jkv.write_decode_blocks(jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(ids), jnp.asarray(offs))
    tk, tv = _t(kp), _t(vp)
    tkv.write_decode_blocks(tk, tv, _t(kn), _t(vn), _t(ids), _t(offs))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gather_block_cache_bitwise():
    rng = np.random.RandomState(2)
    pool = _pool(rng, 9, 2, 4, 8)
    table = rng.permutation(np.arange(1, 9))[:6].reshape(2, 3)
    table = table.astype(np.int32)
    ref = jkv.gather_block_cache(jnp.asarray(pool), jnp.asarray(table))
    out = tkv.gather_block_cache(_t(pool), _t(table))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_block_attention_matches_jax():
    rng = np.random.RandomState(3)
    b, h, nq, s, d = 2, 2, 5, 12, 8
    q = rng.randn(b, h, nq, d).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    start = np.array([3, 6])
    jpos = np.arange(s)
    visible = jpos[None, None, :] <= (start[:, None, None]
                                      + np.arange(nq)[None, :, None])
    valid = jpos[None, :] < (start + nq)[:, None]
    v[1, :, 11] = np.nan          # beyond row 1's valid region
    ref = jkv.block_attention(*map(jnp.asarray, (q, k, v, visible, valid)))
    out = tkv.block_attention(*map(_t, (q, k, v, visible, valid)))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pos", [[0, 3, 4, 15], [7, 9, 1, 12]])
def test_paged_attention_matches_jax(pos):
    rng = np.random.RandomState(4)
    b, h, nb, bs, d = 4, 2, 4, 4, 8
    n = 1 + b * nb
    kp, vp = _pool(rng, n, h, bs, d), _pool(rng, n, h, bs, d)
    kp[0] = np.nan                # scratch block: never read unmasked
    vp[0] = np.nan
    table = rng.permutation(np.arange(1, n)).reshape(b, nb)
    table = table.astype(np.int32)
    pos = np.asarray(pos, np.int32)
    for r, p in enumerate(pos):   # entries past the clock's block are
        table[r, p // bs + 1:] = 0  # unassigned: the scratch block
    q = rng.randn(b, h, 1, d).astype(np.float32)
    ref = jkv.paged_attention(*map(jnp.asarray, (q, kp, vp, table, pos)))
    out = tkv.paged_attention(*map(_t, (q, kp, vp, table, pos)))
    assert out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_paged_attention_rejects_multi_row_query():
    with pytest.raises(ValueError, match="one row"):
        tkv.paged_attention(torch.zeros(1, 1, 2, 8),
                            torch.zeros(2, 1, 4, 8),
                            torch.zeros(2, 1, 4, 8),
                            torch.ones(1, 1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))
