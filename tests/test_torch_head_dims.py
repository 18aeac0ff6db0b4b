"""The port's attention kernels at every head dim the JAX kernels take:
flash attention above D = 256 (bigdl_tpu_torch/ops/flash_attention.py:
D padded to a multiple of 128, the column-split kernels) and paged
decode at head dims between and above its tiers
(bigdl_tpu_torch/ops/paged_decode.py), plain paths, against the JAX
package's functions run as its own tests run them on the CPU: the
Pallas kernels in interpret mode, which pad the flash D to a multiple
of 128 and stream the paged pools at any D. Then the dispatch the
kernels run by, which needs no card: the padded head dim, the column
slices, K1's tier and copy width.

Tolerances (fp32), those of tests/test_torch_flash_d256.py and
tests/test_torch_paged_decode.py: flash out and LSE within 1e-5
absolute, dq/dk/dv within 1e-4 relative to each tensor's max (two
frameworks' fp32 matmuls and exps over up to 512 columns); paged decode
atol 1e-6, rtol 1e-5 (fp32 pools; bf16 pools atol 1e-5, rtol 1e-4).
The CUDA kernels cannot run here (no nvcc, no card): chip_smoke.py
holds them to these plain versions on the card."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_decode import \
    paged_decode_attention as jax_paged_decode
from bigdl_tpu_torch.ops import paged_decode

tfa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-4
FP32_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=1e-4)

# (BH, Sq, Sk, D, causal): D above 256 at lengths off every tile
# multiple — Sq < Sk, fully masked rows (Sq > Sk), non-causal
FLASH_CASES = [(2, 24, 40, 320, True), (2, 40, 24, 384, True),
               (1, 19, 33, 512, False)]
FLASH_IDS = ["d320", "d384_masked_rows", "d512_noncausal"]


def _inputs(bh, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, sq, d).astype(np.float32)
    k = rng.randn(bh, sk, d).astype(np.float32)
    v = rng.randn(bh, sk, d).astype(np.float32)
    do = rng.randn(bh, sq, d).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_forward_lse_and_backward_match_pallas(case):
    """Forward out and LSE through flash_attention_with_lse (the plain
    path on CPU tensors), and the plain backward fed the Pallas
    forward's (o, lse), against the Pallas forward and fused backward
    in interpret mode."""
    bh, sq, sk, d, causal = case
    q, k, v, do = _inputs(bh, sq, sk, d)
    scale = 1.0 / math.sqrt(d)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, lse = jfa._flash_fwd_pallas(q, k, v, causal, scale, 16, 16,
                                       interpret=True)
        return o, lse, jfa._flash_bwd_pallas_fused(
            q, k, v, o, lse, do, causal, scale, 16, 16, interpret=True)

    jo, jl, jg = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    to, tl = tfa.flash_attention_with_lse(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=OUT_ATOL)
    masked = max(sq - sk, 0) if causal else 0
    assert ((tl.numpy() == np.float32(tfa.NEG_INF)).sum(axis=1)
            == masked).all()
    tg = tfa.flash_attention_backward_reference(
        *_t(q, k, v, np.asarray(jo), np.asarray(jl), do), causal=causal,
        sm_scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert _rel(a.numpy(), b) <= GRAD_RTOL, name


def test_flash_grads_through_autograd_match_jax_grad():
    """torch.autograd through flash_attention on (B, H, S, D) at
    D = 320 against jax.grad through the Pallas kernels (interpret)."""
    shape = (1, 2, 24, 320)
    rng = np.random.RandomState(2)
    q, k, v, w = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    jg = jax.jit(jax.grad(lambda q, k, v: (jfa.flash_attention(
        q, k, v, causal=True, impl="interpret") * w).sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == shape
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        assert _rel(a.grad.numpy(), b) <= GRAD_RTOL, name


@pytest.mark.parametrize("d", [320, 448])
def test_flash_padded_head_dim_matches_the_unpadded(d):
    """What the wrapper does before the column-split kernels: pad to a
    multiple of 128 and slice back; on the plain versions the padded
    forward and backward are the unpadded ones (sm_scale from the
    unpadded D, delta over the unpadded columns), and so are the tiled
    versions (the kernels' arithmetic, the bf16 kernels' oracles on the
    card), within the tolerances: the padded products sum over more
    columns, in another blocking."""
    g = torch.Generator().manual_seed(d)
    q, o_ct = (torch.randn(2, 37, d, generator=g) for _ in "qo")
    k, v = (torch.randn(2, 45, d, generator=g) for _ in "kv")
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.attention_reference(q, k, v, True, scale,
                                       return_lse=True)
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, o_ct)
    assert qp.shape[-1] == tfa.kernel_head_dim(d) == -(-d // 128) * 128
    assert not qp[..., d:].any()
    po, plse = tfa.attention_reference(qp, kp, vp, True, scale,
                                       return_lse=True)
    assert not po[..., d:].any()
    assert (tfa.unpad_head_dim(d, po)[0] - out).abs().max() <= OUT_ATOL
    assert (plse - lse).abs().max() <= OUT_ATOL
    delta = (o_ct * out).sum(-1)
    grads = tfa.flash_attention_backward_reference(q, k, v, out, lse, o_ct,
                                                   True, scale)
    pgrads = tfa.flash_attention_backward_reference(
        qp, kp, vp, tfa.pad_head_dim(out)[0], lse, dop, True, scale,
        delta=delta)
    for a, b in zip(grads, pgrads):
        assert not b[..., d:].any()
        assert _rel(tfa.unpad_head_dim(d, b)[0].numpy(), a.numpy()) \
            <= GRAD_RTOL
    to, tl = tfa.flash_forward_tiled(qp, kp, vp, True, scale)
    assert (to[..., :d] - out).abs().max() <= OUT_ATOL
    assert (tl - lse).abs().max() <= OUT_ATOL
    tg = tfa.flash_backward_tiled(qp, kp, vp, tfa.pad_head_dim(out)[0],
                                  lse, dop, True, scale)
    for a, b in zip(grads, tg):
        assert _rel(b[..., :d].numpy(), a.numpy()) <= GRAD_RTOL


def _paged_case(b, h, nb, bs, d, seed=0):
    rng = np.random.RandomState(seed)
    n = b * nb + 1
    k_pool = rng.randn(n, h, bs, d).astype(np.float32)
    v_pool = rng.randn(n, h, bs, d).astype(np.float32)
    table = rng.permutation(np.arange(1, n))[:b * nb].reshape(b, nb)
    pos = rng.randint(0, nb * bs, size=b).astype(np.int32)
    pos[0] = nb * bs - 1
    q = rng.randn(b, h, 1, d).astype(np.float32)
    return q, k_pool, v_pool, table.astype(np.int32), pos


@pytest.mark.parametrize("d", [20, 48, 80, 320, 1100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_kernel(d, dtype):
    """K1's plain version against the Pallas kernel (interpret) at head
    dims between the tiers (20, 48, 80), above 256 (320) and above the
    tiers (1100, the row-split kernel's)."""
    q, k, v, table, pos = _paged_case(3, 2, 4, 4, d, seed=d)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_paged_decode(jnp.asarray(q), jnp.asarray(k, jd),
                           jnp.asarray(v, jd), jnp.asarray(table),
                           jnp.asarray(pos), impl="interpret")
    out = paged_decode.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(table),
        torch.from_numpy(pos))
    assert out.shape == (3, 2, 1, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               **(BF16_TOL if dtype == "bfloat16"
                                  else FP32_TOL))


def test_flash_dispatch():
    """The head dim the flash kernels run at and their column slices:
    the instantiations up to 256, multiples of 128 above, one CTA a
    128-column slice there; the kernels' checks take nothing else."""
    assert [tfa.kernel_head_dim(d) for d in (1, 33, 200, 256, 257, 320,
                                             384, 385, 512, 1000)] \
        == [32, 64, 256, 256, 384, 384, 384, 512, 512, 1024]
    assert [tfa.column_slices(dp) for dp in (32, 256, 384, 512, 1024)] \
        == [1, 1, 3, 4, 8]
    for bad in (300, 192, 640 + 64):
        with pytest.raises(ValueError, match="multiples of 128"):
            tfa.column_slices(bad)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        tfa.kernel_head_dim(0)
    assert tfa.WIDE_COLS == 128


def test_paged_decode_dispatch():
    """K1's tier (the least instantiation holding D; D itself above them,
    the row-split kernel), its copy width
    (16-byte copies only for rows of whole 16-byte chunks on aligned
    pools) and the shared memory of the tier's layout, within the
    card's 227 KB at the largest tier."""
    tiers = paged_decode.HEAD_DIMS
    assert [paged_decode.kernel_head_dim(d) for d in (1, 8, 9, 20, 48, 80,
                                                      256, 257, 320, 512,
                                                      1000, 1024, 1025,
                                                      4096)] \
        == [8, 8, 16, 32, 64, 96, 256, 384, 384, 512, 1024, 1024, 1025,
            4096]                     # above the tiers: the row-split kernel
    with pytest.raises(ValueError, match="head_dim >= 1"):
        paged_decode.kernel_head_dim(0)
    f32, b16 = torch.zeros(64), torch.zeros(64, dtype=torch.bfloat16)
    assert paged_decode.vector_rows(20, 4, f32, f32)       # 80 bytes
    assert not paged_decode.vector_rows(20, 2, b16, b16)   # 40 bytes
    assert not paged_decode.vector_rows(6, 4, f32, f32)    # 24 bytes
    assert paged_decode.vector_rows(48, 2, b16, b16)
    assert not paged_decode.vector_rows(48, 2, b16, b16[1:])  # offset
    # the smem layout is the tier's: D = 320 takes the 384 tier's bytes
    assert paged_decode.shared_bytes(37, 16, 320, 4) \
        == paged_decode.shared_bytes(37, 16, 384, 4)
    for itemsize in (4, 2):
        assert paged_decode.shared_bytes(
            37, 16, tiers[-1], itemsize) <= paged_decode.MAX_SHARED_BYTES
