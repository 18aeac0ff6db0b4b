"""The port's flash attention at head dims above 128
(bigdl_tpu_torch/ops/flash_attention.py: the D = 256 instantiation, and
D in 129-255 zero-padded to it), plain path, against the JAX package's
flash attention run as its own tests run it on the CPU: the Pallas
kernels in interpret mode, which pad D to a multiple of 128.

Tolerances (fp32), those of tests/test_torch_flash_attention.py:
forward out and LSE within 1e-5 absolute; dq/dk/dv within 1e-4
relative to each tensor's max — two frameworks' fp32 matmuls and exps
summing in different orders, over 256 columns here. The padded plain
path is the unpadded one bit for bit, and the tiled versions (the
kernels' arithmetic, the oracles chip_smoke.py holds the D = 256
kernels to on the card) are the plain versions within the same
tolerances. The CUDA kernels cannot run here (no nvcc, no card)."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tfa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-4
NEG = np.float32(-1e30)

# (BH, Sq, Sk, D, causal): D = 256 with Sq < Sk and with fully masked
# rows (Sq > Sk), and D = 160 (padded to 256 by both packages),
# non-causal, at lengths off every tile multiple
CASES = [(2, 40, 72, 256, True), (2, 72, 40, 256, True),
         (2, 37, 53, 160, False)]
IDS = ["d256", "d256_masked_rows", "d160"]


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_instantiations_reach_256(dtype):
    """The instantiations end at 256; past them every head dim runs at
    the next multiple of 128: in bf16 at 384 on a cluster of two CTAs of
    192 columns each, in fp32 one CTA a tile (one slice)."""
    assert tfa.HEAD_DIMS[-1] == 256
    assert {tfa.kernel_head_dim(d) for d in range(129, 257)} == {256}
    assert {tfa.kernel_head_dim(d) for d in range(257, 385)} == {384}
    assert tfa.column_slices(256, dtype) == 1
    want = tfa.WIDE_BWD_RANKS if dtype == torch.bfloat16 else 1
    assert tfa.column_slices(384, dtype) == want
    assert want == (2 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_lse_match_jax(case):
    bh, sq, sk, d, causal = case
    q, k, v, _ = _inputs(bh, sq, sk, d)
    jo, jl = jax.jit(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, causal=causal, impl="interpret"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tl = tfa.attention_reference(*_t(q, k, v), causal=causal,
                                     return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=OUT_ATOL)
    masked = max(sq - sk, 0) if causal else 0
    assert ((tl.numpy() == NEG).sum(axis=1) == masked).all()
    if masked:
        assert (to.numpy()[:, :masked] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_pallas_backward(case):
    """The plain blockwise backward against both Pallas backward forms
    (K3 fused, K4/K5 split, one compiled function), fed the same (o,
    lse) and do."""
    bh, sq, sk, d, causal = case
    q, k, v, do = _inputs(bh, sq, sk, d, seed=1)
    scale = 1.0 / math.sqrt(d)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, lse = jfa._flash_fwd_pallas(q, k, v, causal, scale, 16, 16,
                                       interpret=True)
        return o, lse, [kern(q, k, v, o, lse, do, causal, scale, 16, 16,
                             interpret=True)
                        for kern in (jfa._flash_bwd_pallas_fused,
                                     jfa._flash_bwd_pallas_split)]

    o, lse, forms = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    tg = tfa.flash_attention_backward_reference(
        *_t(q, k, v, np.asarray(o), np.asarray(lse), do), causal=causal,
        sm_scale=scale)
    for form, jg in zip(("fused", "split"), forms):
        for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
            assert _rel(a.numpy(), b) <= GRAD_RTOL, (form, name)


@pytest.mark.parametrize("d", [256, 160])
def test_grads_through_autograd_match_jax_grad(d):
    """torch.autograd through flash_attention (impl="torch" on CPU
    tensors) on (B, H, S, D) against jax.grad through the Pallas
    kernels in interpret mode."""
    shape = (2, 2, 40, d)
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


@pytest.mark.parametrize("d", [129, 160, 255])
def test_padded_head_dim_is_bitwise_the_unpadded(d):
    """What the wrapper does before the D = 256 kernels: pad to 256 and
    slice back; on the plain versions the padded forward and backward
    equal the unpadded ones bit for bit, sm_scale from the unpadded D
    and delta over the unpadded columns."""
    g = torch.Generator().manual_seed(d)
    q, o_ct = (torch.randn(2, 37, d, generator=g) for _ in "qo")
    k, v = (torch.randn(2, 45, d, generator=g) for _ in "kv")
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.attention_reference(q, k, v, True, scale,
                                       return_lse=True)
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, o_ct)
    assert qp.shape[-1] == 256
    outp, lsep = tfa.attention_reference(qp, kp, vp, True, scale,
                                         return_lse=True)
    assert torch.equal(tfa.unpad_head_dim(d, outp)[0], out)
    assert torch.equal(lsep, lse)
    grads = tfa.flash_attention_backward_reference(q, k, v, out, lse, o_ct,
                                                   True, scale)
    padded = tfa.flash_attention_backward_reference(
        qp, kp, vp, outp, lsep, dop, True, scale,
        delta=(o_ct * out).sum(dim=-1))
    for a, b in zip(tfa.unpad_head_dim(d, *padded), grads):
        assert torch.equal(a, b)
    for t in padded:
        assert not t[..., d:].any()


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_tiled_versions_are_the_plain_versions_in_fp32(case):
    """flash_forward_tiled / flash_backward_tiled (the kernels'
    arithmetic, chip_smoke.py's bf16 oracles) at D = 256 against the
    plain versions: in fp32 only the summation order differs."""
    bh, sq, sk, d, causal = case
    q, k, v, do = _t(*_inputs(bh, sq, sk, d, seed=6))
    ro, rl = tfa.attention_reference(q, k, v, causal, return_lse=True)
    to, tl = tfa.flash_forward_tiled(q, k, v, causal)
    np.testing.assert_allclose(to.numpy(), ro.numpy(), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), rtol=0,
                               atol=OUT_ATOL)
    refs = tfa.flash_attention_backward_reference(q, k, v, ro, rl, do,
                                                  causal)
    tiled = tfa.flash_backward_tiled(q, k, v, ro, rl, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), tiled, refs):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_RTOL, name


def test_cuda_impl_refuses_cpu_tensors_at_d256():
    """impl='cuda' launches the kernel or raises: a CPU tensor at
    D = 256 raises before any build."""
    q = torch.zeros(2, 8, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_fwd_cuda(q, q, q, False, 0.1)
