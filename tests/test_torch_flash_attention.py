"""The port's flash attention (bigdl_tpu_torch/ops/flash_attention.py),
plain path, against the JAX package's flash attention run as its own
tests run it on the CPU: the Pallas kernels in interpret mode.

Tolerances (fp32): forward out and LSE within 1e-5 absolute; dq/dk/dv
within 1e-4 relative to each tensor's max — two frameworks' fp32
matmuls and exps summing in different orders. Fully masked rows
(causal with Sq > Sk, bottom-right aligned) are exact zeros with LSE
-1e30 in both packages. The CUDA kernels cannot run here (no nvcc, no
card): chip_smoke.py holds them to this plain path on the H100."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
tfa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-4
NEG = np.float32(-1e30)

# (BH, Sq, Sk, D, causal): square, Sq < Sk, Sq > Sk (fully masked
# rows), non-causal, and lengths off every tile multiple
CASES = [(2, 64, 64, 16, True), (2, 40, 72, 16, True),
         (2, 72, 40, 16, True), (3, 50, 50, 8, False),
         (2, 37, 53, 32, False)]
IDS = ["square", "sq_lt_sk", "masked_rows", "noncausal", "ragged"]


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
    assert ((np.asarray(jl) == NEG).sum(axis=1) == masked).all()
    if masked:
        assert (to.numpy()[:, :masked] == 0).all()
        assert (np.asarray(jo)[:, :masked] == 0).all()


@pytest.mark.parametrize("form", ["fused", "split"])
@pytest.mark.parametrize("case", [(2, 64, 64, 16, True),
                                  (2, 64, 64, 16, False),
                                  (2, 48, 32, 16, True),
                                  (2, 40, 56, 16, True)],
                         ids=["causal", "noncausal", "masked_rows",
                              "sq_lt_sk"])
def test_plain_backward_matches_pallas_backward(case, form):
    """The plain blockwise backward against both Pallas backward forms
    (K3 fused, K4/K5 split), fed the same (o, lse) and do."""
    bh, sq, sk, d, causal = case
    q, k, v, do = _inputs(bh, sq, sk, d, seed=1)
    scale = 0.25
    kern = (jfa._flash_bwd_pallas_fused if form == "fused"
            else jfa._flash_bwd_pallas_split)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, lse = jfa._flash_fwd_pallas(q, k, v, causal, scale, 16, 16,
                                       interpret=True)
        return o, lse, kern(q, k, v, o, lse, do, causal, scale, 16, 16,
                            interpret=True)

    o, lse, jg = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    tg = tfa.flash_attention_backward_reference(
        *_t(q, k, v, np.asarray(o), np.asarray(lse), do), causal=causal,
        sm_scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert _rel(a.numpy(), b) <= GRAD_RTOL, name


@pytest.mark.parametrize("layout", ["bhsd", "bsd"])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_through_autograd_match_jax_grad(layout, causal):
    """torch.autograd through flash_attention (impl="torch" on CPU
    tensors) against jax.grad through the Pallas kernels in interpret
    mode (custom VJP, Mosaic backward)."""
    shape = (2, 3, 48, 16) if layout == "bhsd" else (4, 48, 16)
    rng = np.random.RandomState(2)
    q, k, v, w = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    jg = jax.jit(jax.grad(lambda q, k, v: (jfa.flash_attention(
        q, k, v, causal=causal, impl="interpret") * w).sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.shape == shape
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        assert _rel(a.grad.numpy(), b) <= GRAD_RTOL, name


def test_zero_scale_backward_matches_jax():
    """sm_scale == 0: uniform probabilities, ds exactly zero — the
    Pallas backward's degenerate branch."""
    q, k, v, do = _inputs(2, 32, 32, 16, seed=3)
    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, lse = jfa._flash_fwd_pallas(q, k, v, True, 0.0, 16, 16,
                                       interpret=True)
        return o, jfa._flash_bwd_pallas_fused(q, k, v, o, lse, do, True,
                                              0.0, 16, 16, interpret=True)

    o, jg = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    to, tl = tfa.attention_reference(*_t(q, k, v), causal=True,
                                     sm_scale=0.0, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=OUT_ATOL)
    tg = tfa.flash_attention_backward_reference(
        *_t(q, k, v), to, tl, torch.from_numpy(do), causal=True,
        sm_scale=0.0)
    assert not tg[0].any() and not tg[1].any()
    assert _rel(tg[2].numpy(), jg[2]) <= GRAD_RTOL


def test_with_lse_default_is_differentiable_plain():
    q, k, v, _ = _inputs(2, 16, 16, 8)
    tq = torch.from_numpy(q).requires_grad_()
    before = (tfa.fwd_launches, tfa.bwd_launches)
    out, lse = tfa.flash_attention_with_lse(tq, *_t(k, v), causal=True)
    (out.sum() + lse.sum()).backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()
    assert (tfa.fwd_launches, tfa.bwd_launches) == before


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_with_lse_grads_match_jax(case):
    """Gradients through BOTH outputs of flash_attention_with_lse (the
    LSE's enters the backward as delta - dlse) against jax.grad through
    the JAX package's differentiable default. Fully masked rows carry
    LSE -1e30, so their LSE is left out of the loss."""
    bh, sq, sk, d, causal = case
    q, k, v, w = _inputs(bh, sq, sk, d, seed=4)
    wl = np.random.RandomState(5).randn(bh, sq).astype(np.float32)
    masked = max(sq - sk, 0) if causal else 0
    wl[:, :masked] = 0.0

    def loss_j(q, k, v):
        o, l = jfa.flash_attention_with_lse(q, k, v, causal=causal)
        return (o * w).sum() + (jnp.where(l > NEG / 2, l, 0.0) * wl).sum()

    jg = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o, l = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    ((o * torch.from_numpy(w)).sum() + (torch.where(l > NEG / 2, l, 0.0)
                                        * torch.from_numpy(wl)).sum()
     ).backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        assert _rel(a.grad.numpy(), b) <= GRAD_RTOL, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_versions_are_the_plain_versions_in_fp32(case):
    """flash_forward_tiled / flash_backward_tiled (the kernels'
    arithmetic tile by tile) against the plain versions: in fp32 the
    roundings are identities, so only the summation order differs."""
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


def test_tiled_versions_round_where_the_kernels_round():
    """In bf16 the tiled versions round p (and do, ds) to bf16 at the
    kernels' dots: rounded they stay within a few bf16 ulps of the fp32
    control, yet differ from it — the difference the on-card check
    resolves."""
    q, k, v, do = (t.bfloat16() for t in _t(*_inputs(2, 72, 72, 32,
                                                     seed=7)))
    scale = 1.0 / np.sqrt(32.0)       # not a power of 2: do * scale rounds
    o, lse = tfa.flash_forward_tiled(q, k, v, True, scale)
    c, clse = tfa.flash_forward_tiled(q, k, v, True, scale,
                                      round_operands=False)
    assert torch.equal(lse, clse)     # the sum uses the unrounded p
    assert 0 < float((o - c).abs().max()) <= 4 * 2.0 ** -8 * float(
        c.abs().max())
    ob = o.bfloat16()
    g = tfa.flash_backward_tiled(q, k, v, ob, lse, do, True, scale)
    gc = tfa.flash_backward_tiled(q, k, v, ob, lse, do, True, scale,
                                  round_operands=False)
    for name, a, b in zip(("dq", "dk", "dv"), g, gc):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert 0 < err <= 4 * 2.0 ** -8, name


def test_lse_gradient_folds_into_delta():
    """The plain backward's `dlse` against autograd through the plain
    forward of a loss on both outputs."""
    q, k, v, do = _t(*_inputs(2, 40, 56, 16, seed=8))
    dlse = torch.from_numpy(
        np.random.RandomState(9).randn(2, 40).astype(np.float32))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o, l = tfa.attention_reference(tq, tk, tv, True, return_lse=True)
    ((o * do).sum() + (l * dlse).sum()).backward()
    got = tfa.flash_attention_backward_reference(
        q, k, v, o.detach(), l.detach(), do, True, dlse=dlse)
    for name, a, b in zip(("dq", "dk", "dv"), got, (tq, tk, tv)):
        assert _rel(a.numpy(), b.grad.numpy()) <= GRAD_RTOL, name


def test_bf16_plain_path_keeps_dtype():
    q, k, v, _ = _inputs(2, 24, 24, 8)
    tq, tk, tv = (t.bfloat16().requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert tq.grad.dtype == tk.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("call", ["flash_attention", "with_lse",
                                  "fwd_kernel", "bwd_kernel"])
def test_cuda_impl_refuses_cpu_tensors(call):
    """impl='cuda' launches the kernel or raises: on CPU tensors it
    raises before any build, never falls back to the plain version."""
    q, k, v, do = _t(*_inputs(1, 8, 8, 32))
    before = (tfa.fwd_launches, tfa.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if call == "flash_attention":
            tfa.flash_attention(q, k, v, impl="cuda")
        elif call == "with_lse":
            tfa.flash_attention_with_lse(q, k, v, impl="cuda")
        elif call == "fwd_kernel":
            tfa.flash_fwd_cuda(q, k, v, True, 0.125)
        else:
            tfa.flash_bwd_cuda(q, k, v, q, q[..., 0], do, True, 0.125)
    assert (tfa.fwd_launches, tfa.bwd_launches) == before


def test_unknown_impl_raises():
    q, k, v, _ = _t(*_inputs(1, 8, 8, 8))
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention(q, k, v, impl="pallas")


# ------------------------------------------------ bf16, the working dtype
# The bf16 kernels on the card are held to flash_forward_tiled /
# flash_backward_tiled (chip_smoke.py's flash phase). Here those oracles,
# rounded once to bf16, are held to the JAX package's bf16 Pallas kernels
# in interpret mode at the card's tile width (64 keys; 64 query rows),
# with chip_smoke's own measure: per tensor at most BF16_MISMATCH_TOL of
# the elements differ and every one lies within BF16_ULP_TOL bf16 ulps.
# The two sides sum in different orders, which moves an odd rounding of
# p or ds by one ulp; a different kv tile width moves p's running max,
# and so ~10% of the outputs (the control).
BF16_CASES = [(2, 200, 200, 64, True), (2, 160, 96, 64, True),
              (2, 77, 131, 64, False)]
BF16_IDS = ["causal", "masked_rows", "ragged_noncausal"]


def _bf16_inputs(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, d),
                          (bh, sq, d))]


@functools.lru_cache(maxsize=None)
def _jax_bf16(case):
    """JAX's bf16 (out, lse) and the gradients of sum(out * do), through
    the Pallas kernels in interpret mode at 64 x 64 tiles, as numpy."""
    bh, sq, sk, d, causal = case
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16)
                   for a in _bf16_inputs(bh, sq, sk, d, seed=10))
    blocks = dict(causal=causal, block_q=64, block_k=64, impl="interpret")

    @jax.jit   # one compilation for the forward and the gradients
    def run(q, k, v, do):
        o, lse = jfa.flash_attention_with_lse(q, k, v, **blocks)
        grads = jax.grad(lambda q, k, v: (jfa.flash_attention(
            q, k, v, bwd_block_k=64, **blocks).astype(jnp.float32)
            * do.astype(jnp.float32)).sum(), argnums=(0, 1, 2))(q, k, v)
        return o, lse, *grads

    return tuple(np.asarray(t.astype(jnp.float32))
                 for t in run(q, k, v, do))


def _port_bf16(case):
    """The port's oracles on the same bf16 inputs: fp32 (out, lse) and
    fp32 (dq, dk, dv) from the forward's out rounded to bf16."""
    bh, sq, sk, d, causal = case
    q, k, v, do = (t.bfloat16() for t in _t(*_bf16_inputs(bh, sq, sk, d,
                                                          seed=10)))
    o, lse = tfa.flash_forward_tiled(q, k, v, causal)
    grads = tfa.flash_backward_tiled(q, k, v, o.bfloat16(), lse, do, causal)
    return o, lse, grads


@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_bf16_oracles_match_jax_pallas(case):
    jo, jl, *jg = _jax_bf16(case)
    o, lse, grads = _port_bf16(case)
    np.testing.assert_allclose(lse.numpy(), jl, rtol=0, atol=OUT_ATOL)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (jo, *jg),
                              (o, *grads)):
        st = chip_smoke._ulp_stats(torch.tensor(got).bfloat16(), ref)
        assert st["mismatch"] <= chip_smoke.BF16_MISMATCH_TOL, (name, st)
        assert st["max_ulps"] <= chip_smoke.BF16_ULP_TOL, (name, st)


def test_bf16_oracle_sees_the_kv_tile_width(monkeypatch):
    """The control: the same forward over 128-key tiles fails the limit
    that the 64-key oracle passes."""
    case = BF16_CASES[0]
    jo = _jax_bf16(case)[0]
    monkeypatch.setattr(tfa, "KERNEL_BLOCK_K", 128)
    o, _, _ = _port_bf16(case)
    st = chip_smoke._ulp_stats(torch.tensor(jo).bfloat16(), o)
    assert st["mismatch"] > chip_smoke.BF16_MISMATCH_TOL, st
