"""The port's GRU path against the JAX package's, on the same numpy
inputs and weights (models/convert.params_from_jax): the persistent GRU
scan (bigdl_tpu_torch/ops/fused_rnn.gru_scan against bigdl_tpu's
`gru_scan(impl="interpret")`, its Pallas kernels in interpret mode),
the rounding-aware plain backward against autograd, Recurrent(GRU) and
BiRecurrent(GRU), and the reduce layers (nn/table_ops.py) that pool the
BiGRU classifier (held to JAX in tests/test_torch_validation.py).

On the CPU the port takes its plain versions, which round where the
CUDA kernels round; the kernels themselves are held to those plain
versions on the card by chip_smoke.py.

Tolerances: fp32 forward rtol 1e-5 / atol 1e-6 and fp32 gradients rtol
1e-5 / atol 1e-5 (T steps of fp32 sums in other orders; the gradients
read <= 4.2e-7 absolute on values of order 1); bf16 2e-2 absolute
on values of order 1 (both packages round where the kernels round and
differ in fp32 summation order, which can move a stored bf16 value by
an ulp), gradients relative to their largest entry. Shapes stay at
N <= 6, T <= 9, H <= 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops import fused_rnn as jrnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves
from bigdl_tpu_torch.ops import fused_rnn as trnn

FP32 = dict(rtol=1e-5, atol=1e-6)
FP32_GRAD = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0, atol=2e-2)

# (N, T, H): one batch tile, ragged N, T = 1, H = 16 with the longest T
SHAPES = [(4, 6, 8), (5, 7, 8), (3, 1, 8), (6, 9, 16)]

HIDDEN, N, T = 8, 4, 6


def _inputs(n, t, h, seed=0):
    """zg, zc, W_g, W_c in fp32 numpy."""
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(n, t, 2 * h), rng.randn(n, t, h),
        0.3 * rng.randn(h, 2 * h), 0.3 * rng.randn(h, h))]


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(a).to(dtype).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,t,h", SHAPES)
def test_forward_and_grads_fp32_match_pallas_interpret(n, t, h):
    args = _inputs(n, t, h, seed=1)
    cot = np.random.RandomState(7).randn(n, t, h).astype(np.float32)
    (_, ref), jg = jax.jit(jax.value_and_grad(
        lambda *a: (lambda o: (jnp.sum(jnp.sin(o) * cot), o))(
            jrnn.gru_scan(*a, impl="interpret")),
        argnums=(0, 1, 2, 3), has_aux=True))(*map(_j, args))
    with torch.no_grad():
        got = trnn.gru_scan(*map(_t, args))
    assert got.shape == (n, t, h) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)
    leaves = [_t(a, grad=True) for a in args]
    out = trnn.gru_scan(*leaves)
    tg = torch.autograd.grad((torch.sin(out) * torch.tensor(cot)).sum(),
                             leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


@pytest.mark.parametrize("n,t,h", [(4, 6, 8), (5, 3, 16)])
def test_impl_torch_grads_match_pallas_interpret(n, t, h):
    """gru_scan(impl="torch") through _GRUScan, whose backward returns dW
    summed over the batch (as the CUDA backward now does), against JAX's
    gru_scan in interpret mode: the gradients of all four inputs in their
    shapes and dtype, fp32."""
    args = _inputs(n, t, h, seed=11)
    cot = np.random.RandomState(12).randn(n, t, h).astype(np.float32)
    jg = jax.jit(jax.grad(
        lambda *a: jnp.sum(jrnn.gru_scan(*a, impl="interpret") * cot),
        argnums=(0, 1, 2, 3)))(*map(_j, args))
    leaves = [_t(a, grad=True) for a in args]
    out = trnn.gru_scan(*leaves, impl="torch")
    tg = torch.autograd.grad((out * torch.tensor(cot)).sum(), leaves)
    for a, b, leaf in zip(tg, jg, leaves):
        assert a.shape == leaf.shape and a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


@pytest.mark.parametrize("n,t,h", [(5, 7, 8), (3, 1, 16)])
def test_bf16_forward_and_grads_match_pallas_interpret(n, t, h):
    """Both packages round where the kernels round: the h carry fp32, h
    and r * h rounded to bf16 before their products, residuals stored in
    bf16, dcand_pre and dzr rounded for the backward products."""
    args = _inputs(n, t, h, seed=2)
    cot = np.random.RandomState(3).randn(n, t, h).astype(np.float32)

    def jloss(*a):
        out = jrnn.gru_scan(*a, impl="interpret")
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *[_j(a, jnp.bfloat16) for a in args])
    leaves = [_t(a, torch.bfloat16, True) for a in args]
    out = trnn.gru_scan(*leaves)
    tg = torch.autograd.grad((out.float() * torch.tensor(cot)).sum(),
                             leaves)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), **BF16)
    for a, b in zip(tg, jg):
        assert a.dtype == torch.bfloat16
        scale = max(1.0, float(np.abs(_np(b)).max()))
        np.testing.assert_allclose(_np(a) / scale, _np(b) / scale, **BF16)


@pytest.mark.parametrize("n,t,h", [(4, 6, 8), (3, 1, 8), (6, 5, 16)])
def test_plain_backward_matches_autograd(n, t, h):
    """In fp32 the rounding-aware plain backward (what the CUDA backward
    kernel is held to) equals autograd through the plain forward: dzg,
    dzc, dW_g and dW_c of sum(ys * w)."""
    zg, zc, wg, wc = [_t(a, grad=True) for a in _inputs(n, t, h, seed=4)]
    w = torch.tensor(np.random.RandomState(5).randn(n, t, h)
                     .astype(np.float32))
    ys, zr, cand = trnn.gru_forward_reference(zg, zc, wg, wc)
    auto = torch.autograd.grad((ys * w).sum(), (zg, zc, wg, wc))
    plain = trnn.gru_backward_reference(wg.detach(), wc.detach(),
                                        ys.detach(), zr.detach(),
                                        cand.detach(), w)
    for a, b in zip(plain, auto):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


def test_plain_matches_lax_scan_oracle_in_bf16_control():
    """The unrounded control is the same function as `_gru_scan_xla` in
    fp32, and differs from the rounded plain version in bf16."""
    args = _inputs(6, 8, 16, seed=6)
    ref = jrnn._gru_scan_xla(*map(_j, args))
    ctl = trnn.gru_forward_reference(*map(_t, args), round_operands=False)
    np.testing.assert_allclose(_np(ctl[0]), _np(ref), **FP32)
    bf = [_t(a, torch.bfloat16) for a in args]
    rounded = trnn.gru_forward_reference(*bf)[0]
    control = trnn.gru_forward_reference(*bf, round_operands=False)[0]
    assert control.dtype == torch.float32
    assert (rounded != control.bfloat16()).float().mean() > 0.02


def test_inference_and_training_variants_agree():
    """The no-residual (inference) variant runs when nothing needs a
    gradient and returns the training variant's ys."""
    args = _inputs(4, 5, 8, seed=8)
    with torch.no_grad():
        infer = trnn.gru_scan(*map(_t, args))
    train = trnn.gru_scan(_t(args[0], grad=True), *map(_t, args[1:]))
    assert infer.grad_fn is None and train.grad_fn is not None
    assert torch.equal(infer, train.detach())


def test_impl_switch_and_block_n():
    args = [_t(a) for a in _inputs(2, 3, 8)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        trnn.gru_scan(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        trnn.gru_scan(*args, impl="pallas")
    with pytest.raises(ValueError, match="fixed"):
        trnn.gru_scan(*args, block_n=2 * trnn.BLOCK_N)
    assert torch.equal(trnn.gru_scan(*args, block_n=trnn.BLOCK_N),
                       trnn.gru_scan(*args, impl="torch"))


def test_cpu_route_launches_no_kernel():
    names = ("gru_fwd_train_launches", "gru_fwd_infer_launches",
             "gru_bwd_launches")
    before = [getattr(trnn, c) for c in names]
    zg, zc, wg, wc = _inputs(2, 3, 8)
    trnn.gru_scan(_t(zg, grad=True), _t(zc), _t(wg), _t(wc)).sum() \
        .backward()
    with torch.no_grad():
        trnn.gru_scan(_t(zg), _t(zc), _t(wg), _t(wc))
    assert [getattr(trnn, c) for c in names] == before


# ------------------------------------------------------------ layers
D = 5


def _layer_pair(kind):
    if kind == "recurrent":
        return (jnn.Recurrent(jnn.GRU(D, HIDDEN), fused="interpret"),
                tnn.Recurrent(tnn.GRU(D, HIDDEN)))
    return (jnn.BiRecurrent(jnn.GRU(D, HIDDEN), fused="interpret"),
            tnn.BiRecurrent(tnn.GRU(D, HIDDEN)))


@pytest.mark.parametrize("kind", ["recurrent", "birecurrent"])
def test_gru_layers_match_jax_interpret(kind):
    """Recurrent(GRU) / BiRecurrent(GRU) with fused=None (the plain scan
    on the CPU) against the JAX layers through the Pallas kernels in
    interpret mode: outputs and parameter gradients."""
    jm, tm = _layer_pair(kind)
    variables = jm.init(jax.random.PRNGKey(3))
    x = np.random.RandomState(0).randn(N, T, D).astype(np.float32)
    w = np.random.RandomState(9).randn(N, T, HIDDEN * (
        2 if kind == "birecurrent" else 1)).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p, "state": variables["state"]},
                       jnp.asarray(x))[0]
        return jnp.sum(jnp.sin(out) * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    jg = jax.tree_util.tree_leaves(jg)
    tparams = params_from_jax(jax.device_get(variables["params"]),
                              device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    tout, _ = tm.apply({"params": tparams, "state": tm.init_state()},
                       torch.tensor(x))
    tg = torch.autograd.grad((torch.sin(tout) * torch.tensor(w)).sum(),
                             leaves)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **FP32)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), **FP32_GRAD)


REDUCE_CASES = [  # (dimension, n_input_dims, squeeze)
    (1, -1, True), (2, -1, True), (-1, -1, True), (-2, -1, False),
    (1, 2, True), (2, 2, False)]


@pytest.mark.parametrize("op", ["Sum", "Mean", "Max", "Min"])
@pytest.mark.parametrize("dim,n_input_dims,squeeze", REDUCE_CASES)
def test_reduce_layers_match_jax(op, dim, n_input_dims, squeeze):
    """nn/table_ops.py's reduce family against the JAX layers, values and
    input gradients, 1-based and negative dimensions, the batch shift of
    n_input_dims and keepdim."""
    x = np.random.RandomState(1).randn(3, 4, 5).astype(np.float32)
    jm = getattr(jnn, op)(dim, n_input_dims, squeeze)
    tm = getattr(tnn, op)(dim, n_input_dims, squeeze)
    jout = jm.apply({"params": {}, "state": {}}, jnp.asarray(x))[0]
    w = np.random.RandomState(2).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(
        jm.apply({"params": {}, "state": {}}, a)[0] * w))(jnp.asarray(x))
    tx = _t(x, grad=True)
    tout, _ = tm.apply({"params": {}, "state": {}}, tx)
    tg, = torch.autograd.grad((tout * torch.tensor(w)).sum(), tx)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **FP32)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **FP32)
