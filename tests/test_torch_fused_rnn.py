"""The port's persistent-LSTM scans (bigdl_tpu_torch/ops/fused_rnn.py)
against the JAX package's Pallas kernels run in interpret mode
(bigdl_tpu/ops/fused_rnn.py, impl="interpret"), on the same numpy
inputs.

On the CPU the port takes its plain versions, which round where the
CUDA kernels round; the kernels themselves are held to those plain
versions on the card by chip_smoke.py.

Tolerances: fp32 forward rtol 1e-5 / atol 1e-6 (as
tests/test_fused_rnn.py holds the Pallas kernel to lax.scan) and fp32
gradients rtol 1e-4 / atol 1e-5 (its gradient tolerance: T steps of
fp32 sums in another order); bf16 2e-2 absolute on values of order 1
(a few bf16 ulps: the two frameworks sum the fp32 products in other
orders, which can move a stored bf16 value by one ulp). Shapes stay at
T <= 8 so the Pallas interpreter stays cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import fused_rnn as jrnn
from bigdl_tpu_torch.ops import fused_rnn as trnn

FP32 = dict(rtol=1e-5, atol=1e-6)
FP32_GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0, atol=2e-2)

# (N, T, H): a single tile, ragged N, T = 1, H = 16
SHAPES = [(4, 6, 8), (5, 7, 8), (3, 1, 8), (6, 5, 16)]


def _inputs(n, t, h, seed=0, ndir=1):
    rng = np.random.RandomState(seed)
    zxs = [rng.randn(n, t, 4 * h).astype(np.float32) for _ in range(ndir)]
    ws = [(0.3 * rng.randn(h, 4 * h)).astype(np.float32)
          for _ in range(ndir)]
    return zxs, ws


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(a).to(dtype).requires_grad_(grad)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _jax_scan(zxs, ws, ndir):
    if ndir == 1:
        return (jrnn.lstm_scan(zxs[0], ws[0], impl="interpret"),)
    return jrnn.bilstm_scan(*zxs, *ws, impl="interpret")


def _torch_scan(zxs, ws, ndir, impl=None):
    if ndir == 1:
        return (trnn.lstm_scan(zxs[0], ws[0], impl=impl),)
    return trnn.bilstm_scan(*zxs, *ws, impl=impl)


def _loss_weights(outs, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


@pytest.mark.parametrize("ndir", [1, 2], ids=["uni", "bi"])
@pytest.mark.parametrize("n,t,h", SHAPES)
def test_forward_fp32_matches_pallas_interpret(n, t, h, ndir):
    zxs, ws = _inputs(n, t, h, ndir=ndir)
    ref = _jax_scan([_j(z) for z in zxs], [_j(w) for w in ws], ndir)
    with torch.no_grad():
        got = _torch_scan([_t(z) for z in zxs], [_t(w) for w in ws], ndir)
    for a, b in zip(got, ref):
        assert a.shape == (n, t, h) and a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


@pytest.mark.parametrize("ndir", [1, 2], ids=["uni", "bi"])
@pytest.mark.parametrize("n,t,h", SHAPES)
def test_grads_fp32_match_pallas_interpret(n, t, h, ndir):
    zxs, ws = _inputs(n, t, h, seed=1, ndir=ndir)
    cot = _loss_weights([np.zeros((n, t, h))] * ndir)

    def jloss(*args):
        outs = _jax_scan(args[:ndir], args[ndir:], ndir)
        return sum(jnp.sum(jnp.sin(o) * c) for o, c in zip(outs, cot))

    jg = jax.grad(jloss, argnums=tuple(range(2 * ndir)))(
        *[_j(z) for z in zxs], *[_j(w) for w in ws])
    leaves = [_t(z, grad=True) for z in zxs] + [_t(w, grad=True)
                                                for w in ws]
    outs = _torch_scan(leaves[:ndir], leaves[ndir:], ndir)
    loss = sum((torch.sin(o) * torch.tensor(c)).sum()
               for o, c in zip(outs, cot))
    tg = torch.autograd.grad(loss, leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


@pytest.mark.parametrize("ndir", [1, 2], ids=["uni", "bi"])
@pytest.mark.parametrize("n,t,h", [(5, 7, 8), (3, 1, 16)])
def test_bf16_forward_and_grads_match_pallas_interpret(n, t, h, ndir):
    """Both packages round where the kernels round: carries fp32, h
    rounded to bf16 before h . W, residuals stored in bf16, dz rounded
    for both backward products."""
    zxs, ws = _inputs(n, t, h, seed=2, ndir=ndir)
    cot = _loss_weights([np.zeros((n, t, h))] * ndir, seed=3)

    def jloss(*args):
        outs = _jax_scan(args[:ndir], args[ndir:], ndir)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cot)), outs

    (_, jouts), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(2 * ndir)), has_aux=True)(
        *[_j(z, jnp.bfloat16) for z in zxs],
        *[_j(w, jnp.bfloat16) for w in ws])
    leaves = [_t(z, torch.bfloat16, True) for z in zxs] \
        + [_t(w, torch.bfloat16, True) for w in ws]
    outs = _torch_scan(leaves[:ndir], leaves[ndir:], ndir)
    loss = sum((o.float() * torch.tensor(c)).sum()
               for o, c in zip(outs, cot))
    tg = torch.autograd.grad(loss, leaves)
    for a, b in zip(outs, jouts):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), **BF16)
    for a, b in zip(tg, jg):
        assert a.dtype == torch.bfloat16
        scale = max(1.0, float(np.abs(_np(b)).max()))
        np.testing.assert_allclose(_np(a) / scale, _np(b) / scale, **BF16)


@pytest.mark.parametrize("n,t,h", [(4, 6, 8), (5, 3, 16)])
def test_fp32_matches_lax_scan_oracle(n, t, h):
    """Also in fp32, against `_lstm_scan_xla`, the JAX package's plain
    lax.scan (forward and both gradients)."""
    (zx,), (w,) = _inputs(n, t, h, seed=4)
    ref = jrnn._lstm_scan_xla(_j(zx), _j(w))
    jg = jax.grad(lambda a, b: jnp.sum(jnp.tanh(jrnn._lstm_scan_xla(a, b))),
                  argnums=(0, 1))(_j(zx), _j(w))
    tz, tw = _t(zx, grad=True), _t(w, grad=True)
    out = trnn.lstm_scan(tz, tw)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    tg = torch.autograd.grad(torch.tanh(out).sum(), (tz, tw))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


def test_reverse_direction_is_the_flipped_scan():
    """bilstm_scan's second output is the forward scan of the
    time-flipped feed, flipped back: true time order, no flip inside."""
    (zf, zb), (wf, wb) = _inputs(3, 6, 8, seed=5, ndir=2)
    with torch.no_grad():
        ys_f, ys_b = trnn.bilstm_scan(_t(zf), _t(zb), _t(wf), _t(wb))
        flip = trnn.lstm_scan(torch.flip(_t(zb), (1,)), _t(wb))
    assert torch.equal(ys_f, trnn.lstm_scan(_t(zf), _t(wf)).detach())
    assert torch.equal(ys_b, torch.flip(flip, (1,)))


def test_inference_and_training_variants_agree():
    """The no-residual (inference) variant runs when nothing needs a
    gradient and returns the training variant's ys."""
    (zx,), (w,) = _inputs(4, 5, 8, seed=6)
    with torch.no_grad():
        infer = trnn.lstm_scan(_t(zx), _t(w))
    train = trnn.lstm_scan(_t(zx, grad=True), _t(w))
    assert infer.grad_fn is None and train.grad_fn is not None
    assert torch.equal(infer, train.detach())


def test_unrounded_control_differs_only_in_bf16():
    """The control without the kernels' roundings is the same function
    in fp32 and a different one in bf16."""
    (zx,), (w,) = _inputs(6, 8, 16, seed=7)
    z32, w32 = _t(zx), _t(w)
    a = trnn.lstm_forward_reference(z32, w32)
    b = trnn.lstm_forward_reference(z32, w32, round_operands=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    zb, wb = z32.bfloat16(), w32.bfloat16()
    rounded = trnn.lstm_forward_reference(zb, wb)[0]
    control = trnn.lstm_forward_reference(zb, wb, round_operands=False)[0]
    assert control.dtype == torch.float32
    assert (rounded != control.bfloat16()).float().mean() > 0.02


def test_gru_plain_matches_lax_scan_oracle():
    rng = np.random.RandomState(8)
    n, t, h = 4, 6, 8
    zg, zc = rng.randn(n, t, 2 * h), rng.randn(n, t, h)
    wg, wc = 0.3 * rng.randn(h, 2 * h), 0.3 * rng.randn(h, h)
    args = [a.astype(np.float32) for a in (zg, zc, wg, wc)]
    ref = jrnn._gru_scan_xla(*map(_j, args))
    jg = jax.grad(lambda *a: jnp.sum(jnp.sin(jrnn._gru_scan_xla(*a))),
                  argnums=(0, 1, 2, 3))(*map(_j, args))
    leaves = [_t(a, grad=True) for a in args]
    out = trnn.gru_scan(*leaves)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    tg = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **FP32_GRAD)


def test_impl_switch():
    (zx,), (w,) = _inputs(2, 3, 8)
    z, wt = _t(zx), _t(w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trnn.lstm_scan(z, wt, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trnn.bilstm_scan(z, z, wt, wt, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        trnn.lstm_scan(z, wt, impl="pallas")
    torch_out = trnn.lstm_scan(z, wt, impl="torch")
    assert torch.equal(trnn.lstm_scan(z, wt), torch_out)
    zg, zc = torch.zeros(2, 3, 16), torch.zeros(2, 3, 8)
    wg, wc = torch.zeros(8, 16), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trnn.gru_scan(zg, zc, wg, wc, impl="cuda")
    assert trnn.gru_scan(zg, zc, wg, wc).shape == (2, 3, 8)


def test_cpu_routes_launch_no_kernel():
    before = (trnn.fwd_train_launches, trnn.fwd_infer_launches,
              trnn.bwd_launches)
    (zx,), (w,) = _inputs(2, 3, 8)
    z = _t(zx, grad=True)
    trnn.lstm_scan(z, _t(w)).sum().backward()
    assert (trnn.fwd_train_launches, trnn.fwd_infer_launches,
            trnn.bwd_launches) == before


def test_block_n_is_fixed():
    """The kernels' batch tile is a constant: block_n takes None or it."""
    (zx,), (w,) = _inputs(2, 3, 8)
    z, wt = _t(zx), _t(w)
    assert torch.equal(trnn.lstm_scan(z, wt, block_n=trnn.BLOCK_N),
                       trnn.lstm_scan(z, wt))
    with pytest.raises(ValueError, match="fixed"):
        trnn.lstm_scan(z, wt, block_n=2 * trnn.BLOCK_N)
    with pytest.raises(ValueError, match="fixed"):
        trnn.bilstm_scan(z, z, wt, wt, block_n=2 * trnn.BLOCK_N)


def _pallas_tile_dw(ws, res, dys, ndir, block_n):
    """The Pallas backward kernels' per-tile dW (interpret mode), from the
    given residuals in the port's (N, T, .) layout: one (tiles, H, 4H)
    array a direction."""
    def tm(x):          # (N, T, .) torch -> (T, N, .) jax, dtype kept
        dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
        return jnp.swapaxes(_j(x.float().numpy(), dt), 0, 1)

    jw = [_j(w.float().numpy(), jnp.bfloat16 if w.dtype == torch.bfloat16
             else jnp.float32) for w in ws]
    jres = [tuple(tm(x) for x in r) for r in res]
    jdy = [tm(dy) for dy in dys]
    if ndir == 1:
        fn = jax.jit(lambda *a: jrnn._lstm_bwd_pallas(*a, block_n, True))
        return [fn(jw[0], *jres[0], jdy[0])[1]]
    fn = jax.jit(lambda *a: jrnn._bilstm_bwd_pallas(*a, block_n, True))
    out = fn(*jw, *jres, *jdy)
    return [out[2], out[3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ndir", [1, 2], ids=["uni", "bi"])
def test_backward_returns_one_summed_dw(ndir, dtype):
    """The backward's contract: one fp32 (H, 4H) dW a direction, summed
    over the batch — the Pallas kernels' per-tile dW summed over its
    tiles — and the gradient autograd hands W is that dW in W's dtype."""
    n, t, h = 8, 5, 8
    zxs, ws = _inputs(n, t, h, seed=9, ndir=ndir)
    zxs = [_t(z, dtype) for z in zxs]
    ws = [_t(w, dtype) for w in ws]
    revs = [d == 1 for d in range(ndir)]
    rng = np.random.RandomState(10)
    dys = [_t(rng.randn(n, t, h).astype(np.float32), dtype)
           for _ in range(ndir)]
    res = trnn._forward_plain(zxs, ws, revs)
    _, dws = trnn._backward_plain(ws, res, dys, revs)
    tiles = _pallas_tile_dw(ws, res, dys, ndir, trnn.BLOCK_N)
    for dw, tile in zip(dws, tiles):
        assert dw.shape == (h, 4 * h) and dw.dtype == torch.float32
        assert tile.shape == (n // trnn.BLOCK_N, h, 4 * h)
        ref = _np(jnp.sum(tile, axis=0))
        tol = FP32_GRAD if dtype == torch.float32 else BF16
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(_np(dw) / scale, ref / scale, **tol)
    leaves = [z.clone().requires_grad_() for z in zxs] + [
        w.clone().requires_grad_() for w in ws]
    outs = _torch_scan(leaves[:ndir], leaves[ndir:], ndir)
    grads = torch.autograd.grad(outs, leaves[ndir:], dys)
    for g, dw, w in zip(grads, dws, ws):
        assert g.dtype == w.dtype and torch.equal(g, dw.to(w.dtype))


@pytest.mark.parametrize("max_splits", [8, 16])
@pytest.mark.parametrize("pairs", [1, 63, 64, 511, 512, 513, 2048, 4096,
                                   16383, 16384, 100000])
def test_dw_split_plan_covers_each_pair_once(pairs, max_splits):
    """Rank r of the dW GEMM's cluster sums pairs [r span, (r + 1) span):
    every (t, row) pair once, no rank empty, spans whole dW stages."""
    splits, span = trnn.dw_split_plan(pairs, max_splits)
    assert 1 <= splits <= max_splits and span % trnn.DW_PAIRS == 0
    ranges = [range(r * span, min((r + 1) * span, pairs))
              for r in range(splits)]
    assert all(len(rg) > 0 for rg in ranges)
    assert [m for rg in ranges for m in rg] == list(range(pairs))
    if pairs >= max_splits * trnn.DW_PAIRS:
        assert splits > max_splits // 2
    else:
        assert span == trnn.DW_PAIRS


def test_dw_split_plan_depends_on_the_shape_alone():
    """The split, and so the order of dW's sums, follows from the pair
    count (N * T) and the card's cluster limit, nothing else."""
    import inspect

    assert list(inspect.signature(trnn.dw_split_plan).parameters) == [
        "pairs", "max_splits"]
    assert trnn.dw_split_plan(128 * 128, 16) == (16, 1024)   # train_bi
    assert trnn.dw_split_plan(32 * 64, 16) == (16, 128)      # lm_uni
    assert trnn.dw_split_plan(128 * 128, 8) == (8, 2048)
    assert trnn.dw_split_plan(20, 16) == (1, 64)


def test_kernel_study_sources_apply_to_the_shipped_kernels():
    """The measuring tool's copies of csrc/fused_rnn.cu (the unkept
    layouts from ops/study/, the clock64 phases) are built from the
    shipped source by anchors each found once: they still apply, and each
    unkept forward layout changes only the kernel it names."""
    from pathlib import Path

    from bigdl_tpu_torch.ops import kernel_study as ks

    src = (Path(trnn.__file__).parent / "csrc" / "fused_rnn.cu").read_text()
    assert set(ks._layout_sources(src)) == {
        "two_parts", "shared_4", "shared_8", "shared_16", "residuals_first"}
    clocks = ks._clock_source(src)
    for sym, *_ in ks._PHASES.values():
        assert f"__device__ long long {sym}[128];" in clocks
    layouts = ks._fwd_layout_sources(src)
    assert set(layouts) == set(ks._FWD_LAYOUTS)
    one = layouts["one_cta"]
    diff = [(a, b) for a, b in zip(src.splitlines(), one.splitlines())
            if a != b]
    assert diff == [("constexpr int kFwdCluster = 4;",
                     "constexpr int kFwdCluster = 1;")]
    # each changes its own kernel's part of the source: the bf16 forward
    # section, or the fp32 forward's from its cluster constant on
    bf16 = src.index("-- LSTM forward")
    fp32 = src.index("constexpr int kFwdCluster")
    end = src.index("-- LSTM backward")
    for name, dtype in ks._FWD_LAYOUTS.items():
        text = layouts[name]
        first = next(i for i, (a, b) in enumerate(zip(src, text)) if a != b)
        last = len(src) - next(i for i, (a, b) in enumerate(
            zip(src[::-1], text[::-1])) if a != b)
        lo, hi = (fp32, end) if dtype == "fp32" else (bf16, fp32)
        assert lo <= first and last <= hi, name
