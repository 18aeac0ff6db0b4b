"""The port's MultiHeadAttention (bigdl_tpu_torch/nn/attention.py), the
dense KV cache (ops/kv_cache.py), the flash wrapper's head-dim padding
and the reference's attention dropout (ops/flash_attention.py), against
the JAX package on the same seeded inputs and weights.

Tolerances (fp32): MHA outputs and every gradient (the eight params and
the inputs) within 1e-5 of each tensor's largest entry — the key
bias's gradient, zero in exact arithmetic (softmax is shift-invariant),
is rounding noise in both packages and is held below 1e-5 of the
largest gradient in each — against the JAX
layer on its default CPU path (`impl=None` runs its reference); the
port's incremental decode against its own full forward within 1e-5
absolute (as tests/test_serving.py holds the JAX layer); the dense
cache functions within 1e-6 absolute of JAX's, with a NaN value row
past a clock leaving the read finite; the padded head dim bit for bit
against the unpadded plain version; attention dropout at p = 0 bit for
bit the undropped attention, at p > 0 a kept share within 3 sigma of
1 - p.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops import kv_cache as jkv
from bigdl_tpu.ops.flash_attention import \
    attention_reference as j_attention_reference
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves
from bigdl_tpu_torch.ops import flash_attention as tfa
from bigdl_tpu_torch.ops import kv_cache as tkv

TOL = 1e-5

# (name, E, heads, Sq, Sk or None for self-attention, causal, with_bias)
MHA_CASES = [("self", 16, 2, 12, None, False, True),
             ("causal", 16, 2, 12, None, True, True),
             ("cross", 16, 4, 10, 7, False, True),
             ("cross_causal_nobias", 24, 2, 6, 9, True, False)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _params(module, seed):
    """The JAX layer's param tree, every leaf N(0, 0.5^2) from `seed`
    (biases nonzero, so their gradients are exercised)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.5).astype(np.float32), shapes)


def _mha_pair(e, heads, causal, with_bias, seed=0, **kw):
    jm = jnn.MultiHeadAttention(e, heads, causal=causal,
                                with_bias=with_bias, **kw)
    tm = tnn.MultiHeadAttention(e, heads, causal=causal,
                                with_bias=with_bias, **kw)
    jp = _params(jm, seed)
    return jm, tm, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("case", MHA_CASES, ids=[c[0] for c in MHA_CASES])
def test_mha_forward_and_grads_match_jax(case):
    _, e, heads, sq, sk, causal, with_bias = case
    jm, tm, jp, tp = _mha_pair(e, heads, causal, with_bias)
    rng = np.random.RandomState(1)
    xq = rng.randn(2, sq, e).astype(np.float32)
    xkv = rng.randn(2, sk, e).astype(np.float32) if sk else None
    ct = rng.randn(2, sq, e).astype(np.float32)
    pack = (lambda q, kv: q) if sk is None else (lambda q, kv: [q, kv])

    @jax.jit
    def jloss(p, q, kv):
        y, _ = jm.apply({"params": p, "state": {}}, pack(q, kv))
        return jnp.sum(y * ct), y

    jkv_in = jnp.asarray(xkv) if sk else jnp.zeros(())
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(jp, jnp.asarray(xq),
                                                   jkv_in)
    p = {k: v.requires_grad_() for k, v in tp.items()}
    tq = torch.tensor(xq, requires_grad=True)
    tkv_in = torch.tensor(xkv, requires_grad=True) if sk else None
    ty, _ = tm.apply({"params": p, "state": {}}, pack(tq, tkv_in))
    inputs = [tq] + ([tkv_in] if sk else [])
    grads = torch.autograd.grad((ty * torch.from_numpy(ct)).sum(),
                                tree_leaves(p) + inputs)
    assert _rel(ty.detach(), jy) <= TOL
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1]] \
        + ([jg[2]] if sk else [])
    assert len(grads) == len(want) == (9 if with_bias else 5) + bool(sk)
    names = sorted(p) + ["x_q", "x_kv"]
    top = max(float(np.abs(b).max()) for b in want)
    for name, a, b in zip(names, grads, want):
        assert a.shape == b.shape, name
        if name == "bk":
            # zero in exact arithmetic: both are rounding noise
            assert max(float(a.abs().max()),
                       float(np.abs(b).max())) <= TOL * top
        else:
            assert _rel(a, b) <= TOL, (name, _rel(a, b))


def test_mha_head_dim_and_errors():
    assert tnn.MultiHeadAttention(16, 2).head_dim == 8
    assert tnn.MultiHeadAttention(16, 3, head_dim=5).head_dim == 5
    with pytest.raises(ValueError, match="not divisible"):
        tnn.MultiHeadAttention(16, 3)
    m = tnn.MultiHeadAttention(16, 2, attn_dropout=0.1)
    v = m.init(device="cpu")
    with pytest.raises(ValueError, match="needs an rng"):
        m.apply(v, torch.zeros(1, 3, 16), training=True)
    with pytest.raises(ValueError, match="causal=True"):
        m.apply_prefill(v, torch.zeros(1, 3, 16), m.init_cache(1, 4))
    assert set(v["params"]) == {"wq", "wk", "wv", "wo",
                                "bq", "bk", "bv", "bo"}


def test_decode_matches_full_forward_and_jax():
    """apply_prefill of a prompt, then apply_decode a token at a time,
    equals apply over the whole sequence row for row, in the port and
    in the JAX package, from one set of weights."""
    e, heads, batch, prompt, new, max_len = 16, 2, 3, 7, 5, 16
    jm, tm, jp, tp = _mha_pair(e, heads, True, True, seed=2)
    x = np.random.RandomState(3).randn(batch, prompt + new,
                                       e).astype(np.float32)
    tx = torch.from_numpy(x)
    full, _ = tm.apply({"params": tp, "state": {}}, tx)
    cache = tm.init_cache(batch, max_len, device="cpu")
    y, cache = tm.apply_prefill({"params": tp}, tx[:, :prompt], cache)
    rows = [y]
    jcache = jm.init_cache(batch, max_len)
    jy, jcache = jm.apply_prefill({"params": jp}, jnp.asarray(x[:, :prompt]),
                                  jcache)
    jrows = [np.asarray(jy)]
    for t in range(prompt, prompt + new):
        pos = torch.full((batch,), t, dtype=torch.int32)
        yt, cache = tm.apply_decode({"params": tp}, tx[:, t], cache, pos)
        rows.append(yt[:, None])
        jyt, jcache = jm.apply_decode({"params": jp}, jnp.asarray(x[:, t]),
                                      jcache, jnp.asarray(pos.numpy()))
        jrows.append(np.asarray(jyt)[:, None])
    got = torch.cat(rows, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.concatenate(jrows, 1),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-6, rtol=0)


def test_dense_cache_functions_match_jax():
    """init_layer_cache, write_prefill, update_cache and cached_attention
    against the JAX package's, ragged clocks, with NaN key and value
    rows past one row's clock (poison hygiene: the read stays
    finite)."""
    b, h, s, d, prompt = 3, 2, 12, 8, 5
    rng = np.random.RandomState(4)
    kp, vp = (rng.randn(b, h, prompt, d).astype(np.float32) for _ in "kv")
    kn, vn, q = (rng.randn(b, h, 1, d).astype(np.float32) for _ in "kvq")
    pos = np.array([5, 8, 11], np.int32)
    tk, tv = tkv.init_layer_cache(b, h, s, d)
    jk, jv = jkv.init_layer_cache(b, h, s, d)
    assert tk.shape == jk.shape and not tk.any()
    tk, tv = tkv.write_prefill(tk, tv, torch.from_numpy(kp),
                               torch.from_numpy(vp))
    jk, jv = jkv.write_prefill(jk, jv, jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = tkv.update_cache(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pos))
    jk, jv = jkv.update_cache(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a poisoned former occupant's rows past row 0's clock
    tk[0, :, 9:] = float("nan")
    tv[0, :, 9:] = float("nan")
    jk = jk.at[0, :, 9:].set(jnp.nan)
    jv = jv.at[0, :, 9:].set(jnp.nan)
    got = tkv.cached_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(pos))
    want = jkv.cached_attention(jnp.asarray(q), jk, jv, jnp.asarray(pos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="one row"):
        tkv.cached_attention(torch.zeros(b, h, 2, d), tk, tv,
                             torch.from_numpy(pos))


@pytest.mark.parametrize("d", [8, 24, 80])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padded_head_dim_is_bitwise_the_unpadded(d, causal):
    """The kernels' wrapper pads D to the next instantiation and slices
    back; on the plain versions the padded forward and backward equal
    the unpadded ones bit for bit (zero columns add exact zeros), with
    sm_scale from the unpadded D and delta over the unpadded columns,
    as the wrapper takes them."""
    dp = tfa.kernel_head_dim(d)
    assert dp in tfa.HEAD_DIMS and dp >= d
    g = torch.Generator().manual_seed(d)
    q, o_ct = (torch.randn(3, 37, d, generator=g) for _ in "qo")
    k, v = (torch.randn(3, 45, d, generator=g) for _ in "kv")
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.attention_reference(q, k, v, causal, scale,
                                       return_lse=True)
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, o_ct)
    assert qp.shape[-1] == dp
    outp, lsep = tfa.attention_reference(qp, kp, vp, causal, scale,
                                         return_lse=True)
    assert torch.equal(tfa.unpad_head_dim(d, outp)[0], out)
    assert torch.equal(lsep, lse)
    assert not outp[..., d:].any()
    grads = tfa.flash_attention_backward_reference(q, k, v, out, lse, o_ct,
                                                   causal, scale)
    delta = (o_ct * out).sum(dim=-1)
    padded = tfa.flash_attention_backward_reference(
        qp, kp, vp, outp, lsep, dop, causal, scale, delta=delta)
    for a, b in zip(tfa.unpad_head_dim(d, *padded), grads):
        assert torch.equal(a, b)
    for t in padded:
        assert not t[..., d:].any()


def test_head_dim_limit_names_it():
    assert [tfa.kernel_head_dim(d) for d in (1, 32, 33, 64, 65, 128)] \
        == [32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="head_dim <= 128"):
        tfa.kernel_head_dim(160)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        tfa.flash_fwd_cuda(*(torch.zeros(2, 4, 160) for _ in "qkv"),
                           False, 0.1)


def test_attention_dropout():
    """p = 0 is the undropped attention bit for bit; p > 0 keeps each
    probability with probability 1 - p (share within 3 sigma), scaled
    by 1 / (1 - p); the JAX reference agrees at p = 0. In training an
    MHA with attn_dropout takes this path, with its rng."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 4, 64, 16).astype(np.float32) for _ in "qkv")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    base = tfa.attention_reference(tq, tk, tv, causal=True)
    g = torch.Generator().manual_seed(0)
    same = tfa.attention_reference(tq, tk, tv, causal=True, dropout=0.0,
                                   dropout_generator=g)
    assert torch.equal(same, base)
    want = jax.jit(functools.partial(j_attention_reference, causal=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(base.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    p = 0.3
    # v = identity rows read the dropped probabilities back out
    eye = torch.eye(64).expand(2, 4, 64, 64).contiguous()
    probs = tfa.attention_reference(tq, tk, eye, causal=False,
                                    sm_scale=0.0)
    dropped = tfa.attention_reference(tq, tk, eye, causal=False,
                                      sm_scale=0.0, dropout=p,
                                      dropout_generator=g)
    kept = (dropped != 0).float().mean().item()
    n = dropped.numel()
    assert abs(kept - (1 - p)) <= 3 * math.sqrt(p * (1 - p) / n)
    nz = dropped[dropped != 0]
    assert torch.allclose(nz, probs[dropped != 0] / (1 - p))
    with pytest.raises(ValueError, match="dropout_generator"):
        tfa.attention_reference(tq, tk, tv, dropout=0.5)
    m = tnn.MultiHeadAttention(16, 2, attn_dropout=0.5, out_dropout=0.25)
    variables = m.init(device="cpu")
    x = torch.randn(2, 8, 16, generator=g)
    y1, _ = m.apply(variables, x, training=True,
                    rng=torch.Generator().manual_seed(1))
    y2, _ = m.apply(variables, x, training=True,
                    rng=torch.Generator().manual_seed(1))
    y_eval, _ = m.apply(variables, x)
    assert torch.equal(y1, y2) and not torch.equal(y1, y_eval)
    assert 0.15 < (y1 == 0).float().mean().item() < 0.35
