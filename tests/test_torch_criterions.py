"""The 16 criterions of bigdl_tpu_torch/nn/criterion.py that came with
slice 13 against the JAX package's (bigdl_tpu/nn/criterion.py): one
case each, forward and the gradient with respect to every input, the
JAX side's from `jax.grad`, on the same seeded fp32 inputs. The table
criterions (Parallel, Multi, CosineEmbedding, MarginRanking, KLD) also
take their inputs as `utils/table` Tables, and a Table gives what a
tuple gives; the JAX package's MarginRankingCriterion indexes its input
from 0, so its JAX side takes the tuple.

Tolerance (fp32): loss and gradients rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils.table import T as TT

N, C = 6, 5
TOL = dict(rtol=1e-5, atol=1e-6)


def _pm1(rng, shape):
    return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _case(name, rng):
    """(jax criterion, port criterion, inputs, target, packing): inputs a
    list of fp32 arrays; packing "one" (the array), "table" (a Table of
    them) or "pair" (a Table in the port, a tuple in JAX)."""
    x = rng.randn(N, C).astype(np.float32)
    y = rng.randn(N, C).astype(np.float32)
    ids = rng.randint(0, C, N).astype(np.int32)
    if name == "Abs":
        return jnn.AbsCriterion(), tnn.AbsCriterion(), [x], y, "one"
    if name == "BCE":
        w = rng.rand(C).astype(np.float32)
        p = (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
        t = (rng.rand(N, C) < 0.5).astype(np.float32)
        return (jnn.BCECriterion(jnp.asarray(w), size_average=False),
                tnn.BCECriterion(torch.from_numpy(w), size_average=False),
                [p], t, "one")
    if name == "SmoothL1":                     # |d| on both sides of 1
        return (jnn.SmoothL1Criterion(), tnn.SmoothL1Criterion(),
                [2.0 * x], y, "one")
    if name == "Margin":
        return (jnn.MarginCriterion(0.5, squared=True),
                tnn.MarginCriterion(0.5, squared=True), [x],
                _pm1(rng, (N, C)), "one")
    if name == "MultiLabelMargin":
        t = (rng.rand(N, C) < 0.4).astype(np.float32)
        t[0], t[1] = 0.0, 1.0                  # no positive; all positive
        return (jnn.MultiLabelMarginCriterion(),
                tnn.MultiLabelMarginCriterion(), [x], t, "one")
    if name == "HingeEmbedding":
        return (jnn.HingeEmbeddingCriterion(1.5, size_average=False),
                tnn.HingeEmbeddingCriterion(1.5, size_average=False),
                [2.0 * x], _pm1(rng, (N, C)), "one")
    if name == "CosineEmbedding":
        return (jnn.CosineEmbeddingCriterion(0.1),
                tnn.CosineEmbeddingCriterion(0.1), [x, x + 0.7 * y],
                _pm1(rng, (N,)), "table")
    if name == "DistKLDiv":
        t = rng.rand(N, C).astype(np.float32)
        t[t < 0.3] = 0.0                       # zero targets contribute 0
        logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        return (jnn.DistKLDivCriterion(), tnn.DistKLDivCriterion(),
                [logp.astype(np.float32)], t, "one")
    if name == "KLD":
        return (jnn.KLDCriterion(), tnn.KLDCriterion(), [x, 0.5 * y], None,
                "table")
    if name == "L1Cost":
        return jnn.L1Cost(), tnn.L1Cost(), [x], None, "one"
    if name == "ClassSimplex":
        return (jnn.ClassSimplexCriterion(C), tnn.ClassSimplexCriterion(C),
                [x], ids, "one")
    if name == "Parallel":
        t = [y, rng.randn(N, C).astype(np.float32)]
        return (jnn.ParallelCriterion().add(jnn.AbsCriterion(), 0.7)
                .add(jnn.SmoothL1Criterion(size_average=False), 1.3),
                tnn.ParallelCriterion().add(tnn.AbsCriterion(), 0.7)
                .add(tnn.SmoothL1Criterion(size_average=False), 1.3),
                [x, 2.0 * y], t, "table")
    if name == "Multi":
        return (jnn.MultiCriterion().add(jnn.CosineEmbeddingCriterion(0.1),
                                         0.6).add(jnn.KLDCriterion(), 0.4),
                tnn.MultiCriterion().add(tnn.CosineEmbeddingCriterion(0.1),
                                         0.6).add(tnn.KLDCriterion(), 0.4),
                [x, y], _pm1(rng, (N,)), "table")
    if name == "MultiMargin":
        return (jnn.MultiMarginCriterion(p=2, margin=0.8),
                tnn.MultiMarginCriterion(p=2, margin=0.8), [x], ids, "one")
    if name == "MarginRanking":
        return (jnn.MarginRankingCriterion(0.3),
                tnn.MarginRankingCriterion(0.3), [x[:, 0], y[:, 0]],
                _pm1(rng, (N,)), "pair")
    if name == "CosineProximity":
        return (jnn.CosineProximityCriterion(),
                tnn.CosineProximityCriterion(), [x, y], None, "target")
    raise KeyError(name)


CASES = ("Abs", "BCE", "SmoothL1", "Margin", "MultiLabelMargin",
         "HingeEmbedding", "CosineEmbedding", "DistKLDiv", "KLD", "L1Cost",
         "ClassSimplex", "Parallel", "Multi", "MultiMargin", "MarginRanking",
         "CosineProximity")


def _pack(mod_t, xs, how, jax_side):
    if how in ("one", "target"):
        return xs[0]
    if how == "pair" and jax_side:
        return tuple(xs)
    return mod_t(*xs)


def _jax(crit, xs, target, how):
    tgt = None if target is None else (
        JT(*map(jnp.asarray, target)) if isinstance(target, list)
        else jnp.asarray(target))

    def f(*args):
        if how == "target":                # the second input is the target
            return crit(args[0], args[1])
        return crit(_pack(JT, args, how, True), tgt)

    loss, grads = jax.value_and_grad(f, argnums=tuple(range(len(xs))))(
        *map(jnp.asarray, xs))
    return float(loss), [np.asarray(g) for g in grads]


def _torch(crit, xs, target, how, as_table=True):
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    tgt = None if target is None else (
        TT(*map(torch.from_numpy, target)) if isinstance(target, list)
        else torch.from_numpy(target))
    if how == "target":
        loss = crit(ts[0], ts[1])
    elif as_table:
        loss = crit(_pack(TT, ts, how, False), tgt)
    else:                                      # the same entries as a tuple
        loss = crit(tuple(ts), tgt)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    return float(loss.detach()), [g.numpy() for g in
                                  torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("name", CASES)
def test_criterion_matches_jax(name):
    rng = np.random.RandomState(CASES.index(name))
    jc, tc, xs, target, how = _case(name, rng)
    jl, jg = _jax(jc, xs, target, how)
    tl, tg = _torch(tc, xs, target, how)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **TOL)
    assert any(np.abs(g).max() > 0 for g in tg)
    if how in ("table", "pair"):
        tl2, tg2 = _torch(tc, xs, target, how, as_table=False)
        assert tl2 == tl
        for a, b in zip(tg2, tg):
            np.testing.assert_array_equal(a, b)


def test_parallel_repeat_target_and_simplex_bits():
    rng = np.random.RandomState(99)
    x1, x2, y = (rng.randn(N, C).astype(np.float32) for _ in range(3))
    jc = jnn.ParallelCriterion(repeat_target=True) \
        .add(jnn.MSECriterion(), 0.5).add(jnn.AbsCriterion())
    tc = tnn.ParallelCriterion(repeat_target=True) \
        .add(tnn.MSECriterion(), 0.5).add(tnn.AbsCriterion())
    jl = float(jc(JT(jnp.asarray(x1), jnp.asarray(x2)), jnp.asarray(y)))
    tl = float(tc(TT(torch.from_numpy(x1), torch.from_numpy(x2)),
                  torch.from_numpy(y)))
    np.testing.assert_allclose(tl, jl, **TOL)
    for n in (2, 5, 10):
        np.testing.assert_array_equal(
            tnn.ClassSimplexCriterion(n).simplex.numpy(),
            np.asarray(jnn.ClassSimplexCriterion(n).simplex))
    with pytest.raises(ValueError, match="p must be 1 or 2"):
        tnn.MultiMarginCriterion(p=3)
