"""The port's sparse layers and sparse tensor (bigdl_tpu_torch/nn/
sparse.py) against the JAX package's (bigdl_tpu/nn/sparse.py), on the
same seeded COO batches and weights.

Tolerances (fp32): forward rtol 1e-5 / atol 1e-6; gradients (weights,
biases and the values) within 1e-5 of each gradient's largest entry;
the COO encodings, joins and dense conversions bit for bit. Padded
entries (value 0 at index 0) contribute nothing, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import sparse as jsp
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves
from bigdl_tpu_torch.nn import sparse as tsp

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(n, cols, cap, seed):
    """Per-row (ids, vals) lists of 1..cap distinct ids, encoded."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        k = rng.randint(1, cap + 1)
        rows.append((rng.choice(cols, k, replace=False),
                     rng.randn(k).astype(np.float32)))
    return rows, jsp.encode_sparse(rows, cap)


def test_encode_sparse_matches_jax():
    rows, (ji, jv) = _batch(6, 50, 5, 0)
    ti, tv = tsp.encode_sparse(rows, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    ti, _ = tsp.encode_sparse(rows)
    assert ti.shape[1] == max(len(ids) for ids, _ in rows)
    with pytest.raises(ValueError, match="capacity"):
        tsp.encode_sparse(rows, 1)


LAYERS = {
    "sparse_linear": lambda nn: nn.SparseLinear(50, 7),
    "sparse_linear_nobias": lambda nn: nn.SparseLinear(50, 7,
                                                       with_bias=False),
    "lookup_sum": lambda nn: nn.LookupTableSparse(50, 6, "sum"),
    "lookup_mean": lambda nn: nn.LookupTableSparse(50, 6, "mean"),
    "lookup_sqrtn": lambda nn: nn.LookupTableSparse(50, 6, "sqrtn"),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_sparse_layer_matches_jax(case):
    jm, tm = LAYERS[case](jnn), LAYERS[case](tnn)
    rng = np.random.RandomState(1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"]
    jp = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    _, (idx, vals) = _batch(8, 50, 6, 2)
    ct = rng.randn(8, 7 if "linear" in case else 6).astype(np.float32)

    def jloss(p, v):
        y, _ = jm.apply({"params": p, "state": {}}, (jnp.asarray(idx), v))
        return jnp.sum(y * ct), y

    (_, jy), (jgp, jgv) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(vals))
    tp = {k: v.requires_grad_()
          for k, v in params_from_jax(jp, device="cpu").items()}
    tv = torch.tensor(vals, requires_grad=True)
    ty, _ = tm.apply({"params": tp, "state": {}},
                     (torch.from_numpy(idx), tv))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    grads = torch.autograd.grad((ty * torch.from_numpy(ct)).sum(),
                                tree_leaves(tp) + [tv])
    want = jax.tree_util.tree_leaves(jgp) + [jgv]
    for a, b in zip(grads, want):
        assert _rel(a, b) <= GRAD_TOL
    # pads contribute nothing: their weight rows get no gradient beyond
    # the real occurrences of id 0
    if "nobias" not in case:
        used = np.zeros(50, bool)
        used[idx[vals != 0]] = True
        assert not grads[-2 if "linear" in case else 0][~used].any()


def test_lookup_rejects_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        tnn.LookupTableSparse(5, 2, "max")


def test_sparse_tensor_ops_match_jax():
    rng = np.random.RandomState(3)
    dense = rng.randn(6, 5).astype(np.float32)
    dense[rng.rand(6, 5) < 0.6] = 0.0
    js = jsp.SparseTensor.from_dense(dense, capacity=20)
    ts = tsp.SparseTensor.from_dense(dense, capacity=20)
    assert ts.nnz_capacity == 20 and ts.shape == (6, 5)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.to_dense().numpy(), dense)
    np.testing.assert_array_equal(ts.transpose().to_dense().numpy(),
                                  dense.T)
    other = rng.randn(6, 5).astype(np.float32)
    oth_j = jsp.SparseTensor.from_dense(other)
    oth_t = tsp.SparseTensor.from_dense(other)
    np.testing.assert_allclose(ts.add(oth_t).scale(0.5).to_dense().numpy(),
                               np.asarray(js.add(oth_j).scale(0.5)
                                          .to_dense()), **FWD)
    np.testing.assert_allclose(
        ts.mul_dense(torch.from_numpy(other)).to_dense().numpy(),
        np.asarray(js.mul_dense(jnp.asarray(other)).to_dense()), **FWD)
    m = rng.randn(5, 4).astype(np.float32)
    vec = rng.randn(5).astype(np.float32)
    c = rng.randn(6, 4).astype(np.float32)
    y = rng.randn(6).astype(np.float32)
    tm, tvec = torch.from_numpy(m), torch.from_numpy(vec)
    np.testing.assert_allclose((ts @ tm).numpy(), np.asarray(js @ m), **FWD)
    np.testing.assert_allclose(ts.mv(tvec).numpy(),
                               np.asarray(js.mv(jnp.asarray(vec))), **FWD)
    np.testing.assert_allclose(float(ts.dot(torch.from_numpy(other))),
                               float(js.dot(jnp.asarray(other))), **FWD)
    np.testing.assert_allclose(
        tsp.addmm(0.5, torch.from_numpy(c), 2.0, ts, tm).numpy(),
        np.asarray(jsp.addmm(0.5, c, 2.0, js, m)), **FWD)
    np.testing.assert_allclose(
        tsp.addmv(0.5, torch.from_numpy(y), 2.0, ts, tvec).numpy(),
        np.asarray(jsp.addmv(0.5, y, 2.0, js, vec)), **FWD)
    with pytest.raises(ValueError, match="shape mismatch"):
        ts.add(tsp.SparseTensor.from_dense(np.ones((2, 2), np.float32)))
    assert "nnz_capacity=20" in repr(ts)


def test_sparse_tensor_grad_through_values():
    rng = np.random.RandomState(4)
    dense = rng.randn(4, 6).astype(np.float32) * (rng.rand(4, 6) < 0.5)
    m = rng.randn(6, 3).astype(np.float32)
    js = jsp.SparseTensor.from_dense(dense, capacity=16)
    jg = jax.grad(lambda v: jnp.sum(js.with_values(v).mm(m) ** 2))(js.values)
    ts = tsp.SparseTensor.from_dense(dense, capacity=16)
    v = ts.values.clone().requires_grad_()
    (tg,) = torch.autograd.grad((ts.with_values(v).mm(torch.from_numpy(m))
                                 ** 2).sum(), v)
    assert _rel(tg, jg) <= GRAD_TOL


def test_sparse_join_table_matches_jax():
    _, a = _batch(4, 10, 3, 5)
    _, b = _batch(4, 20, 2, 6)
    jout, _ = jnn.SparseJoinTable([10, 20]).apply(
        {"params": {}, "state": {}}, [tuple(map(jnp.asarray, a)),
                                      tuple(map(jnp.asarray, b))])
    m = tnn.SparseJoinTable([10, 20])
    ta, tb = (tuple(map(torch.from_numpy, p)) for p in (a, b))
    for args in (([ta, tb],), (ta, tb)):
        tout, _ = m.apply({"params": {}, "state": {}}, *args)
        for x, y in zip(tout, jout):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError, match="input_sizes"):
        m.apply({"params": {}, "state": {}}, [ta])
