"""The port's CNN-slice layers (bigdl_tpu_torch/nn/: reshape, conv,
pooling, normalization, the table containers and the table ops) against
the JAX package's, one parametrised test a module family.

Every case builds the JAX module and the port's, draws the JAX
variables from one key, overwrites every floating leaf of params and
state with seeded values (batch-norm gammas included, so no branch is
scaled by exactly 0 or 1; running variances positive), carries them
across with `variables_from_jax`, and feeds both the same seeded numpy
inputs. The loss is the sum of each output times a seeded cotangent;
its gradients are taken with respect to every parameter and input.

Tolerances: fp32 forward rtol 1e-4 / atol 1e-5 (as
tests/test_nn_layers.py:84-86), gradients within 1e-4 of each
gradient's largest entry, new batch-norm running statistics as the
forward; bf16 cases within 2e-2 of each output's and gradient's
largest entry. In a bf16 case the port computes in bf16 and the JAX
module in fp32 from the same bf16-rounded params and inputs: XLA:CPU
sums a bf16 reduction in bf16 (the grouped conv's bias gradient, 98
positions, reads 2.3% off the exact sum; the port's, accumulated in
fp32 as cuDNN and ATen accumulate, 0.26%), so JAX's own bf16 run is the
less exact of the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import (tree_leaves, tree_map,
                                            variables_from_jax)
from bigdl_tpu_torch.utils.table import T as TT
from bigdl_tpu_torch.utils.table import Table as TTable

KEY = jax.random.PRNGKey(0)
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def _seeded(module, seed):
    """The JAX module's variable tree with every leaf drawn from `seed`
    (shapes from `jax.eval_shape(module.init, KEY)`, so no threefry
    draw is compiled): running variances in [0.5, 1.5), gammas (the
    'weight' of a 1-D leaf) 1 + N(0, 0.5²), the rest N(0, 0.5²)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(path[-1].key) if path else ""
        if name == "running_var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        v = rng.randn(*a.shape).astype(np.float32) * 0.5
        return v + 1.0 if name == "weight" and len(a.shape) == 1 else v

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(module.init, KEY))


def _inputs(shapes, seed, positive=False):
    rng = np.random.RandomState(seed + 100)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    return [np.abs(x) + 0.5 for x in xs] if positive else xs


def _pack(xs, table, pkg):
    """The inputs as the module takes them: one array, a list, or a
    Table (a dict built in scrambled key order, read back sorted)."""
    if table == "list":
        return list(xs)
    if table == "table":
        order = np.random.RandomState(5).permutation(len(xs))
        cls = JTable if pkg == "jax" else TTable
        return cls({int(i) + 1: xs[i] for i in order})
    if table == "nested":
        t = JT if pkg == "jax" else TT
        return [xs[0], t(xs[1], [xs[2], xs[3]])]
    return xs[0]


def _bf16_rounded(a):
    return np.asarray(jnp.asarray(jnp.asarray(a, jnp.bfloat16), jnp.float32))


def _compare(name, got, want, tol=None):
    got = [g.detach().float().numpy() for g in got]
    want = [np.asarray(w, np.float32) for w in want]
    assert len(got) == len(want), name
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        if tol is None:
            np.testing.assert_allclose(a, b, err_msg=f"{name}[{i}]", **FWD)
        else:
            scale = max(float(np.abs(b).max()), 1e-12)
            err = float(np.abs(a - b).max()) / scale
            assert err <= tol, f"{name}[{i}]: {err:.3g} > {tol}"


def _run_case(factory, shapes, *, table=None, training=False,
              precision="fp32", positive=False, seed=0):
    jm, tm = factory(jnn), factory(tnn)
    jv = _seeded(jm, seed)
    tv = variables_from_jax(jv, device="cpu")
    xs = _inputs(shapes, seed, positive)
    bf16 = precision == "bf16"
    if bf16:
        # JAX computes in fp32 from the bf16-rounded operands
        jv = {"params": jax.tree_util.tree_map(_bf16_rounded, jv["params"]),
              "state": jv["state"]}
        tv = {"params": tree_map(lambda t: t.bfloat16(), tv["params"]),
              "state": tv["state"]}
        xs = [_bf16_rounded(x) for x in xs]
    jx = [jnp.asarray(x) for x in xs]
    tx = [torch.tensor(x, dtype=torch.bfloat16 if bf16 else torch.float32,
                       requires_grad=True) for x in xs]

    def jloss(p, xin):
        out, new_state = jm.apply({"params": p, "state": jv["state"]},
                                  _pack(xin, table, "jax"),
                                  training=training)
        leaves = jax.tree_util.tree_leaves(out)
        cts = _inputs([leaf.shape for leaf in leaves], seed + 7)
        loss = sum(jnp.sum(leaf.astype(jnp.float32) * c)
                   for leaf, c in zip(leaves, cts))
        return loss, (leaves, new_state)

    (_, (jout, jstate)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)).lower(jv["params"], jx).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        jv["params"], jx)

    tparams = tree_map(lambda t: t.requires_grad_(), tv["params"])
    out, tstate = tm.apply({"params": tparams, "state": tv["state"]},
                           _pack(tx, table, "torch"), training=training)
    tout = tree_leaves(out)
    cts = _inputs([tuple(o.shape) for o in tout], seed + 7)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(tout, cts))
    leaves = tree_leaves(tparams) + tx
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    tg = [torch.zeros_like(t) if g is None else g
          for t, g in zip(leaves, tg)]

    _compare("forward", tout, jout, BF16_TOL if bf16 else None)
    _compare("state", tree_leaves(tstate), jax.tree_util.tree_leaves(jstate),
             BF16_TOL if bf16 else None)
    jg = jax.tree_util.tree_leaves(jgp) + list(jgx)
    _compare("grads", tg, jg, BF16_TOL if bf16 else GRAD_TOL)
    for o in tout:
        assert o.dtype == (torch.bfloat16 if bf16 else torch.float32) \
            or not o.is_floating_point()


RESHAPE = {
    "reshape": (lambda nn: nn.Reshape([12]), [(2, 3, 4)]),
    "reshape_no_batch": (lambda nn: nn.Reshape([3, 4], batch_mode=False),
                         [(2, 3, 2)]),
    "view": (lambda nn: nn.View(4, 3), [(2, 12)]),
    "squeeze_all": (lambda nn: nn.Squeeze(), [(2, 1, 3, 1)]),
    "squeeze_dim": (lambda nn: nn.Squeeze(2), [(2, 1, 3)]),
    "unsqueeze": (lambda nn: nn.Unsqueeze(2), [(2, 3)]),
    "select": (lambda nn: nn.Select(2, -1), [(2, 3, 4)]),
    "select_pos": (lambda nn: nn.Select(3, 2), [(2, 3, 4)]),
    "narrow": (lambda nn: nn.Narrow(2, 2, 2), [(2, 5, 3)]),
    "narrow_to_end": (lambda nn: nn.Narrow(3, 2, -1), [(2, 5, 4)]),
    "transpose": (lambda nn: nn.Transpose([(2, 3)]), [(2, 3, 4)]),
    "transpose_two": (lambda nn: nn.Transpose([(1, 2), (2, 3)]),
                      [(2, 3, 4)]),
    "contiguous": (lambda nn: nn.Contiguous(), [(2, 3)]),
    "identity": (lambda nn: nn.Identity(), [(2, 3)]),
    "echo": (lambda nn: nn.Echo(), [(2, 3)]),
    "zero_padding": (lambda nn: nn.SpatialZeroPadding(1, 2, 0, 3),
                     [(2, 4, 5, 3)]),
    "padding_before": (lambda nn: nn.Padding(1, -2, 2, value=1.5),
                       [(2, 3, 4)]),
    "padding_after": (lambda nn: nn.Padding(2, 3, 3), [(2, 3, 4, 2)]),
    "add_constant": (lambda nn: nn.AddConstant(1.5), [(2, 3)]),
    "mul_constant": (lambda nn: nn.MulConstant(-2.0), [(2, 3)]),
    "replicate": (lambda nn: nn.Replicate(3, 2), [(2, 4)]),
    "gradient_reversal": (lambda nn: nn.GradientReversal(0.5), [(2, 3)]),
    "space_to_depth": (lambda nn: nn.SpaceToDepth(2), [(2, 4, 6, 3)]),
}


@pytest.mark.parametrize("case", sorted(RESHAPE))
def test_reshape_layers_match_jax(case):
    factory, shapes = RESHAPE[case]
    _run_case(factory, shapes)


def test_masking_matches_jax():
    x = _inputs([(2, 5, 3)], 0)[0]
    x[0, 1] = 0.0
    x[1, 3:] = 0.0
    jm, tm = jnn.Masking(0.0), tnn.Masking(0.0)
    jy, _ = jm.apply(jm.init(KEY), jnp.asarray(x))
    ty, _ = tm.apply(tm.init(device="cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert not ty[1, 3:].any() and ty[0, 2].all()


CONV = {
    "basic": (lambda nn: nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
              [(2, 9, 9, 3)]),
    "strided_rect": (lambda nn: nn.SpatialConvolution(4, 6, 3, 5, 2, 1,
                                                      1, 2),
                     [(2, 10, 11, 4)]),
    "grouped": (lambda nn: nn.SpatialConvolution(6, 8, 3, 3, 1, 1, 1, 1,
                                                 n_group=2),
                [(2, 7, 7, 6)]),
    "same": (lambda nn: nn.SpatialConvolution(3, 5, 4, 4, 2, 2, -1),
             [(2, 9, 10, 3)]),
    "s2d_stem": (lambda nn: nn.SpatialConvolution(12, 8, 4, 4, 1, 1, (2, 1),
                                                  (2, 1), with_bias=False),
                 [(2, 8, 8, 12)]),
    # a negative symmetric pad crops (lax.conv_general_dilated's rule)
    "negative_pad": (lambda nn: nn.SpatialConvolution(3, 4, 3, 3, 1, 1,
                                                      -2, -2),
                     [(1, 8, 8, 3)]),
    "share": (lambda nn: nn.SpatialShareConvolution(3, 4, 1, 1, 2, 2),
              [(2, 6, 6, 3)]),
    "dilated": (lambda nn: nn.SpatialDilatedConvolution(3, 4, 3, 3, 1, 1,
                                                        2, 2, dilation_w=2),
                [(2, 10, 10, 3)]),
    "dilated_same": (lambda nn: nn.SpatialDilatedConvolution(
        3, 4, 3, 3, 2, 2, -1, dilation_w=2), [(2, 9, 10, 3)]),
    "full": (lambda nn: nn.SpatialFullConvolution(4, 3, 3, 3, 2, 2, 1, 1,
                                                  adj_w=1, adj_h=1),
             [(2, 5, 5, 4)]),
    "full_grouped_dilated": (lambda nn: nn.SpatialFullConvolution(
        4, 6, 3, 3, 2, 2, 0, 0, n_group=2, dilation_w=2), [(2, 4, 5, 4)]),
    "full_adj_over_pad": (lambda nn: nn.SpatialFullConvolution(
        3, 2, 4, 2, 2, 3, 0, 1, adj_w=1, adj_h=2, with_bias=False),
        [(2, 4, 3, 3)]),
    "temporal": (lambda nn: nn.TemporalConvolution(4, 5, 3, 2),
                 [(2, 9, 4)]),
}


def _cases(table, bf16):
    """Every case in fp32, and the named ones (the ResNet path's and one
    of each other kind) also in bf16."""
    return [(c, "fp32") for c in sorted(table)] + [(c, "bf16") for c in bf16]


@pytest.mark.parametrize("case, precision", _cases(
    CONV, ("basic", "grouped", "same", "s2d_stem", "full")))
def test_conv_layers_match_jax(case, precision):
    factory, shapes = CONV[case]
    _run_case(factory, shapes, precision=precision)


POOL = {
    "max": (lambda nn: nn.SpatialMaxPooling(2, 2, 2, 2), [(2, 8, 8, 3)]),
    "max_stem": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                 [(2, 9, 9, 3)]),
    "max_ceil": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2,
                                                 ceil_mode=True),
                 [(2, 8, 8, 3)]),
    "max_same": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2, -1),
                 [(2, 7, 8, 3)]),
    "avg": (lambda nn: nn.SpatialAveragePooling(2, 2, 2, 2), [(2, 8, 8, 3)]),
    "avg_ceil": (lambda nn: nn.SpatialAveragePooling(3, 3, 2, 2,
                                                     ceil_mode=True),
                 [(2, 8, 8, 3)]),
    "avg_ceil_exclude_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, ceil_mode=True, count_include_pad=False),
        [(2, 8, 8, 3)]),
    "avg_pad_exclude_pad": (lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, count_include_pad=False), [(2, 7, 7, 3)]),
    "avg_sum": (lambda nn: nn.SpatialAveragePooling(3, 2, 1, 2, 1, 0,
                                                    divide=False),
                [(2, 6, 7, 3)]),
    "avg_same": (lambda nn: nn.SpatialAveragePooling(3, 3, 2, 2, -1),
                 [(2, 7, 8, 3)]),
    "avg_shortcut_a": (lambda nn: nn.SpatialAveragePooling(1, 1, 2, 2),
                       [(2, 8, 8, 4)]),
    "avg_global": (lambda nn: nn.SpatialAveragePooling(8, 8, 1, 1),
                   [(2, 8, 8, 4)]),
    "temporal_max": (lambda nn: nn.TemporalMaxPooling(2), [(2, 7, 3)]),
    "temporal_max_strided": (lambda nn: nn.TemporalMaxPooling(3, 2),
                             [(2, 8, 3)]),
    "temporal_max_global": (lambda nn: nn.TemporalMaxPooling(-1),
                            [(2, 7, 3)]),
}


@pytest.mark.parametrize("case, precision", _cases(
    POOL, ("max_stem", "avg_shortcut_a", "avg_global", "avg_ceil")))
def test_pooling_matches_jax(case, precision):
    factory, shapes = POOL[case]
    _run_case(factory, shapes, precision=precision)


NORM = {
    "bn_train": (lambda nn: nn.BatchNormalization(5), [(6, 5)], True),
    "bn_eval": (lambda nn: nn.BatchNormalization(5), [(6, 5)], False),
    "bn_no_affine_train": (lambda nn: nn.BatchNormalization(
        5, affine=False), [(6, 5)], True),
    "spatial_bn_train": (lambda nn: nn.SpatialBatchNormalization(
        4, momentum=0.3), [(2, 5, 5, 4)], True),
    "spatial_bn_eval": (lambda nn: nn.SpatialBatchNormalization(4),
                        [(2, 5, 5, 4)], False),
    "lrn": (lambda nn: nn.SpatialCrossMapLRN(5, 1.0, 0.75, 1.0),
            [(2, 3, 3, 8)], False),
    "lrn_even": (lambda nn: nn.SpatialCrossMapLRN(4, 0.5, 0.6, 2.0),
                 [(2, 3, 3, 6)], False),
    "normalize_l2": (lambda nn: nn.Normalize(2.0), [(3, 6)], False),
    "normalize_p": (lambda nn: nn.Normalize(1.5), [(3, 6)], False),
    "layer_norm": (lambda nn: nn.LayerNorm(6), [(3, 6)], False),
    "layer_norm_plain": (lambda nn: nn.LayerNorm(6, affine=False),
                         [(3, 6)], False),
    "rms_norm": (lambda nn: nn.RMSNorm(6), [(3, 6)], False),
}


@pytest.mark.parametrize("case, precision", _cases(
    NORM, ("spatial_bn_train", "spatial_bn_eval")))
def test_normalization_matches_jax(case, precision):
    factory, shapes, training = NORM[case]
    _run_case(factory, shapes, training=training, precision=precision)


CONTAINERS = {
    "concat_table": (lambda nn: nn.ConcatTable(
        nn.Linear(4, 3), nn.Sequential(nn.Linear(4, 2), nn.Tanh())),
        [(2, 4)], None, False),
    "concat_table_bn": (lambda nn: nn.ConcatTable(
        nn.SpatialBatchNormalization(3), nn.Identity()),
        [(2, 4, 4, 3)], None, True),
    "parallel_table": (lambda nn: nn.ParallelTable(
        nn.Linear(4, 3), nn.Linear(2, 5)), [(2, 4), (2, 2)], "list", False),
    "concat": (lambda nn: nn.Concat(2, nn.Linear(4, 3), nn.Linear(4, 2)),
               [(2, 4)], None, False),
    "map_table": (lambda nn: nn.MapTable(nn.Linear(4, 3)),
                  [(2, 4), (2, 4), (2, 4)], "list", False),
    "bottle": (lambda nn: nn.Bottle(nn.Linear(4, 3), 2, 2), [(2, 5, 4)],
               None, False),
}


@pytest.mark.parametrize("case", sorted(CONTAINERS))
def test_table_containers_match_jax(case):
    factory, shapes, table, training = CONTAINERS[case]
    jm, tm = factory(jnn), factory(tnn)
    assert list(tm.init(device="cpu")["params"]) \
        == list(jax.eval_shape(jm.init, KEY)["params"])  # the same keys
    _run_case(factory, shapes, table=table, training=training)


TABLE_OPS = {
    "cadd": (lambda nn: nn.CAddTable(), 3, (2, 3), "list", False),
    "cmul": (lambda nn: nn.CMulTable(), 3, (2, 3), "list", False),
    "csub": (lambda nn: nn.CSubTable(), 2, (2, 3), "list", False),
    "cdiv": (lambda nn: nn.CDivTable(), 2, (2, 3), "list", True),
    "cmax": (lambda nn: nn.CMaxTable(), 3, (2, 3), "list", False),
    "cmin": (lambda nn: nn.CMinTable(), 3, (2, 3), "list", False),
    "join": (lambda nn: nn.JoinTable(2), 2, (2, 3), "list", False),
    "join_batched": (lambda nn: nn.JoinTable(1, n_input_dims=1), 3, (2, 3),
                     "list", False),
    "split": (lambda nn: nn.SplitTable(2), 1, (2, 3, 4), None, False),
    "split_batched": (lambda nn: nn.SplitTable(1, n_input_dims=2), 1,
                      (2, 3, 4), None, False),
    "select": (lambda nn: nn.SelectTable(2), 3, (2, 3), "list", False),
    "select_last": (lambda nn: nn.SelectTable(-1), 3, (2, 3), "list",
                    False),
    "flatten": (lambda nn: nn.FlattenTable(), 4, (2, 3), "nested", False),
    # a Table of 11 built in scrambled order: read in sort_key order
    "select_table_11": (lambda nn: nn.SelectTable(10), 11, (2, 3), "table",
                        False),
    "join_table_11": (lambda nn: nn.JoinTable(2), 11, (2, 1), "table",
                      False),
    "cadd_table_11": (lambda nn: nn.CAddTable(), 11, (2, 3), "table",
                      False),
}


@pytest.mark.parametrize("case", sorted(TABLE_OPS))
def test_table_ops_match_jax(case):
    factory, n, shape, table, positive = TABLE_OPS[case]
    _run_case(factory, [shape] * n, table=table, positive=positive)


def test_table_sort_key_order():
    from bigdl_tpu.utils.table import sort_key as jkey
    from bigdl_tpu_torch.utils.table import sort_key as tkey

    keys = [10, "b", 2, 1, "a", 11]
    assert sorted(keys, key=tkey) == sorted(keys, key=jkey) \
        == [1, 2, 10, 11, "a", "b"]
    t = TT(5, 6, x=7)
    assert dict(t) == {1: 5, 2: 6, "x": 7} and t.insert(8)[4] == 8
