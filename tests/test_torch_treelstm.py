"""The port's TreeLSTM (bigdl_tpu_torch/models/treelstm.py, BASELINE
config 4's TreeLSTM half) against the JAX package's
(bigdl_tpu/models/treelstm.py): the tree encoding, the loss and
gradients on both schedules (the serial slot scan and the level-batched
wavefront), the wavefront against the slot scan inside the port, the
NaN poison of a tree deeper than `max_levels`, and 3-step
`Optimizer(...).optimize()` trajectories with TreeNNAccuracy
validation.

The model is cut to vocab 20, embed 8, hidden 8, 3 classes; the trees
are tests/test_treelstm.py's SST-style parses plus seeded random trees
built as bench.py's `bench_treelstm` builds them. Weights are drawn
from a seed with numpy (shapes from `jax.eval_shape`), carried across
with `params_from_jax`.

Tolerances (tests/test_torch_cnn_models.py's): fp32 outputs rtol 1e-4 /
atol 1e-5, loss 1e-5, gradients within 1e-4 of each leaf's largest
entry; wavefront == slot scan inside the port at the JAX package's own
rtol 1e-5 / atol 1e-6 (tests/test_treelstm.py:148-174); trajectories
1e-4 in fp32 and 2e-2 under DEFAULT_MIXED.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.models import treelstm as jtree
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.sample import Sample as TSample
from bigdl_tpu_torch.models import treelstm as ttree
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)

KEY = jax.random.PRNGKey(0)
VOCAB, EMBED, HIDDEN, CLASSES, MAX_NODES = 20, 8, 8, 3, 16
FWD = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
SCHEDULE_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = {"fp32": 1e-4, "bf16": 2e-2}
KEYS = ("word", "left", "right", "is_leaf", "mask", "level")

SST_TREES = [
    ((1, 2), (3, ((4, 5), (6, 7)))),
    (1, (2, (3, (4, (5, 6))))),            # fully right-branching
    (((((1, 2), 3), 4), 5), 6),            # fully left-branching
    ((1, (2, 3)), ((4, 5), (6, (7, 8)))),
    (1, 2),
    ((2, 3), 9),
]


def _rand_tree(rng, leaves, vocab=VOCAB):
    """bench.py `bench_treelstm`'s random binary tree: adjacent pairs
    merged at random until one root is left."""
    nodes = [int(rng.randint(0, vocab)) for _ in range(leaves)]
    while len(nodes) > 1:
        i = int(rng.randint(0, len(nodes) - 1))
        nodes[i:i + 2] = [(nodes[i], nodes[i + 1])]
    return nodes[0]


def _batch(trees, max_nodes=MAX_NODES):
    encs = [ttree.encode_from_nested(t, max_nodes) for t in trees]
    six = tuple(np.stack([e[k] for e in encs]) for k in KEYS)
    return six, max(e["n_levels"] for e in encs)


def _seeded_params(jm, seed=0):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, KEY)["params"]
    return jax.tree_util.tree_map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32), shapes)


def test_encoding_matches_jax():
    rng = np.random.RandomState(3)
    trees = SST_TREES + [_rand_tree(rng, int(rng.randint(1, 9)))
                         for _ in range(20)]
    for t in trees:
        for max_levels in (None, 9):
            a = ttree.encode_from_nested(t, MAX_NODES,
                                         max_levels=max_levels)
            b = jtree.encode_from_nested(t, MAX_NODES,
                                         max_levels=max_levels)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            labels = rng.randint(0, 5, MAX_NODES).astype(np.int32)
            np.testing.assert_array_equal(
                ttree.roots_first(labels, a["n_nodes"], pad=-1),
                jtree.roots_first(labels, b["n_nodes"], pad=-1))
    words = {"a": 4, "b": 7}
    assert ttree.encode_from_nested(("a", "b"), 4, word2id=words.get)[
        "word"].tolist() == [4, 7, 0, 0]
    for mod in (ttree, jtree):
        with pytest.raises(ValueError, match="max_nodes"):
            mod.encode_from_nested((1, (2, (3, 4))), max_nodes=3)
        with pytest.raises(ValueError, match="max_levels"):
            mod.encode_from_nested((1, (2, (3, 4))), 8, max_levels=2)


def _port_loss(tm, params, inputs, cts):
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    out, _ = tm.apply({"params": params, "state": {}},
                      tuple(torch.from_numpy(a) for a in inputs))
    loss = (out * torch.from_numpy(cts)).sum()
    return out, loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("schedule", ["slot_scan", "wavefront"])
def test_loss_and_grads_match_jax(schedule):
    six, max_lv = _batch(SST_TREES)
    inputs = six if schedule == "wavefront" else six[:5]
    jm = jtree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                              max_levels=max_lv)
    tm = ttree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                              max_levels=max_lv)
    jp = _seeded_params(jm)
    cts = np.random.RandomState(1).randn(
        len(SST_TREES), MAX_NODES, CLASSES).astype(np.float32)

    def jloss(p):
        out, _ = jm.apply({"params": p, "state": {}},
                          tuple(jnp.asarray(a) for a in inputs))
        return jnp.sum(out * cts), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = params_from_jax(jp, device="cpu")
    assert [p for p, _ in tree_leaves_with_path(tp)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_leaves_with_path(jp)]
    tout, tl, tg = _port_loss(tm, tp, inputs, cts)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD)
    assert abs(float(tl.detach()) - float(jl)) \
        <= LOSS_TOL * max(1.0, abs(float(jl)))
    for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(jg), tg):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max()) / float(np.abs(b).max())
        assert err <= GRAD_TOL, (path, err)


def test_wavefront_equals_slot_scan_in_the_port():
    rng = np.random.RandomState(4)
    trees = SST_TREES + [_rand_tree(rng, 8) for _ in range(6)]
    six, max_lv = _batch(trees)
    tm = ttree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                              max_levels=max_lv)
    params = tm.init(torch.Generator().manual_seed(2), "cpu")["params"]
    cts = rng.randn(len(trees), MAX_NODES, CLASSES).astype(np.float32)
    slot = _port_loss(tm, params, six[:5], cts)
    wave = _port_loss(tm, params, six, cts)
    for a, b in zip((slot[0], slot[1]) + slot[2],
                    (wave[0], wave[1]) + wave[2]):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   **SCHEDULE_TOL)
    keyed = dict(zip(KEYS, (torch.from_numpy(a) for a in six)))
    out_d, _ = tm.apply({"params": params, "state": {}}, keyed)
    np.testing.assert_array_equal(out_d.detach().numpy(),
                                  wave[0].detach().numpy())


def test_too_deep_tree_poisons_the_output():
    six, max_lv = _batch(SST_TREES)
    jm = jtree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                              max_levels=max_lv - 2)
    jp = _seeded_params(jm)
    jout, _ = jax.jit(lambda p: jm.apply(
        {"params": p, "state": {}}, tuple(jnp.asarray(a) for a in six)))(jp)
    tm = ttree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                              max_levels=max_lv - 2)
    tout, _ = tm.apply({"params": params_from_jax(jp, device="cpu"),
                        "state": {}}, tuple(torch.from_numpy(a) for a in six))
    np.testing.assert_array_equal(np.isnan(tout.numpy()),
                                  np.isnan(np.asarray(jout)))
    assert torch.isnan(tout).all()
    m = ttree.BinaryTreeLSTM(VOCAB, EMBED, HIDDEN, CLASSES,
                             max_levels=max_lv)
    out, _ = m.apply(m.init(device="cpu"),
                     tuple(torch.from_numpy(a) for a in six))
    assert torch.isfinite(out).all()


def _samples(cls, n, seed):
    """Seeded random trees with the root label a function of the first
    leaf, as (6-tuple, label) Samples."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = _rand_tree(rng, int(rng.randint(2, (MAX_NODES + 1) // 2 + 1)))
        e = jtree.encode_from_nested(t, MAX_NODES)
        out.append(cls(tuple(e[k] for k in KEYS),
                       np.int32(e["word"][0] % CLASSES)))
    return out


def _recorder(trigger_cls, out, steps):
    def fn(state):
        if state["loss"] is not None:
            out.append(float(state["loss"]))
        return state["neval"] >= steps
    return trigger_cls(fn)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_optimize_trajectory_with_tree_accuracy_matches_jax(precision):
    """Sequential(BinaryTreeLSTM, Select(2, 1)) — the root's log-probs —
    through Optimizer with Adam(3e-3) for 3 steps of batch 8, as
    bench_treelstm trains it; then TreeNNAccuracy and Loss over a
    held-out set through Evaluator, both packages."""
    max_lv = 9
    jm = jnn.Sequential(jtree.BinaryTreeLSTM(
        VOCAB, EMBED, HIDDEN, CLASSES, max_levels=max_lv), jnn.Select(2, 1))
    tm = tnn.Sequential(ttree.BinaryTreeLSTM(
        VOCAB, EMBED, HIDDEN, CLASSES, max_levels=max_lv), tnn.Select(2, 1))
    jp = _seeded_params(jm, 5)
    jm.variables = {"params": jax.tree_util.tree_map(jnp.asarray, jp),
                    "state": jax.eval_shape(jm.init, KEY)["state"]}
    tm.variables = {"params": params_from_jax(jp, device="cpu"),
                    "state": tm.init(device="cpu")["state"]}
    losses, results = {}, {}
    for pkg, m, opt, nn, ds, sample in (
            ("jax", jm, jopt, jnn, JDataSet, JSample),
            ("torch", tm, topt, tnn, TDataSet, TSample)):
        losses[pkg] = []
        trained = opt.Optimizer(m, ds.array(_samples(sample, 24, 0)),
                                nn.ClassNLLCriterion(), batch_size=8) \
            .set_optim_method(opt.Adam(3e-3)) \
            .set_precision(precision) \
            .set_end_when(_recorder(opt.Trigger, losses[pkg], 3)) \
            .optimize()
        res = opt.Evaluator(trained).test(
            ds.array(_samples(sample, 10, 1)),
            [opt.TreeNNAccuracy(), opt.Loss(nn.ClassNLLCriterion())],
            batch_size=4)
        results[pkg] = {k: r.result() for k, r in res.items()}
    tol = TRAJ_TOL[precision]
    assert len(losses["torch"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=0,
                               atol=tol)
    for a, b in zip(tree_leaves(tm.variables["params"]),
                    jax.tree_util.tree_leaves(jm.variables["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=0, atol=tol)
    assert results["torch"]["TreeNNAccuracy"][1] == 10
    assert results["torch"]["TreeNNAccuracy"] == pytest.approx(
        results["jax"]["TreeNNAccuracy"])
    assert results["torch"]["Loss"] == pytest.approx(
        results["jax"]["Loss"], abs=tol)
