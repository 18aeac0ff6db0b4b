"""The port's dropout layers, `nn.Graph` and the rest of the CNN zoo
(bigdl_tpu_torch/nn/dropout.py, nn/graph.py, models/inception.py,
vgg.py, alexnet.py, lenet.graph and perf.py's table) against the JAX
package's.

Every parity case draws one variable tree from a seed (shapes from
`jax.eval_shape(model.init, key)`, so no threefry draw is compiled):
weights N(0, 2 / fan_in), biases and running means N(0, 0.1²), running
variances in [0.5, 1.5) and batch-norm gammas 1 + N(0, 0.5²). The tree
is carried across with `variables_from_jax`; inputs are seeded numpy.
The loss is the sum of each output times a seeded cotangent, and its
gradients are taken with respect to every parameter.

Tolerances (tests/test_torch_cnn_models.py's): fp32 outputs and new
running statistics rtol 1e-4 / atol 1e-5, loss 1e-5 of its scale,
gradients within 1e-4 of each leaf's largest entry. Dropout's masks
are torch's, not threefry's, so dropout is held to JAX only in
evaluation and at p = 0; for p > 0 the keep rate (within five binomial
standard deviations), the 1 / (1 - p) scale, one mask a seed and
whole-channel drops are held instead.
"""

import ast
import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import alexnet as jalexnet
from bigdl_tpu.models import inception as jinception
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import perf as jperf
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import alexnet as talexnet
from bigdl_tpu_torch.models import inception as tinception
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models import perf as tperf
from bigdl_tpu_torch.models import vgg as tvgg
from bigdl_tpu_torch.models.convert import (tree_leaves,
                                            tree_leaves_with_path,
                                            variables_from_jax)

KEY = jax.random.PRNGKey(0)
FWD = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_TOL_FP64 = 1e-10
GRAD_FLOOR = 1e-3
ZERO_GRAD_TOL = 1e-5


def _seeded(jm, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name, shape = str(path[-1].key), a.shape
        if name == "running_var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if len(shape) == 1:
            v = rng.randn(*shape).astype(np.float32)
            return 1.0 + 0.5 * v if name == "weight" else 0.1 * v
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf,
                                            jax.eval_shape(jm.init, KEY))


def _paths(tree):
    return [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _check(jm, tm, xs, training=False, seed=0, grads=True, fp64=False,
           zero_grad=lambda path: False):
    """The forward (and, with `grads`, the gradients of sum(out * ct)
    with respect to every parameter) of both packages on one seeded
    tree: outputs, new state, loss and gradients; `fp64` runs both in
    float64 (JAX with x64 on, restored after). A leaf for which
    `zero_grad(path)` holds has an exact gradient of 0 (a bias before a
    batch norm in training): both packages' values must be rounding
    noise, under ZERO_GRAD_TOL of the largest gradient entry. Returns
    the port's (outputs, new state)."""
    dt = np.float64 if fp64 else np.float32
    jv = jax.tree_util.tree_map(lambda a: np.asarray(a, dt),
                                _seeded(jm, seed))
    tv = variables_from_jax(jv, device="cpu")
    assert [p for p, _ in tree_leaves_with_path(tv["params"])] \
        == _paths(jv["params"])
    xs = [x.astype(dt) for x in xs]
    rng = np.random.RandomState(seed + 7)
    with _x64() if fp64 else contextlib.nullcontext():
        def jfwd(p):
            out, state = jm.apply({"params": p, "state": jv["state"]},
                                  *[jnp.asarray(x) for x in xs],
                                  training=training)
            return jax.tree_util.tree_leaves(out), state

        cts = [rng.randn(*s.shape).astype(dt) for s in
               jax.eval_shape(jfwd, jv["params"])[0]]

        def jloss(p):
            leaves, state = jfwd(p)
            return sum(jnp.sum(o * c) for o, c in zip(leaves, cts)), \
                (leaves, state)

        fn = jax.value_and_grad(jloss, has_aux=True) if grads \
            else (lambda p: (jloss(p), None))
        # XLA:CPU's backend optimisations off halve an fp32 compile;
        # fp64 convolutions need them (an fp64 Inception step: 84 s
        # without, 6 s with)
        opts = {} if fp64 else {"xla_backend_optimization_level": 0}
        (jl, (jout, jstate)), jg = jax.jit(fn).lower(jv["params"]).compile(
            compiler_options=opts)(jv["params"])
        jout, jstate, jg = jax.device_get((jout, jstate, jg))

    leaves = [t.requires_grad_(grads) for t in tree_leaves(tv["params"])]
    out, tstate = tm.apply(tv, *[torch.from_numpy(x) for x in xs],
                           training=training)
    tout = tree_leaves(out)
    tl = sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cts))
    scale = max(1.0, abs(float(jl)))
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL * scale
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)
    ts, js = tree_leaves(tstate), jax.tree_util.tree_leaves(jstate)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)
    if grads:
        tg = torch.autograd.grad(tl, leaves)
        jleaves = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
        tol = GRAD_TOL_FP64 if fp64 else GRAD_TOL
        top = max(float(np.abs(b).max()) for b in jleaves)
        for path, a, b in zip(_paths(jg), tg, jleaves):
            if zero_grad(path):
                noise = max(float(a.abs().max()), float(np.abs(b).max()))
                assert noise <= ZERO_GRAD_TOL * top, (path, noise / top)
                continue
            err = float(np.abs(a.numpy() - b).max()) \
                / max(float(np.abs(b).max()), GRAD_FLOOR * top)
            assert err <= tol, (path, err)
    return out, tstate


def _images(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ dropout
EVAL_OR_P0 = {
    "dropout_eval": (lambda nn: nn.Dropout(0.5), False),
    "dropout_p0_train": (lambda nn: nn.Dropout(0.0), True),
    "spatial_dropout_eval": (lambda nn: nn.SpatialDropout2D(0.3), False),
    "spatial_dropout_p0_train": (lambda nn: nn.SpatialDropout2D(0.0), True),
    "gaussian_noise_eval": (lambda nn: nn.GaussianNoise(0.7), False),
    "gaussian_dropout_eval": (lambda nn: nn.GaussianDropout(0.4), False),
}


@pytest.mark.parametrize("case", sorted(EVAL_OR_P0))
def test_dropout_matches_jax_in_evaluation_and_at_p0(case):
    """The identity on both sides: no rng is needed or drawn."""
    factory, training = EVAL_OR_P0[case]
    jm, tm = factory(jnn), factory(tnn)
    x = _images((2, 3, 3, 4), 1)
    jy, _ = jm.apply(jm.init(KEY), jnp.asarray(x), training=training)
    ty, _ = tm.apply(tm.init(device="cpu"), torch.from_numpy(x),
                     training=training)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ty.numpy(), x)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keep_rate_scale_and_seed(p):
    m = tnn.Dropout(p)
    v = m.init(device="cpu")
    x = torch.ones(400, 500)
    y, _ = m.apply(v, x, training=True, rng=_gen(3))
    keep = 1.0 - p
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - keep) \
        <= 5 * np.sqrt(keep * p / n)
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.0 / keep))
    y2, _ = m.apply(v, x, training=True, rng=_gen(3))
    y3, _ = m.apply(v, x, training=True, rng=_gen(4))
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    unscaled, _ = tnn.Dropout(p, scale=False).apply(v, x, training=True,
                                                    rng=_gen(3))
    assert torch.equal(unscaled != 0, kept) \
        and torch.equal(unscaled[kept], x[kept])
    # the gradient is the mask over keep
    xg = torch.randn(50, 40, requires_grad=True)
    out, _ = m.apply(v, xg, training=True, rng=_gen(5))
    (g,) = torch.autograd.grad(out.sum(), xg)
    assert torch.equal(g, (out != 0).float() / keep)


def test_spatial_dropout_drops_whole_nhwc_channels():
    p = 0.4
    x = torch.rand(64, 5, 6, 32) + 0.5
    y, _ = tnn.SpatialDropout2D(p).apply({"params": {}, "state": {}}, x,
                                         training=True, rng=_gen(2))
    kept = (y != 0).flatten(1, 2)                        # (N, H*W, C)
    assert torch.equal(kept.all(dim=1), kept.any(dim=1))  # whole maps
    rate = kept.all(dim=1).float().mean().item()
    assert abs(rate - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / (64 * 32))
    on = y != 0
    torch.testing.assert_close(y[on], x[on] / (1 - p))


@pytest.mark.parametrize("kind", ["noise", "dropout"])
def test_gaussian_layers_moments_and_seed(kind):
    x = torch.full((300, 400), 2.0)
    m = tnn.GaussianNoise(0.5) if kind == "noise" \
        else tnn.GaussianDropout(0.2)
    y, _ = m.apply({"params": {}, "state": {}}, x, training=True,
                   rng=_gen(6))
    std = 0.5 if kind == "noise" else 2.0 * (0.2 / 0.8) ** 0.5
    n = x.numel()
    assert abs(y.mean().item() - 2.0) <= 5 * std / np.sqrt(n)
    assert abs(y.std().item() / std - 1.0) <= 5 / np.sqrt(2 * n)
    y2, _ = m.apply({"params": {}, "state": {}}, x, training=True,
                    rng=_gen(6))
    assert torch.equal(y, y2)


@pytest.mark.parametrize("factory", [
    lambda nn: nn.Dropout(0.5), lambda nn: nn.SpatialDropout2D(0.5),
    lambda nn: nn.GaussianNoise(0.1), lambda nn: nn.GaussianDropout(0.1)])
def test_dropout_in_training_needs_an_rng(factory):
    x = _images((2, 3, 3, 4), 2)
    with pytest.raises(ValueError, match="rng"):
        factory(jnn).apply({"params": {}, "state": {}}, jnp.asarray(x),
                           training=True)
    with pytest.raises(ValueError, match="rng"):
        factory(tnn).apply({"params": {}, "state": {}}, torch.from_numpy(x),
                           training=True)


def test_sequential_folds_one_stream_a_child():
    """Two Dropout(0.5) in one Sequential draw independent masks from
    one rng (a quarter of the entries survive both, not a half), and
    the same rng gives the same pair again."""
    m = tnn.Sequential(tnn.Dropout(0.5), tnn.Identity(), tnn.Dropout(0.5))
    v = m.init(device="cpu")
    y1, _ = m.apply(v, torch.ones(64, 64), training=True, rng=_gen(9))
    y2, _ = m.apply(v, torch.ones(64, 64), training=True, rng=_gen(9))
    assert torch.equal(y1, y2)
    both = (y1 != 0).float().mean().item()
    assert abs(both - 0.25) <= 5 * np.sqrt(0.25 * 0.75 / y1.numel())


# -------------------------------------------------------------------- graph
def test_lenet_graph_matches_jax():
    jm, tm = jlenet.graph(10), tlenet.graph(10)
    assert sorted(tm.init(device="cpu")["params"]) \
        == sorted(jax.eval_shape(jm.init, KEY)["params"])
    _check(jm, tm, [_images((3, 28, 28, 1), 1)])


def _shared_graph(nn):
    """Two inputs; one Linear and one BatchNormalization each applied
    twice (shared weights, chained running statistics); two outputs."""
    a, b = nn.Input(), nn.Input()
    lin, bn = nn.Linear(4, 4), nn.BatchNormalization(4)
    h = lin(bn(a))
    g = lin(nn.Tanh()(bn(h)))
    s = nn.CAddTable()(g, nn.Linear(3, 4)(b))
    return nn.Graph([a, b], [s, nn.LogSoftMax()(h)])


def test_weight_sharing_graph_matches_jax():
    jm, tm = _shared_graph(jnn), _shared_graph(tnn)
    tv = tm.init(device="cpu")
    assert sorted(tv["params"]) \
        == sorted(jax.eval_shape(jm.init, KEY)["params"])
    assert len(tv["params"]) == 6      # 6 modules on 8 module nodes
    out, state = _check(jm, tm, [_images((6, 4), 2), _images((6, 3), 3)],
                        training=True)
    assert isinstance(out, dict) and len(out) == 2


def test_graph_errors_and_wiring():
    x = tnn.Input()
    node = tnn.Linear(2, 2)(x)
    assert isinstance(node, tnn.Node) and node.inputs == [x]
    with pytest.raises(ValueError, match="not connected"):
        tnn.Graph([x, tnn.Input()], node)
    a = tnn.Tanh()(node)
    node.inputs.append(a)                       # a -> node -> a
    with pytest.raises(ValueError, match="cycle"):
        tnn.Graph(x, a)
    g = tnn.Graph(x, tnn.Linear(2, 2)(x))
    with pytest.raises(ValueError, match="expects 1 inputs"):
        g.apply(g.init(device="cpu"), torch.ones(1, 2), torch.ones(1, 2))
    lin = tnn.Linear(2, 2).build(device="cpu")  # a tensor call: the eager
    x = torch.ones(1, 2)                          # forward over `variables`
    assert torch.equal(lin(x), lin.apply(lin.variables, x)[0])


# ---------------------------------------------------------------- inception
V1_CFG = ((4,), (4, 6), (2, 3), (3,))


@pytest.mark.parametrize("fused", [False, True])
def test_inception_layer_v1_matches_jax(fused):
    name = "inception_layer_v1_fused" if fused else "inception_layer_v1"
    jm = getattr(jinception, name)(8, V1_CFG, "3a/")
    tm = getattr(tinception, name)(8, V1_CFG, "3a/")
    out, _ = _check(jm, tm, [_images((2, 7, 7, 8), 3)])
    assert out.shape == (2, 7, 7, 4 + 6 + 3 + 3)


@pytest.mark.parametrize("cfg", [
    ((4,), (3, 5), (2, 3), ("avg", 2)),       # stride 1, pool projection
    ((0,), (3, 5), (2, 3), ("max", 0)),       # stride 2, pass-through pool
])
def test_inception_layer_v2_matches_jax(cfg):
    jm = jinception.inception_layer_v2(6, cfg, "4e/")
    tm = tinception.inception_layer_v2(6, cfg, "4e/")
    _check(jm, tm, [_images((2, 8, 8, 6), 4)], training=True,
           zero_grad=lambda path: path[-1] == "bias" and "conv" in path[-2])


def _p0(model, nn):
    """The model with its Dropout's p set to 0 (the gradient case)."""
    mods = model.modules if nn is jnn else model.modules_
    for m in mods:
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def test_inception_v1_fused_tree_matches_jax():
    """build(fused_branches=True): the Graph layers' keys and shapes."""
    jv = jax.eval_shape(jinception.build(10, fused_branches=True).init, KEY)
    tv = tinception.build(10, fused_branches=True).init(device="cpu")
    for part in ("params", "state"):
        assert [(p, tuple(a.shape)) for p, a in
                tree_leaves_with_path(tv[part])] == [
            (tuple(k.key for k in p), a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(jv[part])]


def test_inception_v2_forward_in_evaluation_matches_jax():
    """build_v2 at 224, batch 1, evaluation: every batch norm reads its
    seeded running statistics."""
    jm, tm = jinception.build_v2(1000), tinception.build_v2(1000)
    out, state = _check(jm, tm, [_images((1, 224, 224, 3), 6)],
                        grads=False)
    assert out.shape == (1, 1000)


# ------------------------------------------------------------ vgg, alexnet
def test_vgg16_at_32_matches_jax():
    jm, tm = jvgg.build(16, 10, image_size=32), \
        tvgg.build(16, 10, image_size=32)
    _check(jm, tm, [_images((2, 32, 32, 3), 7)])


def test_vgg_cifar_matches_jax():
    """In evaluation (running statistics): in training, 14 batch norms
    over a batch of 2 amplify the one-pass fp32 variance's cancellation
    (both packages compute E[x^2] - E[x]^2 in fp32, in other orders)
    to 5.6e-4 of the log-probabilities; the layer's training mode is
    held in test_torch_cnn_layers.py and by the v2 layers here."""
    jm, tm = jvgg.build_cifar(10), tvgg.build_cifar(10)
    _check(jm, tm, [_images((2, 32, 32, 3), 8)])


def test_alexnet_matches_jax():
    jm, tm = jalexnet.build(1000), talexnet.AlexNet(1000)
    out, _ = _check(jm, tm, [_images((1, 224, 224, 3), 9)])
    assert out.shape == (1, 1000)


def test_vgg_aliases():
    assert [type(m).__name__ for m in tvgg.Vgg_19(7).modules_] == [
        type(m).__name__ for m in jvgg.Vgg_19(7).modules]
    assert len(tvgg.Vgg_16().modules_) == len(jvgg.Vgg_16().modules)
    assert tinception.Inception_v1 is tinception.build \
        and tinception.Inception_v2 is tinception.build_v2


# --------------------------------------------------------------- perf table
def _table_keys(fn):
    tree = ast.parse(inspect.getsource(fn))
    (table,) = [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "table"]
    return [k.value for k in table.keys]


NEW_PERF_MODELS = ("inception-v1", "inception-v2", "vgg16", "alexnet")


def test_perf_table_is_the_jax_table():
    assert _table_keys(tperf._build_model) \
        == _table_keys(jperf._build_model)


@pytest.mark.parametrize("name", NEW_PERF_MODELS)
def test_perf_models_match_jax(name):
    """Each new entry: the input shape, class count and the variable
    tree's keys and shapes (init only)."""
    jm, jshape, jclasses = jperf._build_model(name, 1000)
    tm, tshape, tclasses = tperf._build_model(name, 1000)
    assert (tshape, tclasses) == (jshape, jclasses)
    jv = jax.eval_shape(jm.init, KEY)
    tv = tm.init(device="meta")
    for part in ("params", "state"):
        assert [(p, tuple(a.shape)) for p, a in
                tree_leaves_with_path(tv[part])] == [
            (tuple(k.key for k in p), a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(jv[part])]


def test_run_perf_keeps_the_trained_step():
    step = tperf.train_step("alexnet", 2, class_num=10, device="cpu")
    before = [t.detach().clone() for t in
              tree_leaves(step.variables()["params"])]
    res = tperf.run_perf("alexnet", 2, 1, class_num=10, device="cpu",
                         step=step)
    assert res["model"] == "alexnet" and res["iterations"] == 1
    after = tree_leaves(step.variables()["params"])
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    assert isinstance(step.model, tnn.Sequential)
