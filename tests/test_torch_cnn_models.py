"""The port's CNN models (bigdl_tpu_torch/models/lenet.py, resnet.py,
perf.py) against the JAX package's (bigdl_tpu/models/): LeNet-5
(BASELINE config 1), the CIFAR ResNet with shortcuts A and B, a
bottleneck block and both ImageNet stems, the ImageNet ResNet trees
(config 2), and `Optimizer(...).optimize()` trajectories.

Every case draws one variable tree from a seed (shapes from
`jax.eval_shape(model.init, key)`, so no threefry draw is compiled):
weights N(0, 2 / fan_in), biases and running means N(0, 0.1²), running
variances in [0.5, 1.5), and every batch-norm gamma 1 + N(0, 0.5²) —
never the init's 1 or the zero_gamma 0, under which a block's main
branch would add exactly 0 and a wrong branch would pass. The tree is
carried across with `variables_from_jax`; inputs are seeded numpy.

Tolerances: fp32 outputs rtol 1e-4 / atol 1e-5 and loss 1e-5, gradients
within 1e-4 of each leaf's largest entry, new running statistics rtol
1e-4 / atol 1e-5; 3-step trajectories 1e-4 in fp32 and 2e-2 under
DEFAULT_MIXED (bf16 compute, fp32 masters).
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.cifar import synthetic_cifar10 as jcifar
from bigdl_tpu.dataset.mnist import synthetic_mnist as jmnist
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import perf as jperf
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.cifar import synthetic_cifar10 as tcifar
from bigdl_tpu_torch.dataset.mnist import synthetic_mnist as tmnist
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models import perf as tperf
from bigdl_tpu_torch.models import resnet as tresnet
from bigdl_tpu_torch.models.convert import (tree_leaves,
                                            tree_leaves_with_path,
                                            variables_from_jax)

KEY = jax.random.PRNGKey(0)
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-4
TRAJ_TOL = {"fp32": 1e-4, "bf16": 2e-2}


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


def _jit_o0(fn, *args):
    """fn(*args) jitted with XLA:CPU's backend optimization off: the same
    HLO and arithmetic, half the compile time of a ResNet step."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), \
        rng.randint(0, 10, shape[0]).astype(np.int32)


def _check_step(jm, tm, x, y, seed=0):
    """One training-mode loss-and-grad step, both packages: loss,
    log-probabilities, every gradient and the new running statistics."""
    jv = _seeded(jm, seed)
    tv = variables_from_jax(jv, device="cpu")
    def jfn(p):
        out, state = jm.apply({"params": p, "state": jv["state"]},
                              jnp.asarray(x), training=True)
        return jnn.ClassNLLCriterion()(out, jnp.asarray(y)), (out, state)

    (jl, (jout, jstate)), jg = _jit_o0(jax.value_and_grad(
        jfn, has_aux=True), jv["params"])
    leaves = [t.requires_grad_() for t in tree_leaves(tv["params"])]
    tout, tstate = tm.apply(tv, torch.from_numpy(x), training=True)
    tl = tnn.ClassNLLCriterion()(tout, torch.from_numpy(y))
    tg = torch.autograd.grad(tl, leaves)

    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert [p for p, _ in tree_leaves_with_path(tv["params"])] == [
        tuple(k.key for k in p) for p, _ in jleaves]
    for (path, b), a in zip(jleaves, tg):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max()) / float(np.abs(b).max())
        assert err <= GRAD_TOL, (path, err)
    js = jax.tree_util.tree_leaves(jstate)
    ts = tree_leaves(tstate)
    assert len(ts) == len(js) and not any(t.requires_grad for t in ts)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    return tv, tstate


def test_lenet_loss_and_grads_match_jax():
    x, y = _images((4, 28, 28, 1), 1)
    _check_step(jlenet.build(10), tlenet.build(10), x, y)


@pytest.mark.parametrize("shortcut", ["A", "B"])
def test_cifar_resnet_matches_jax(shortcut):
    x, y = _images((2, 32, 32, 3), 2)
    tv, tstate = _check_step(jresnet.build_cifar(8, 10, shortcut),
                             tresnet.build_cifar(8, 10, shortcut), x, y)
    changed = [not torch.equal(a, b) for a, b in
               zip(tree_leaves(tstate), tree_leaves(tv["state"]))]
    assert changed and all(changed)


def _stem(resnet, nn, stem):
    """build_imagenet's stem: [SpaceToDepth,] conv1, BN, ReLU, max pool."""
    full = resnet.build_imagenet(18, 10, stem=stem)
    mods = full.modules if resnet is jresnet else full.modules_
    return nn.Sequential(*mods[:5 if stem == "s2d" else 4])


@pytest.mark.parametrize("case", ["bottleneck", "conv7", "s2d"])
def test_bottleneck_and_stems_match_jax(case):
    """A block or a stem, its output flattened into a LogSoftMax and
    ClassNLL over seeded labels, so every output entry gets a gradient."""
    if case == "bottleneck":
        jm, tm = (r.bottleneck(64, 16, stride=2) for r in (jresnet, tresnet))
        x = _images((2, 8, 8, 64), 3)[0]
    else:
        jm, tm = _stem(jresnet, jnn, case), _stem(tresnet, tnn, case)
        x = _images((2, 32, 32, 3), 4)[0]
    jm = jnn.Sequential(jm, jnn.Reshape([-1]), jnn.LogSoftMax())
    tm = tnn.Sequential(tm, tnn.Reshape([-1]), tnn.LogSoftMax())
    n_out = int(np.prod(jax.eval_shape(
        lambda v, a: jm.apply(v, a)[0], jax.eval_shape(jm.init, KEY),
        jnp.asarray(x)).shape[1:]))
    y = np.random.RandomState(5).randint(0, n_out, 2).astype(np.int32)
    _check_step(jm, tm, x, y)


@pytest.mark.parametrize("depth", [18, 50])
def test_imagenet_trees_match_jax(depth):
    """Init only, no forward: the port's params and state trees have
    the JAX package's keys and shapes, and ResNet-50 counts the
    canonical 25.56M parameters (tests/test_models.py:37-40)."""
    jv = jax.eval_shape(jresnet.build_imagenet(depth, 1000).init, KEY)
    tv = tresnet.build_imagenet(depth, 1000).init(device="cpu")
    for part in ("params", "state"):
        jl = [(tuple(k.key for k in p), a.shape) for p, a in
              jax.tree_util.tree_leaves_with_path(jv[part])]
        tl = [(p, tuple(a.shape)) for p, a in
              tree_leaves_with_path(tv[part])]
        assert tl == jl, part
    n = sum(t.numel() for t in tree_leaves(tv["params"]))
    if depth == 50:
        assert 25.0e6 < n < 26.1e6
    assert all(t.dtype == torch.float32 for t in tree_leaves(tv))


def test_zero_gamma_init():
    """The port's own init: every block's last batch norm starts at
    gamma 0 (the others at 1), so at init a block returns
    ReLU(shortcut(x)) exactly."""
    block = tresnet.basic_block(16, 16)
    v = block.init(torch.Generator().manual_seed(0), "cpu")
    main = v["params"]["0_ConcatTable"]["0_Sequential"]
    assert torch.equal(main["4_SpatialBatchNormalization"]["weight"],
                       torch.zeros(16))
    assert torch.equal(main["1_SpatialBatchNormalization"]["weight"],
                       torch.ones(16))
    x = torch.randn(2, 6, 6, 16)
    y, _ = block.apply(v, x, training=True)
    assert torch.equal(y, torch.relu(x))
    model = tresnet.build_imagenet(50, 10)
    gammas = [leaf for path, leaf in tree_leaves_with_path(
        model.init(device="cpu")["params"]) if path[-1] == "weight"
        and leaf.ndim == 1]
    assert sum(bool((g == 0).all()) for g in gammas) == 16  # 3+4+6+3 blocks


def _recorder(trigger_cls, out, steps):
    def fn(state):
        if state["loss"] is not None:
            out.append(float(state["loss"]))
        return state["neval"] >= steps
    return trigger_cls(fn)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("model", ["lenet", "cifar8"])
def test_optimize_trajectory_matches_jax(model, precision):
    if model == "lenet":
        jm, tm = jlenet.build(10), tlenet.build(10)
        jdata, tdata = jmnist(24, seed=3), tmnist(24, seed=3)
    else:
        jm, tm = jresnet.build_cifar(8, 10), tresnet.build_cifar(8, 10)
        jdata, tdata = jcifar(24, seed=3), tcifar(24, seed=3)
    jv = _seeded(jm, 6)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, jv)
    tm.variables = variables_from_jax(jv, device="cpu")
    losses = {}
    for pkg, m, opt, nn, data, ds in (
            ("jax", jm, jopt, jnn, jdata, JDataSet),
            ("torch", tm, topt, tnn, tdata, TDataSet)):
        losses[pkg] = []
        opt.Optimizer(m, ds.array(data), nn.ClassNLLCriterion(),
                      batch_size=8) \
            .set_optim_method(opt.SGD(0.05, momentum=0.9)) \
            .set_precision(precision) \
            .set_end_when(_recorder(opt.Trigger, losses[pkg], 3)) \
            .optimize()
    assert len(losses["torch"]) == len(losses["jax"]) == 3
    tol = TRAJ_TOL[precision]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=0,
                               atol=tol)
    for a, b in zip(tree_leaves(tm.variables),
                    jax.tree_util.tree_leaves(jm.variables)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=0, atol=tol)


def _jax_perf_keys():
    """The keys of the dict the JAX package's run_perf returns, read
    from its source (running it would compile the JAX LeNet step)."""
    tree = ast.parse(inspect.getsource(jperf.run_perf))
    (ret,) = [n.value for n in ast.walk(tree)
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return [k.value for k in ret.keys]


def test_run_perf_returns_the_jax_keys():
    res = tperf.run_perf("lenet", 8, 2, device="cpu")
    assert list(res) == _jax_perf_keys()
    assert res["model"] == "lenet" and res["batch_size"] == 8 \
        and res["iterations"] == 2
    assert res["compile_s"] > 0 and res["steady_wall_s"] > 0
    assert res["images_per_sec"] == pytest.approx(16 / res["steady_wall_s"])
