"""Data-parallel training of the port (bigdl_tpu_torch/parallel/) on gloo
ranks against the JAX package's DistriOptimizer on a mesh of the first
n of the 8 CPU devices that tests/conftest.py forces — the cases of
tests/test_distributed.py and tests/test_zero2.py, at world size 2 here
and 4 in test_torch_distributed_w4.py.

Each world size spawns its ranks once (parallel/launch.spawn: a
`file://` rendezvous in the test's temporary directory, one thread a
rank); `_scenarios` runs every port case there and returns the results,
which the tests hold against the JAX package computed in this process.
This module imports JAX only inside its tests and fixtures: each rank
imports it to find `_scenarios`.

Tolerances (fp32): the exact gradient wire 2e-5 relative / 1e-6
absolute against JAX; the bf16 wire 2e-3 absolute (a gradient rounds to
bf16 on both sides, and the two frameworks' fp32 gradients can round to
neighbouring bf16 values); sync batch norm 1e-5; validation results
1e-5. Inside the port, ZeRO-2 equals ZeRO-1 and a recovered run its
uninterrupted run bit for bit.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

EXACT = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=0, atol=2e-3)
N_SAMPLES, BATCH, STEPS, LR = 64, 16, 4, 0.5


# ------------------------------------------------ shared, JAX-free setup
def _data():
    rng = np.random.RandomState(1)
    return (rng.rand(N_SAMPLES, 6).astype(np.float32),
            rng.randint(0, 4, N_SAMPLES).astype(np.int32))


def _val_data():
    rng = np.random.RandomState(2)
    return (rng.rand(37, 6).astype(np.float32),
            rng.randint(0, 4, 37).astype(np.int32))


def _init_np():
    """The MLP's initial params (numpy), fed to both packages."""
    from bigdl_tpu_torch.models.convert import tree_map

    m = _port_mlp()
    v = m.init(torch.Generator().manual_seed(5), device="cpu")
    return tree_map(lambda t: t.numpy().copy(), v["params"])


def _port_mlp():
    from bigdl_tpu_torch import nn

    return nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4),
                         nn.LogSoftMax())


def _flat(params) -> np.ndarray:
    from bigdl_tpu_torch.models.convert import tree_leaves

    return np.concatenate([np.asarray(t, np.float32).reshape(-1)
                           for t in tree_leaves(params)])


# ------------------------------------------------------ the rank's side
def _port_opt(init, batch=BATCH, steps=STEPS, clip=None, val=None):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models.convert import params_from_jax

    xs, ys = _data()
    m = _port_mlp()
    m.variables = {"params": params_from_jax(init, device="cpu"),
                   "state": m.init_state()}
    opt = (optim.Optimizer(m, DataSet.array(
        [Sample(x, int(y)) for x, y in zip(xs, ys)], seed=7),
        nn.ClassNLLCriterion(), batch_size=batch, seed=3)
           .set_optim_method(optim.SGD(learningrate=LR, momentum=0.9,
                                       dampening=0.0))
           .set_end_when(optim.Trigger.max_iteration(steps)))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if val is not None:
        opt.set_validation(optim.Trigger.max_iteration(steps), val,
                           [optim.Top1Accuracy(),
                            optim.Loss(nn.ClassNLLCriterion())], BATCH)
    return opt


def _distri(mesh, init, wire=None, zero=1, **kw):
    from bigdl_tpu_torch.parallel import DistriOptimizer

    opt = _port_opt(init, **kw)
    m = DistriOptimizer(opt, mesh, grad_dtype=wire, zero=zero).run()
    return _flat(m.variables["params"]), opt


def _steps(mesh, init, wire, zero, n, momentum=0.9):
    """`n` make_dp_train_step steps on the first batch; returns the full
    flat params and this rank's velocity slot."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.convert import params_from_jax
    from bigdl_tpu_torch.parallel import (FlatParamSpec, host_to_global,
                                          make_dp_train_step)
    from bigdl_tpu_torch.parallel.data_parallel import _all_gather

    xs, ys = _data()
    world = mesh.shape["data"]
    params = params_from_jax(init, device="cpu")
    spec = FlatParamSpec(params, world)
    method = optim.SGD(learningrate=0.1, momentum=momentum, dampening=0.0)
    step = make_dp_train_step(_port_mlp(), nn.ClassNLLCriterion(), method,
                              mesh, spec, grad_dtype=wire, zero=zero)
    w = spec.flatten(params)
    if zero == 2:
        w = spec.shard_slice(w, mesh.rank).clone()
    slots = method.init_slots([torch.zeros(spec.shard_size)])
    state = _port_mlp().init_state()
    bx, by = host_to_global(mesh, xs[:32]), host_to_global(mesh, ys[:32])
    for i in range(n):
        w, slots, state, loss = step(w, slots, state, bx, by, 0.1, i, None)
    full = _all_gather(w, world, None) if zero == 2 else w
    return full.numpy(), {k: v[0].numpy() for k, v in slots.items()}


def _accum(mesh, init):
    """One 32-row step against 2 micro-steps of 16 + apply (exact)."""
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models.convert import params_from_jax
    from bigdl_tpu_torch.parallel import (FlatParamSpec, host_to_global,
                                          make_dp_accum_steps,
                                          make_dp_train_step)

    xs, ys = _data()
    params = params_from_jax(init, device="cpu")
    spec = FlatParamSpec(params, mesh.shape["data"])
    method = optim.SGD(learningrate=0.1)
    model, crit = _port_mlp(), nn.ClassNLLCriterion()
    step = make_dp_train_step(model, crit, method, mesh, spec,
                              grad_dtype=None)
    state = model.init_state()
    big, _, _, _ = step(spec.flatten(params), {}, state,
                        host_to_global(mesh, xs[:32]),
                        host_to_global(mesh, ys[:32]), 0.1, 0, None)
    micro, apply = make_dp_accum_steps(model, crit, method, mesh, spec,
                                       grad_dtype=None)
    w, acc = spec.flatten(params), torch.zeros(spec.shard_size)
    for lo in (0, 16):
        acc, _, _ = micro(w, acc, state, host_to_global(mesh, xs[lo:lo + 16]),
                          host_to_global(mesh, ys[lo:lo + 16]), None)
    new, _, acc = apply(w, {}, acc, 0.1, 0, 2.0)
    return big.numpy(), new.numpy(), float(acc.abs().max())


def _reduce_state_case(mesh):
    from bigdl_tpu_torch.parallel.data_parallel import _reduce_state

    i = torch.tensor(float(mesh.rank))
    tree = {"bn_mean": i, "_counter": i.clone(), "step": i.clone(),
            "nested": {"_hidden": i.clone(), "var": i.clone()},
            "sub": {"step": {"running_mean": i.clone()}}, "counter": i,
            "_private": {"anything": i.clone()}, "ids": torch.tensor(3)}
    red = _reduce_state(tree, mesh, mesh.shape["data"])
    return {"bn_mean": float(red["bn_mean"]),
            "var": float(red["nested"]["var"]),
            "sub_running_mean": float(red["sub"]["step"]["running_mean"]),
            "_counter": float(red["_counter"]), "step": float(red["step"]),
            "_hidden": float(red["nested"]["_hidden"]),
            "counter": float(red["counter"]),
            "anything": float(red["_private"]["anything"]),
            "ids": int(red["ids"])}


def _bn_x():
    return (np.random.RandomState(4).randn(16, 4, 4, 3) * 3.0 + 1.0
            ).astype(np.float32)


def _sync_bn_case(mesh):
    """Sync BN over this rank's rows: output rows, new running stats and
    the gradients of sum(sin(out) * w) (x rows, weight, bias)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import sharded

    bn = nn.SpatialBatchNormalization(3, sync=True)
    v = bn.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor(sharded(mesh, _bn_x())).requires_grad_()
    w = torch.tensor(sharded(mesh, np.random.RandomState(5).randn(
        16, 4, 4, 3).astype(np.float32)))
    params = {k: t.clone().requires_grad_() for k, t in v["params"].items()}
    out, state = bn.apply({"params": params, "state": v["state"]}, x,
                          training=True)
    gx, gw, gb = torch.autograd.grad((torch.sin(out) * w).sum(),
                                     [x, params["weight"], params["bias"]])
    return {"out": out.detach().numpy(), "gx": gx.numpy(),
            "gw": gw.numpy(), "gb": gb.numpy(),
            "running_mean": state["running_mean"].numpy(),
            "running_var": state["running_var"].numpy()}


def _eval_case(mesh, init):
    """Validation inside DistriOptimizer after one step at learning rate
    0 (the initial weights): 37 samples at batch 16 (a ragged last
    batch), and pre-batched MiniBatches of 10 rows, which the loop pads
    to a multiple of the axis — Top1Accuracy and Loss."""
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample
    from bigdl_tpu_torch.parallel import DistriOptimizer

    xs, ys = _val_data()
    samples = [Sample(x, int(y)) for x, y in zip(xs, ys)]
    mbs = [MiniBatch.from_samples(samples[i:min(i + 10, 25)], pad_to=10)
           for i in range(0, 25, 10)]
    out = {}
    for name, val in (("ragged", DataSet.array(samples)),
                      ("batched", DataSet.array(mbs))):
        opt = _port_opt(init, steps=1, val=val)
        opt.optim_method.learningrate = 0.0
        DistriOptimizer(opt, mesh, grad_dtype=None).run()
        out[name] = {k: r.result()
                     for k, r in opt.train_state["validation"].items()}
    return out


def _recover_case(mesh, init, workdir):
    """step@4 injected with a checkpoint every 3 steps: the run recovers
    from checkpoint 3 and ends bit for bit the uninterrupted run."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import faults

    clean, _ = _distri(mesh, init, steps=6)
    ck = os.path.join(workdir, "ck_recover")
    opt = _port_opt(init, steps=6).set_checkpoint(
        ck, optim.Trigger.several_iteration(3))
    faults.set_plan(faults.FaultPlan("step@4"))
    try:
        m = DistriOptimizer(opt, mesh, grad_dtype=None).run()
        fired = list(faults.get_plan().fired)
    finally:
        faults.set_plan(None)
    return clean, _flat(m.variables["params"]), fired


def _resume_case(mesh, init, jax_ck, steps):
    """Resume the JAX package's 4-device zero1_flat checkpoint here."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.parallel import DistriOptimizer

    opt = _port_opt(init, steps=steps).set_checkpoint(
        jax_ck, optim.Trigger.several_iteration(10 ** 6)) \
        .resume_from_checkpoint()
    m = DistriOptimizer(opt, mesh, grad_dtype=None).run()
    return _flat(m.variables["params"]), opt.train_state["neval"]


def _bad_batch_case(mesh, init):
    from bigdl_tpu_torch.parallel import DistriOptimizer

    try:
        DistriOptimizer(_port_opt(init, batch=BATCH - 1), mesh).run()
    except ValueError as e:
        return str(e)
    return None


def _scenarios(rank, world, init, workdir, jax_ck=None, resume_steps=0):
    from bigdl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": world}, device="cpu")
    assert (mesh.rank, mesh.backend) == (rank, "gloo")
    r = {"jax_free": not any(m.split(".")[0] in ("jax", "bigdl_tpu")
                             for m in sys.modules)}
    for wire in (None, "bfloat16"):
        key = "exact" if wire is None else "bf16"
        r[f"step1/{key}"] = _steps(mesh, init, wire, 1, 1, momentum=0.0)[0]
        r[f"zero1/{key}"] = _steps(mesh, init, wire, 1, 3)
        r[f"zero2/{key}"] = _steps(mesh, init, wire, 2, 3)
        r[f"distri/{key}"] = _distri(mesh, init, wire)[0]
    r["distri/zero2"] = _distri(mesh, init, "bfloat16", zero=2)[0]
    r["distri/clip"] = _distri(mesh, init, None, clip=0.05)[0]
    acc_opt = _port_opt(init, batch=BATCH // 2, steps=2 * STEPS)
    acc_opt.set_gradient_accumulation(2)
    from bigdl_tpu_torch.parallel import DistriOptimizer

    r["distri/accum2"] = _flat(DistriOptimizer(
        acc_opt, mesh, grad_dtype=None).run().variables["params"])
    r["accum"] = _accum(mesh, init)
    r["reduce_state"] = _reduce_state_case(mesh)
    r["sync_bn"] = _sync_bn_case(mesh)
    r["eval"] = _eval_case(mesh, init)
    r["bad_batch"] = _bad_batch_case(mesh, init)
    r["recover"] = _recover_case(mesh, init, workdir)
    if jax_ck is not None:
        r["resume"] = _resume_case(mesh, init, jax_ck, resume_steps)
    return r


# ------------------------------------------------------ the JAX side
def _jax_mesh(world):
    import jax

    from bigdl_tpu.parallel import make_mesh

    return make_mesh({"data": world}, devices=jax.devices()[:world])


def _jax_mlp(init):
    """The JAX MLP with `init` as its variables (its own, empty, state
    tree)."""
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import nn

    m = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4),
                      nn.LogSoftMax())
    state = jax.eval_shape(m.init, jax.random.PRNGKey(0))["state"]
    m.variables = {"params": jax.tree_util.tree_map(jnp.asarray, init),
                   "state": state}
    return m


def _jax_opt(init, batch=BATCH, steps=STEPS, clip=None):
    from bigdl_tpu import nn, optim
    from bigdl_tpu.dataset import DataSet, Sample

    xs, ys = _data()
    m = _jax_mlp(init)
    opt = (optim.Optimizer(m, DataSet.array(
        [Sample(x, int(y)) for x, y in zip(xs, ys)], seed=7),
        nn.ClassNLLCriterion(), batch_size=batch, seed=3)
           .set_optim_method(optim.SGD(learningrate=LR, momentum=0.9,
                                       dampening=0.0))
           .set_end_when(optim.Trigger.max_iteration(steps)))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    return opt


def jax_distri(world, init, wire=None, **kw):
    from bigdl_tpu.parallel import DistriOptimizer

    opt = _jax_opt(init, **kw)
    m = DistriOptimizer(opt, _jax_mesh(world), grad_dtype=wire).run()
    return _flat(m.variables["params"])


def jax_dp_step(world, init, momentum_steps=0):
    """One exact-wire make_dp_train_step of SGD(0.1) on the first 32
    rows (momentum 0), or 3 momentum steps; (flat params, velocity)."""
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import nn, optim
    from bigdl_tpu.parallel import FlatParamSpec, make_dp_train_step

    xs, ys = _data()
    m = _jax_mlp(init)
    params, state = m.variables["params"], m.variables["state"]
    spec = FlatParamSpec(params, world)
    method = optim.SGD(learningrate=0.1, momentum=0.9 if momentum_steps
                       else 0.0, dampening=0.0)
    step = make_dp_train_step(m, nn.ClassNLLCriterion(), method,
                              _jax_mesh(world), spec, grad_dtype=None)
    w = spec.flatten(params)
    slots = method.init_slots(jnp.zeros((spec.padded,)))
    for i in range(max(1, momentum_steps)):
        w, slots, _, _ = step(w, slots, state, jnp.asarray(xs[:32]),
                              jnp.asarray(ys[:32]),
                              jnp.asarray(0.1, jnp.float32),
                              jnp.asarray(i, jnp.int32),
                              jax.random.PRNGKey(0))
    return np.asarray(w), {k: np.asarray(v) for k, v in slots.items()}


def jax_full_batch_bn():
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import nn

    bn = nn.SpatialBatchNormalization(3)
    v = bn.init(jax.random.PRNGKey(0))
    x = jnp.asarray(_bn_x())
    w = jnp.asarray(np.random.RandomState(5).randn(16, 4, 4, 3)
                    .astype(np.float32))

    def loss(x, p):
        out, _ = bn.apply({"params": p, "state": v["state"]}, x,
                          training=True)
        return jnp.sum(jnp.sin(out) * w)

    out, state = bn.apply(v, x, training=True)
    gx, gp = jax.grad(loss, argnums=(0, 1))(x, v["params"])
    return {"out": np.asarray(out), "gx": np.asarray(gx),
            "gw": np.asarray(gp["weight"]), "gb": np.asarray(gp["bias"]),
            "running_mean": np.asarray(state["running_mean"]),
            "running_var": np.asarray(state["running_var"])}


def jax_local_eval(init):
    from bigdl_tpu import nn
    from bigdl_tpu.dataset import DataSet, Sample
    from bigdl_tpu.optim import Evaluator, Loss, Top1Accuracy

    xs, ys = _val_data()
    m = _jax_mlp(init)
    out = {}
    for name, n, bs in (("ragged", 37, BATCH), ("batched", 25, 10)):
        res = Evaluator(m).test(
            DataSet.array([Sample(x, int(y)) for x, y in
                           zip(xs[:n], ys[:n])]),
            [Top1Accuracy(), Loss(nn.ClassNLLCriterion())], bs)
        out[name] = {k: r.result() for k, r in res.items()}
    return out


def jax_checkpoint_run(init, ck, steps, resume=False):
    """The JAX package's DistriOptimizer on 4 devices (exact wire),
    checkpointing after step 4, optionally resuming."""
    from bigdl_tpu import optim
    from bigdl_tpu.parallel import DistriOptimizer

    opt = _jax_opt(init, steps=steps).set_checkpoint(
        ck, optim.Trigger.several_iteration(4))
    if resume:
        opt.resume_from_checkpoint()
    m = DistriOptimizer(opt, _jax_mesh(4), grad_dtype=None).run()
    return _flat(m.variables["params"])


def run_world(world, tmp_path_factory, with_resume):
    """Spawn `world` ranks over `_scenarios` (the JAX 4-device
    checkpoint first, when `with_resume`); returns (init, results,
    extras)."""
    from bigdl_tpu_torch.parallel.launch import spawn

    init = _init_np()
    base = tmp_path_factory.mktemp(f"dp{world}")
    extras = {}
    jax_ck = None
    if with_resume:
        jax_ck = str(base / "jax_ck")
        jax_checkpoint_run(init, jax_ck, 4)
        extras["local_ck"] = str(base / "local_ck")
        shutil.copytree(jax_ck, extras["local_ck"])
        extras["jax_resumed"] = jax_checkpoint_run(init, jax_ck, 6,
                                                   resume=True)
        # the copy the ranks resume from holds only checkpoint 4
        jax_ck = str(base / "rank_ck")
        shutil.copytree(extras["local_ck"], jax_ck)
    results = spawn(_scenarios, world, str(base / "spawn"), init,
                    str(base / "work"), jax_ck, 6)
    os.makedirs(base / "work", exist_ok=True)
    return init, results, extras


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return (2,) + run_world(2, tmp_path_factory, with_resume=True)


# ------------------------------------------------------------- the tests
# (test_torch_distributed_w4.py runs the same checks at world size 4)
def check_dp_matches_single_device_sgd(world, init, results):
    """DP with the mean gradient == one single-device step on the global
    batch (JAX, one device) == JAX's DP step on `world` devices."""
    single, _ = jax_dp_step(1, init)
    dp, _ = jax_dp_step(world, init)
    n = sum(a.size for a in _flat_leaves(init))
    for r in results:
        np.testing.assert_allclose(r["step1/exact"][:n], single[:n], **EXACT)
        np.testing.assert_allclose(r["step1/exact"], dp, **EXACT)
        np.testing.assert_allclose(r["step1/bf16"][:n], single[:n], **BF16)


def _flat_leaves(init):
    from bigdl_tpu_torch.models.convert import tree_leaves

    return tree_leaves(init)


def check_momentum_slots_stay_sharded(world, init, results):
    _, jslots = jax_dp_step(world, init, momentum_steps=3)
    full = np.concatenate([r["zero1/exact"][1]["velocity"]
                           for r in results])
    for r in results:
        v = r["zero1/exact"][1]["velocity"]
        assert v.shape == (full.size // world,)   # a slice, not a replica
        assert np.abs(v).sum() > 0 or np.abs(full).sum() > 0
    assert full.shape == jslots["velocity"].shape
    np.testing.assert_allclose(full, jslots["velocity"], **EXACT)


def check_zero2_bitwise_zero1(results):
    for r in results:
        for key in ("exact", "bf16"):
            np.testing.assert_array_equal(r[f"zero2/{key}"][0],
                                          r[f"zero1/{key}"][0])
            np.testing.assert_array_equal(
                r[f"zero2/{key}"][1]["velocity"],
                r[f"zero1/{key}"][1]["velocity"])
        np.testing.assert_array_equal(r["distri/zero2"], r["distri/bf16"])
    # every rank ends with the same weights
    for r in results[1:]:
        np.testing.assert_array_equal(r["distri/bf16"],
                                      results[0]["distri/bf16"])


def check_distri_matches_jax(world, init, results):
    exact = jax_distri(world, init, None)
    bf16 = jax_distri(world, init, "bfloat16")
    clip = jax_distri(world, init, None, clip=0.05)
    for r in results:
        np.testing.assert_allclose(r["distri/exact"], exact, **EXACT)
        np.testing.assert_allclose(r["distri/bf16"], bf16, **BF16)
        np.testing.assert_allclose(r["distri/clip"], clip, **EXACT)
    assert not np.allclose(clip, exact, rtol=1e-3)     # clipping bit


def check_accumulation(results):
    for r in results:
        big, acc, zero = r["accum"]
        np.testing.assert_allclose(acc, big, **EXACT)
        assert zero == 0.0
        # accumulating 2 x 8 rows == 16-row batches, end to end
        np.testing.assert_allclose(r["distri/accum2"], r["distri/exact"],
                                   rtol=1e-4, atol=1e-5)


def check_state_reduction(world, results):
    mean = (world - 1) / 2
    for rank, r in enumerate(results):
        red = r["reduce_state"]
        assert red["bn_mean"] == red["var"] == mean
        assert red["sub_running_mean"] == mean   # a subtree under 'step'
        for k in ("_counter", "step", "_hidden", "counter", "anything"):
            assert red[k] == rank, k
        assert red["ids"] == 3


def check_sync_bn(results):
    ref = jax_full_batch_bn()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["sync_bn"]["out"] for r in results]), ref["out"],
        **tol)
    np.testing.assert_allclose(
        np.concatenate([r["sync_bn"]["gx"] for r in results]), ref["gx"],
        **tol)
    np.testing.assert_allclose(sum(r["sync_bn"]["gw"] for r in results),
                               ref["gw"], **tol)
    np.testing.assert_allclose(sum(r["sync_bn"]["gb"] for r in results),
                               ref["gb"], **tol)
    for r in results:
        np.testing.assert_allclose(r["sync_bn"]["running_mean"],
                                   ref["running_mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["sync_bn"]["running_var"],
                                   ref["running_var"], **tol)


def check_uneven_eval(init, results):
    want = jax_local_eval(init)
    for r in results:
        for case in ("ragged", "batched"):
            for name, (v, cnt) in want[case].items():
                gv, gc = r["eval"][case][name]
                assert gc == cnt, (case, name, gc, cnt)
                np.testing.assert_allclose(gv, v, rtol=1e-5, atol=1e-6)


def check_recovery(results):
    for r in results:
        assert r["jax_free"]          # no rank imported JAX
        clean, recovered, fired = r["recover"]
        assert fired == [("step", 4)]
        np.testing.assert_array_equal(recovered, clean)


def test_dp_matches_single_device_sgd(w2):
    world, init, results, _ = w2
    check_dp_matches_single_device_sgd(world, init, results)


def test_momentum_slots_stay_sharded(w2):
    world, init, results, _ = w2
    check_momentum_slots_stay_sharded(world, init, results)


def test_zero2_bitwise_zero1(w2):
    check_zero2_bitwise_zero1(w2[2])


def test_distri_exact_bf16_and_clip_match_jax(w2):
    world, init, results, _ = w2
    check_distri_matches_jax(world, init, results)


def test_accumulation_equals_large_batch(w2):
    check_accumulation(w2[2])


def test_non_reducible_state_stays_local(w2):
    check_state_reduction(w2[0], w2[2])


def test_sync_bn_equals_full_batch_bn(w2):
    check_sync_bn(w2[2])


def test_uneven_eval_and_unbiased_loss(w2):
    check_uneven_eval(w2[1], w2[2])


def test_bad_batch_size_raises(w2):
    for r in w2[2]:
        assert r["bad_batch"] is not None and "divisible" in r["bad_batch"]


def test_recovery_after_injected_step_fault(w2):
    check_recovery(w2[2])


def test_jax_zero1_checkpoint_resumes_in_the_port(w2):
    """JAX's 4-device DistriOptimizer checkpoint (zero1_flat, padded for
    4) resumes in the port at world 2 (re-padded) and in the port's
    LocalOptimizer (unflattened); both continue within EXACT of the JAX
    run resumed from the same checkpoint."""
    from bigdl_tpu_torch import optim

    world, init, results, extras = w2
    want = extras["jax_resumed"]
    for r in results:
        got, neval = r["resume"]
        assert neval == 6
        np.testing.assert_allclose(got, want, **EXACT)
    opt = _port_opt(init, steps=6).set_checkpoint(
        extras["local_ck"], optim.Trigger.several_iteration(10 ** 6)) \
        .resume_from_checkpoint()
    opt.optimize()
    assert opt.train_state["neval"] == 6
    np.testing.assert_allclose(_flat(opt.model.variables["params"]), want,
                               **EXACT)


def test_make_mesh_axes_and_refusals():
    """parse_axes is the JAX package's; a one-rank data axis opens (and
    closes) its own gloo group on the CPU; a larger axis without a
    launched group, and an unknown axis, refuse by name; the axes of
    A.8 step 5 build (a one-rank world has every axis 1)."""
    import torch.distributed as dist
    from bigdl_tpu.parallel import parse_axes as jparse

    from bigdl_tpu_torch.parallel import make_mesh, parse_axes

    for spec in ("data=8", "data=4,model=2", " data = 2"):
        assert parse_axes(spec) == jparse(spec)
    with pytest.raises(ValueError, match="expected name=size"):
        parse_axes("data")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        make_mesh({"data": 1, "model": 2}, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_mesh({"data": 1, "tensor": 1}, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        make_mesh({"data": 2}, device="cpu")
    mesh = make_mesh({"model": 1, "seq": 1, "expert": 1, "pipe": 1},
                     device="cpu")
    try:
        assert mesh.shape == {"model": 1, "seq": 1, "expert": 1,
                              "pipe": 1, "data": 1}
        assert all(mesh.coord(a) == 0 and mesh.size_of(a) == 1
                   for a in mesh.shape)
    finally:
        mesh.close()
    assert not dist.is_initialized()
    mesh = make_mesh({"data": 1}, device="cpu")
    try:
        assert (mesh.shape, mesh.rank, mesh.backend) == ({"data": 1}, 0,
                                                         "gloo")
        assert dist.is_initialized()
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_perf_mesh_runs_the_dp_step_and_closes_its_group():
    """`models/perf.py --mesh data=1`: the data-parallel step on a
    one-rank gloo mesh, the group destroyed after the timing; its loss
    is the local train_step's on the same seeded batch (step 0: the same
    weights, exact arithmetic up to the flat layout)."""
    import torch.distributed as dist

    from bigdl_tpu_torch.models import perf

    out = perf.run_perf("lenet", 8, 1, mesh_axes="data=1", device="cpu")
    assert out["images_per_sec"] > 0 and out["iterations"] == 1
    assert not dist.is_initialized()
    step = perf.dp_train_step("lenet", 8, "data=1", device="cpu")
    try:
        dp0 = float(step(0))
    finally:
        step.mesh.close()
    local0 = float(perf.train_step("lenet", 8, device="cpu")(0))
    np.testing.assert_allclose(dp0, local0, rtol=1e-6)
    with pytest.raises(SystemExit, match="no 'data' axis"):
        perf.run_perf("lenet", 8, 1, mesh_axes="model=1", device="cpu")
