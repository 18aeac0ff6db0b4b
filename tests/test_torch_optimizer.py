"""The port's training loop (bigdl_tpu_torch/optim/optimizer.py) against
the JAX package's `Optimizer(...).optimize()` on the tiny LM (vocab 61,
dim 32, 2 heads, 2 layers, S=32, batch 4) over the same synthetic data
and the same weights (`models/convert.params_from_jax`).

Tolerances: the 5-step loss trajectory within 1e-4 in fp32 (and the
trained weights within 1e-4); under DEFAULT_MIXED (bf16 compute, fp32
master weights) within 2e-2 — the two frameworks round bf16 at
different places (the port scores attention in fp32 from bf16
operands, as the Pallas kernel does; the JAX reference rounds the
scores to bf16)."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.text import synthetic_next_token as jsyn
from bigdl_tpu.models.transformer import build_lm as jlm
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.text import synthetic_next_token as tsyn
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)

CFG = dict(vocab_size=61, dim=32, num_heads=2, num_layers=2, max_len=32)
STEPS = 5


def tlm(device="cpu", **cfg):
    return TransformerLM(TransformerConfig(**cfg), device=device)
TOL = {"fp32": 1e-4, "bf16": 2e-2}

RUNS = {  # name: (precision, method factory, builder tweaks)
    "adam_fp32": ("fp32", lambda m: m.Adam(1e-2), {}),
    "adam_mixed": ("bf16", lambda m: m.Adam(1e-2), {}),
    "sgd_clip_l2": ("fp32", lambda m: m.SGD(0.5, momentum=0.9),
                    {"set_gradient_clipping_by_l2_norm": (0.05,)}),
    "adam_clip_const": ("fp32", lambda m: m.Adam(1e-2),
                        {"set_constant_gradient_clipping": (-1e-3, 1e-3)}),
}


def _recorder(trigger_cls, out):
    """An end trigger that stops after STEPS and records each step's
    loss (the loop stores it in train_state before the next check)."""
    def fn(state):
        if state["loss"] is not None:
            out.append(float(state["loss"]))
        return state["neval"] >= STEPS
    return trigger_cls(fn)


def _run(pkg, model, name):
    precision, method, tweaks = RUNS[name]
    if pkg == "jax":
        o = jopt.Optimizer(model, JDataSet.array(jsyn(24, 61, 32)),
                           jnn.ChunkedSoftmaxCE(chunk=8), batch_size=4)
        m, trig = jopt, jopt.Trigger
    else:
        o = topt.Optimizer(model, TDataSet.array(tsyn(24, 61, 32)),
                           tnn.ChunkedSoftmaxCE(chunk=8), batch_size=4)
        m, trig = topt, topt.Trigger
    losses = []
    o.set_optim_method(method(m)).set_precision(precision) \
        .set_end_when(_recorder(trig, losses))
    for setter, args in tweaks.items():
        getattr(o, setter)(*args)
    trained = o.optimize()
    return losses, trained


@pytest.mark.parametrize("name", sorted(RUNS))
def test_optimize_trajectory_matches_jax(name):
    jm = jlm(**CFG).build(jax.random.PRNGKey(0))
    tm = tlm(**CFG, device="cpu")
    tm.variables = {"params": params_from_jax(
        jax.device_get(jm.variables["params"]), device="cpu"),
        "state": {}}
    before = [t.clone() for t in tree_leaves(tm.variables["params"])]
    jl, jm = _run("jax", jm, name)
    tl, tm2 = _run("torch", tm, name)
    assert tm2 is tm and len(tl) == len(jl) == STEPS
    tol = TOL[RUNS[name][0]]
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=0)
    after = tree_leaves_with_path(tm.variables["params"])
    assert not any(torch.equal(a, b) for (_, a), b in zip(after, before))
    if RUNS[name][0] == "fp32":
        for (path, a), b in zip(
                after, jax.tree_util.tree_leaves(jm.variables["params"])):
            if path == ("blocks", "bk"):
                # the key bias's gradient is zero in exact arithmetic
                # (softmax is shift-invariant): both packages train it on
                # rounding noise, which Adam scales up to lr-sized steps
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=0, err_msg=str(path))


@pytest.mark.parametrize("setter, args, what", [
    ("set_mesh", (None,), "distributed training"),
])
def test_unported_features_name_what_is_missing(setter, args, what):
    o = topt.Optimizer(tlm(**CFG, device="cpu"), TDataSet.array([]),
                       tnn.ChunkedSoftmaxCE())
    with pytest.raises(NotImplementedError, match=what) as err:
        getattr(o, setter)(*args)
    assert "ROADMAP.md" in str(err.value) and "A.8" in str(err.value)


def _opt(n=0):
    return topt.Optimizer(tlm(**CFG, device="cpu"),
                          TDataSet.array(tsyn(n, 61, 32)),
                          tnn.ChunkedSoftmaxCE(chunk=8), batch_size=4)


def test_set_checkpoint_builds_a_checkpoint(tmp_path):
    from bigdl_tpu_torch.serialization import Checkpoint

    o = _opt()
    trig = topt.Trigger.several_iteration(3)
    assert o.set_checkpoint(str(tmp_path / "ck"), trig,
                            async_save=True) is o
    assert isinstance(o.checkpoint, Checkpoint)
    assert o.checkpoint.path == str(tmp_path / "ck")
    assert o.checkpoint.async_save and o.checkpoint_trigger is trig
    assert (tmp_path / "ck").is_dir()


def test_set_checkpoint_sharded_names_a8(tmp_path):
    with pytest.raises(NotImplementedError, match="A.8"):
        _opt().set_checkpoint(str(tmp_path), topt.Trigger.every_epoch(),
                              sharded=True)


def test_resume_from_checkpoint_without_one_starts_fresh(tmp_path):
    """Resume is a request: with no checkpoint under the path the run
    starts at step 0 and saves its own."""
    o = _opt(8).set_checkpoint(str(tmp_path),
                               topt.Trigger.several_iteration(1))
    assert o.resume_from_checkpoint() is o
    seen = []
    o.set_end_when(topt.Trigger(lambda s: seen.append(s["neval"])
                                or s["neval"] >= 1)).optimize()
    assert seen == [0, 1]
    assert (tmp_path / "checkpoint-1" / "COMPLETE").exists()


def test_set_gradient_accumulation_checks_n():
    o = _opt()
    with pytest.raises(ValueError, match=">= 1"):
        o.set_gradient_accumulation(0)
    assert o.set_gradient_accumulation(4) is o and o.grad_accum == 4


def test_set_anomaly_guard_types():
    from bigdl_tpu_torch.utils.anomaly import AnomalyGuard

    o = _opt()
    assert o.set_anomaly_guard("rollback", max_consecutive=2) is o
    assert isinstance(o.anomaly_guard, AnomalyGuard)
    assert (o.anomaly_guard.policy, o.anomaly_guard.max_consecutive) == (
        "rollback", 2)
    g = AnomalyGuard("halt")
    assert o.set_anomaly_guard(g).anomaly_guard is g
    with pytest.raises(TypeError, match="AnomalyGuard"):
        o.set_anomaly_guard(3)
    with pytest.raises(ValueError, match="kwargs"):
        o.set_anomaly_guard(g, max_consecutive=2)
    with pytest.raises(ValueError, match="policy"):
        o.set_anomaly_guard("explode")
    assert o.set_anomaly_guard(None).anomaly_guard is None


@pytest.mark.parametrize("setter, suffix", [
    ("set_train_summary", "train"),
    ("set_validation_summary", "validation")])
def test_set_summary_takes_a_path_or_a_summary(tmp_path, setter, suffix):
    from bigdl_tpu_torch import visualization as vis

    o = _opt()
    assert getattr(o, setter)(str(tmp_path)) is o
    summary = getattr(o, suffix + "_summary")
    assert summary.log_dir == str(tmp_path / "bigdl_tpu_torch" / suffix)
    mine = vis.TrainSummary(str(tmp_path), "mine")
    assert getattr(getattr(o, setter)(mine), suffix + "_summary") is mine
    with pytest.raises(TypeError, match="or a logdir string"):
        getattr(o, setter)(object())


def test_precision_strings_and_refusals():
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    o = topt.Optimizer(tlm(**CFG, device="cpu"), TDataSet.array([]),
                       tnn.ChunkedSoftmaxCE())
    assert o.set_precision("bf16").precision is DEFAULT_MIXED
    assert o.set_precision("fp32").precision is None
    with pytest.raises(TypeError):
        o.set_precision(torch.bfloat16)


def test_samples_need_a_batch_size():
    o = topt.Optimizer(tlm(**CFG, device="cpu"),
                       TDataSet.array(tsyn(4, 61, 32)),
                       tnn.ChunkedSoftmaxCE())
    with pytest.raises(ValueError, match="batch_size is required"):
        o.optimize()


def test_mixed_precision_keeps_fp32_masters():
    """Under DEFAULT_MIXED the forward runs in bf16 and the master
    weights, their gradients and the Adam slots stay fp32."""
    tm = tlm(**CFG, device="cpu")
    tm.build(torch.Generator().manual_seed(0))
    losses = []
    topt.Optimizer(tm, TDataSet.array(tsyn(8, 61, 32)),
                   tnn.ChunkedSoftmaxCE(chunk=8), batch_size=4) \
        .set_optim_method(topt.Adam(1e-2)).set_precision("bf16") \
        .set_end_when(_recorder(topt.Trigger, losses)).optimize()
    assert all(t.dtype == torch.float32
               for t in tree_leaves(tm.variables["params"]))
    assert all(np.isfinite(losses)) and len(losses) == STEPS
