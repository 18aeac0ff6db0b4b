"""Gradient accumulation, checkpoint and resume, and the anomaly guard
in the port's training loop (bigdl_tpu_torch/optim/optimizer.py)
against the JAX package's (bigdl_tpu/optim/optimizer.py), on the
float-input MLP of tests/test_accum_resume.py (Linear(6, 16) -> ReLU ->
Linear(16, 4) -> LogSoftMax, batch 8, Adam(1e-2)) with the JAX model's
weights carried into the port.

Tolerances: across the packages, per-step losses and final params
within 1e-5 (fp32: the same arithmetic in another order, the mean of
the micro-gradients summed in fp32 and divided once by both); the
train-state clocks (`neval`, `nupdates`) exactly. Inside the port,
resume and the guard's discards are held bit for bit, as the JAX
package holds itself: a resumed, rolled-back or skip_step run equals
the uninterrupted run, params compared with `torch.equal`. Batch 4
accumulated twice equals batch 8 within 1e-5 (tests/test_optim.py:246's
check). The fault plan is process-global: every test leaves it unset."""

import logging

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.sample import Sample as TSample
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves
from bigdl_tpu_torch.utils import anomaly as tanomaly
from bigdl_tpu_torch.utils import faults as tfaults

TOL = 1e-5
PKG = {"jax": (jnn, jopt, JDataSet, JSample, jfaults),
       "torch": (tnn, topt, TDataSet, TSample, tfaults)}
_WEIGHTS = {}


@pytest.fixture(autouse=True)
def _no_plan():
    jfaults.set_plan(None)
    tfaults.set_plan(None)
    try:
        yield
    finally:
        jfaults.set_plan(None)
        tfaults.set_plan(None)


def _samples(cls, n=64, dim=6, classes=4, seed=11):
    rng = np.random.RandomState(seed)
    return [cls(rng.rand(dim).astype(np.float32),
                int(rng.randint(0, classes))) for _ in range(n)]


def _model(pkg):
    """The MLP, with the JAX model's weights (PRNGKey(3)) in both."""
    nn_ = PKG[pkg][0]
    m = nn_.Sequential(nn_.Linear(6, 16), nn_.ReLU(), nn_.Linear(16, 4),
                       nn_.LogSoftMax())
    if pkg == "jax":
        return m.build(jax.random.PRNGKey(3))
    if not _WEIGHTS:
        _WEIGHTS.update(jax.device_get(_model("jax").variables["params"]))
    m.variables = {"params": params_from_jax(_WEIGHTS, device="cpu"),
                   "state": m.init_state()}
    return m


def _flat(model):
    return np.concatenate([np.ravel(np.asarray(
        a.detach() if isinstance(a, torch.Tensor) else a))
        for _, a in model.parameters()])


def _run(pkg, end, accum=4, ckpt=None, ckpt_every=6, resume=False,
         guard=None, plan=None, batch=8, method=None, record=None,
         n=64, async_save=False):
    """One Optimizer(...).optimize() of the MLP; `record` gets each
    loop check's (neval, nupdates, loss)."""
    nn_, opt_, ds, sample, faults = PKG[pkg]
    stop = opt_.Trigger.max_iteration(end)

    def end_when(state):
        if record is not None:
            record.append((state["neval"], state["nupdates"],
                           None if state["loss"] is None
                           else float(state["loss"])))
        return stop(state)

    o = (opt_.Optimizer(_model(pkg), ds.array(_samples(sample, n)),
                        nn_.ClassNLLCriterion(), batch_size=batch)
         .set_optim_method(method(opt_) if method
                           else opt_.Adam(learningrate=1e-2))
         .set_end_when(opt_.Trigger(end_when)))
    if accum > 1:
        o.set_gradient_accumulation(accum)
    if ckpt is not None:
        o.set_checkpoint(str(ckpt), opt_.Trigger.several_iteration(
            ckpt_every), async_save=async_save)
    if resume:
        o.resume_from_checkpoint()
    if guard is not None:
        o.set_anomaly_guard(guard)
    faults.set_plan(faults.FaultPlan(plan or ""))
    try:
        return o.optimize(), o
    finally:
        faults.set_plan(None)


def _clock(record):
    return [(n, u) for n, u, _ in record]


def _losses(record):
    return [v for _, _, v in record if v is not None]


# ---------------------------------------------------------- accumulation

def test_accum4_trajectory_matches_jax():
    """10 micro-batches with accumulation 4: updates after 4 and 8, the
    end-of-run flush of 9-10."""
    rj, rt = [], []
    mj, _ = _run("jax", 10, record=rj)
    mt, _ = _run("torch", 10, record=rt)
    assert _clock(rt) == _clock(rj)
    assert _clock(rt)[-1] == (10, 2)
    np.testing.assert_allclose(_losses(rt), _losses(rj), rtol=0, atol=TOL)
    np.testing.assert_allclose(_flat(mt), _flat(mj), rtol=0, atol=TOL)


def test_end_of_run_flush():
    """The end trigger fires mid-cycle (6 of 4 + 2): the pending two
    micro-batches' mean is applied, as the JAX package applies it, and
    `nupdates` does not count the flush."""
    rj, rt = [], []
    mj, _ = _run("jax", 6, record=rj)
    mt, _ = _run("torch", 6, record=rt)
    assert _clock(rt) == _clock(rj) and _clock(rt)[-1] == (6, 1)
    np.testing.assert_allclose(_flat(mt), _flat(mj), rtol=0, atol=TOL)
    four, _ = _run("torch", 4)
    assert not np.array_equal(_flat(four), _flat(mt))


def test_accum2_over_batch4_equals_batch8():
    """Two micro-batches of 4 accumulated == one batch of 8: the same
    samples, mean-reduced criterion, gradients averaged once."""
    big, _ = _run("torch", 4, accum=1, batch=8, n=32,
                  method=lambda m: m.SGD(learningrate=0.5))
    small, _ = _run("torch", 8, accum=2, batch=4, n=32,
                    method=lambda m: m.SGD(learningrate=0.5))
    np.testing.assert_allclose(_flat(small), _flat(big), rtol=0, atol=TOL)


# ---------------------------------------------------------------- resume

@pytest.mark.parametrize("async_save", [False, True])
def test_midcycle_resume_bitwise(tmp_path, async_save):
    """Checkpoint at 6 (micro-batches 5 and 6 pending) then resume to
    10: equal to the uninterrupted run bit for bit."""
    ref, _ = _run("torch", 10)
    _run("torch", 6, ckpt=tmp_path, async_save=async_save)
    assert (tmp_path / "checkpoint-6" / "accum.json").exists()
    rec = []
    got, _ = _run("torch", 10, ckpt=tmp_path, resume=True, record=rec,
                  async_save=async_save)
    assert rec[0][:2] == (6, 1) and rec[-1][:2] == (10, 2)
    np.testing.assert_array_equal(_flat(got), _flat(ref))


def test_boundary_resume_bitwise(tmp_path):
    """Checkpoint at an update boundary (8 with accumulation 4) has no
    accum unit and still resumes bit for bit."""
    ref, _ = _run("torch", 12)
    _run("torch", 8, ckpt=tmp_path, ckpt_every=8)
    assert not (tmp_path / "checkpoint-8" / "accum.json").exists()
    got, _ = _run("torch", 12, ckpt=tmp_path, ckpt_every=8, resume=True)
    np.testing.assert_array_equal(_flat(got), _flat(ref))


def test_stale_accum_sidecar_removed_on_reuse(tmp_path):
    _run("torch", 6, ckpt=tmp_path)
    ck = tmp_path / "checkpoint-6"
    assert (ck / "accum.json").exists()
    _run("torch", 6, accum=1, ckpt=tmp_path)
    assert not (ck / "accum.json").exists()
    assert not (ck / "accum.npz").exists()


def test_shrunk_grad_accum_restarts_cycle(tmp_path, caplog):
    """A checkpointed cycle of 3 micro-batches does not fit
    grad_accum=2: it is discarded with a warning and the run still
    makes updates."""
    _run("torch", 7, ckpt=tmp_path, ckpt_every=7)
    before, _ = _run("torch", 7, ckpt=tmp_path, ckpt_every=7, resume=True)
    rec = []
    with caplog.at_level(logging.WARNING, "bigdl_tpu_torch.optim"):
        after, _ = _run("torch", 11, accum=2, ckpt=tmp_path,
                        ckpt_every=100, resume=True, record=rec)
    assert "does not fit grad_accum=2" in caplog.text
    assert rec[0][:2] == (7, 1) and rec[-1][:2] == (11, 3)
    assert np.isfinite(_flat(after)).all()
    assert not np.array_equal(_flat(before), _flat(after))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(tmp_path, writer):
    """A mid-cycle checkpoint written by one package, resumed by both to
    the end: the two resumed runs agree within 1e-5, and the clocks
    exactly."""
    _run(writer, 6, ckpt=tmp_path)
    rj, rt = [], []
    mj, _ = _run("jax", 10, ckpt=tmp_path, resume=True, record=rj)
    mt, _ = _run("torch", 10, ckpt=tmp_path, resume=True, record=rt)
    assert _clock(rt) == _clock(rj) and rt[0][:2] == (6, 1)
    np.testing.assert_allclose(_losses(rt), _losses(rj), rtol=0, atol=TOL)
    np.testing.assert_allclose(_flat(mt), _flat(mj), rtol=0, atol=TOL)


# ----------------------------------------------------------------- guard

def test_guard_skip_step_leaves_the_bits():
    """A NaN batch at step 3 under skip_step: the params after it are
    the params before it, bit for bit; the step consumed its batch and
    the update clock did not advance — as in the JAX package."""
    ref, _ = _run("torch", 3, accum=1, guard="skip_step")
    rt, rj = [], []
    got, o = _run("torch", 4, accum=1, guard="skip_step", plan="nan@3",
                  record=rt)
    _run("jax", 4, accum=1, guard="skip_step", plan="nan@3", record=rj)
    np.testing.assert_array_equal(_flat(got), _flat(ref))
    assert o.anomaly_guard.skipped == 1
    assert _clock(rt) == _clock(rj) and _clock(rt)[-1] == (4, 3)


def test_guard_skip_under_accumulation_matches_jax():
    """An anomalous micro-batch never reaches the accumulator: the cycle
    extends by one batch, in both packages."""
    rj, rt = [], []
    mj, oj = _run("jax", 7, accum=2, guard="skip_step", plan="nan@1",
                  record=rj)
    mt, ot = _run("torch", 7, accum=2, guard="skip_step", plan="nan@1",
                  record=rt)
    assert _clock(rt) == _clock(rj) and _clock(rt)[-1] == (7, 3)
    assert ot.anomaly_guard.skipped == oj.anomaly_guard.skipped == 1
    np.testing.assert_allclose(_flat(mt), _flat(mj), rtol=0, atol=TOL)


def test_guard_rollback_equals_the_clean_run(tmp_path):
    """A NaN batch at step 5 under rollback (checkpoints every 2):
    reload checkpoint 4, replay, finish equal to the clean run bit for
    bit; the clock replays as the JAX package's does."""
    ref, _ = _run("torch", 8, accum=1, guard="rollback",
                  ckpt=tmp_path / "ref", ckpt_every=2)
    rt, rj = [], []
    got, o = _run("torch", 8, accum=1, guard="rollback", plan="nan@5",
                  ckpt=tmp_path / "t", ckpt_every=2, record=rt)
    _run("jax", 8, accum=1, guard="rollback", plan="nan@5",
         ckpt=tmp_path / "j", ckpt_every=2, record=rj)
    np.testing.assert_array_equal(_flat(got), _flat(ref))
    assert o.anomaly_guard.rollbacks == 1
    assert _clock(rt) == _clock(rj)
    assert (5, 5) in _clock(rt) and _clock(rt).count((5, 5)) == 2


def test_guard_halt_and_rollback_without_checkpoint_raise(tmp_path):
    with pytest.raises(tanomaly.AnomalyError, match="grad norm nan"):
        _run("torch", 4, accum=1, guard="halt", plan="nan@2")
    with pytest.raises(tanomaly.AnomalyError, match="needs a checkpoint"):
        _run("torch", 4, accum=1, guard="rollback", plan="nan@1")


def test_fault_points_in_the_loop(tmp_path):
    """`preempt` raises Preempted before the step, `step` and `data`
    raise FaultInjected; a preempted run's published checkpoint
    resumes to the uninterrupted result."""
    with pytest.raises(tfaults.FaultInjected, match="step@2"):
        _run("torch", 4, plan="step@2")
    with pytest.raises(tfaults.FaultInjected, match="data@3"):
        _run("torch", 5, plan="data@3")
    ref, _ = _run("torch", 10)
    with pytest.raises(tfaults.Preempted):
        _run("torch", 10, ckpt=tmp_path, ckpt_every=3, plan="preempt@7",
             async_save=True)
    got, _ = _run("torch", 10, ckpt=tmp_path, ckpt_every=3, resume=True)
    np.testing.assert_array_equal(_flat(got), _flat(ref))


def test_loaded_slots_must_match_the_method(tmp_path):
    _run("torch", 6, ckpt=tmp_path)
    with pytest.raises(ValueError, match="slots"):
        _run("torch", 8, ckpt=tmp_path, resume=True,
             method=lambda m: m.SGD(learningrate=0.1, momentum=0.9))


def test_params_of_the_loop_are_the_model_after(tmp_path):
    """The trained variables land on the model; a resumed run's first
    loss is computed from the checkpoint's weights, not the model's
    own."""
    _run("torch", 6, ckpt=tmp_path)
    rec_resumed, rec_ref = [], []
    _run("torch", 7, ckpt=tmp_path, resume=True, record=rec_resumed)
    _run("torch", 7, record=rec_ref)
    assert rec_resumed[-1][2] == rec_ref[-1][2]
    assert all(t.grad_fn is None and not t.requires_grad
               for t in tree_leaves(_run("torch", 1)[0].variables[
                   "params"]))
