"""The port's optim methods, schedules, triggers and metrics
(bigdl_tpu_torch/optim/) and its dataset plane (bigdl_tpu_torch/dataset/)
against the JAX package's, inputs from a numpy seed.

Tolerances: every optim method's parameters and slots (SGD, Adam,
Adagrad, Adamax, RMSprop, AdaDelta, Ftrl) within 1e-6 absolute over
3 steps (fp32 elementwise arithmetic in another order: the port's
in-place foreach updates against jnp's fused expressions). Schedules,
triggers, permutations, batches and synthetic data are copies of
host-side Python and numpy, so they agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import SampleToMiniBatch as JBatcher
from bigdl_tpu.dataset.text import synthetic_next_token as jsyn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import SampleToMiniBatch as TBatcher
from bigdl_tpu_torch.dataset.text import synthetic_next_token as tsyn

ATOL = 1e-6

METHODS = {
    "sgd": lambda m: m.SGD(learningrate=0.1),
    "sgd_momentum": lambda m: m.SGD(learningrate=0.05, momentum=0.9,
                                    weightdecay=1e-3),
    "sgd_nesterov": lambda m: m.SGD(learningrate=0.05, momentum=0.9,
                                    dampening=0.0, nesterov=True),
    "adam": lambda m: m.Adam(learningrate=1e-2),
    "adam_decay": lambda m: m.Adam(learningrate=1e-2, weightdecay=1e-2,
                                   beta1=0.8, epsilon=1e-6),
    "adagrad": lambda m: m.Adagrad(learningrate=0.1),
    "adagrad_decay": lambda m: m.Adagrad(learningrate=0.1,
                                         learningrate_decay=0.1,
                                         weightdecay=1e-2),
    "adamax": lambda m: m.Adamax(learningrate=2e-2, beta1=0.8),
    "rmsprop": lambda m: m.RMSprop(learningrate=1e-2, decayrate=0.9),
    "adadelta": lambda m: m.AdaDelta(decayrate=0.8, epsilon=1e-4),
    # Ftrl's linear slot grows like 1 / lr: at lr >= 0.5 its entries
    # stay O(1), where 1e-6 absolute is a few fp32 ulps
    "ftrl": lambda m: m.Ftrl(learningrate=1.0),
    "ftrl_l1_l2": lambda m: m.Ftrl(learningrate=0.5,
                                   learningrate_power=-0.7,
                                   l1_regularization_strength=0.05,
                                   l2_regularization_strength=0.1),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_update_matches_jax(name):
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    jm, tm = METHODS[name](jopt), METHODS[name](topt)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jm.init_slots(jp), tm.init_slots(tp)
    for step in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        lr = jm.current_rate({"neval": step, "epoch": 1})
        assert lr == tm.current_rate({"neval": step, "epoch": 1})
        jp, js = jm.update([jnp.asarray(g) for g in grads], jp, js, lr,
                           step)
        out, ts = tm.update([torch.from_numpy(g) for g in grads], tp, ts,
                            lr, step)
        assert all(a is b for a, b in zip(out, tp))   # in place
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    for key in js:
        for a, b in zip(ts[key], js[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=ATOL, rtol=0)


def test_nesterov_needs_momentum():
    with pytest.raises(ValueError, match="nesterov"):
        topt.SGD(nesterov=True)


def _schedules(m):
    seq = m.SequentialSchedule().add(m.Warmup(3), 3).add(m.Poly(2.0, 10),
                                                         10)
    return {
        "default": m.Default(0.1), "step": m.Step(3, 0.5),
        "multistep": m.MultiStep([2, 5], 0.1),
        "epochstep": m.EpochStep(2, 0.5),
        "epochdecay": m.EpochDecay(lambda e: e // 2),
        "poly": m.Poly(0.5, 8), "exp": m.Exponential(4, 0.5),
        "exp_stair": m.Exponential(4, 0.5, staircase=True),
        "natexp": m.NaturalExp(3, 0.2), "warmup": m.Warmup(4),
        "sequential": seq,
    }


@pytest.mark.parametrize("name", sorted(_schedules(topt)))
def test_schedule_matches_jax(name):
    js, ts = _schedules(jopt)[name], _schedules(topt)[name]
    jm = jopt.SGD(learningrate=0.2, learningrate_schedule=js)
    tm = topt.SGD(learningrate=0.2, learningrate_schedule=ts)
    for n in range(14):
        state = {"neval": n, "epoch": 1 + n // 4}
        assert tm.current_rate(state) == jm.current_rate(state)


def test_plateau_matches_jax():
    js, ts = (m.Plateau(factor=0.5, patience=2, mode="min")
              for m in (jopt, topt))
    for v in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8):
        js.on_metric(v)
        ts.on_metric(v)
        js.base_lr = ts.base_lr = 0.1
        assert ts.rate({}) == js.rate({})


def _triggers(m):
    t = m.Trigger
    return {
        "max_epoch": t.max_epoch(2), "max_iteration": t.max_iteration(5),
        "every_epoch": t.every_epoch(),
        "several_iteration": t.several_iteration(3),
        "min_loss": t.min_loss(0.5), "max_score": t.max_score(0.7),
        "and": t.and_(t.max_iteration(3), t.min_loss(0.8)),
        "or": t.or_(t.max_epoch(3), t.max_score(0.9)),
    }


@pytest.mark.parametrize("name", sorted(_triggers(topt)))
def test_trigger_matches_jax(name):
    jt, tt = _triggers(jopt)[name], _triggers(topt)[name]
    rng = np.random.RandomState(1)
    for n in range(12):
        state = {"neval": n, "epoch": 1 + n // 4,
                 "loss": None if n == 0 else float(rng.rand()),
                 "score": None if n < 2 else float(rng.rand())}
        assert bool(tt(state)) == bool(jt(state))


def test_trigger_reads_a_device_loss():
    assert topt.Trigger.min_loss(0.5)({"loss": torch.tensor(0.25)})


def test_metrics_and_timer():
    m = topt.Metrics()
    m.add("a", 1.0)
    m.add("a", 3.0)
    m.set("b", 5)
    with topt.Timer(m, "t_s"):
        pass
    assert m.get("a") == 2.0 and m.get("b") == 5.0 and m.get("t_s") >= 0
    assert m.summary().startswith("a=2 b=5")
    m.reset()
    assert m.summary() == ""


def test_dataset_batches_match_jax():
    """Same synthetic data, same (seed + epoch) permutations, same
    batches — across an epoch boundary and a padded last batch."""
    js, ts = jsyn(10, 17, 6, seed=4), tsyn(10, 17, 6, seed=4)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)
    jit = JBatcher(4)(JDataSet.array(js, seed=3).data(train=True))
    tit = TBatcher(4)(TDataSet.array(ts, seed=3).data(train=True))
    for _ in range(6):
        jb, tb = next(jit), next(tit)
        np.testing.assert_array_equal(jb.input, tb.input)
        np.testing.assert_array_equal(jb.target, tb.target)
    jb = list(JBatcher(4)(JDataSet.array(js).data(train=False)))
    tb = list(TBatcher(4)(TDataSet.array(ts).data(train=False)))
    assert [b.real_size for b in tb] == [b.real_size for b in jb] == [4, 4,
                                                                      2]
    np.testing.assert_array_equal(tb[-1].input, jb[-1].input)
    with pytest.raises(ValueError, match="partial"):
        TBatcher(4, partial="keep")
