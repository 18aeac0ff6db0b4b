"""The port's BiGRU sentiment classifier and its validation against the
JAX package's, on the same numpy inputs and weights
(models/convert.params_from_jax):

    LookupTable -> BiRecurrent(GRU) -> Mean(2) -> Linear -> LogSoftMax

(BASELINE config 4's recurrent path with a GRU cell, cut to vocab 50,
embed 8, hidden 8): its loss and gradients; every ValidationMethod
(bigdl_tpu_torch/optim/validation.py) without padding, with a ragged
`real_size` and with a row mask; `Evaluator.test` and
`Predictor.predict` / `predict_class` (optim/evaluator.py, and the
Module overloads) over a dataset with a ragged tail; and a 5-step
`Optimizer(...).set_validation(...).optimize()` trajectory validating
every 2 steps.

Tolerances: the classifier's loss 1e-5 (fp32) / 2e-2 (bf16, the JAX
side through its Pallas kernels in interpret mode) absolute, its
gradients 1e-5 / 5e-2 relative to each leaf's largest entry, floored at
GRAD_FLOOR of the largest entry of any leaf, as
tests/test_torch_rnn_models.py holds the BiLSTM. Metric sums 1e-6
relative (fp32 arithmetic on the same values); Top1 counts exact;
validation Loss and the training losses 1e-4 in fp32, as the BiLSTM's
trajectory; predictions 1e-5.
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
from bigdl_tpu.ops.losses import build_train_loss as jloss_fn
from bigdl_tpu.optim import optimizer as jopt_loop
from bigdl_tpu.utils.precision import DEFAULT_MIXED as JMIXED
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.sample import Sample as TSample
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.ops.losses import build_train_loss as tloss_fn
from bigdl_tpu_torch.optim import optimizer as topt_loop
from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED as TMIXED

VOCAB, EMBED, HIDDEN, N, T = 50, 8, 8, 4, 6
LOSS_TOL = {"fp32": 1e-5, "bf16": 2e-2}
GRAD_TOL = {"fp32": 1e-5, "bf16": 5e-2}
GRAD_FLOOR = 1e-3
STEPS = 5


def bigru(pkg, fused=None):
    """The same Sequential in both packages."""
    return pkg.Sequential(
        pkg.LookupTable(VOCAB, EMBED).set_name("embedding"),
        pkg.BiRecurrent(pkg.GRU(EMBED, HIDDEN), fused=fused)
        .set_name("bigru"),
        pkg.Mean(2),
        pkg.Linear(2 * HIDDEN, 2).set_name("cls"),
        pkg.LogSoftMax())


def _pair(seed=0):
    """The JAX classifier built from `seed` and the port's carrying its
    weights, on the CPU."""
    jm = bigru(jnn).build(jax.random.PRNGKey(seed))
    tm = bigru(tnn)
    tm.variables = {"params": params_from_jax(
        jax.device_get(jm.variables["params"]), device="cpu"),
        "state": tm.init_state()}
    return jm, tm


def _samples(cls, n, seed=5):
    """Sentiment data: class y draws its tokens from its own half of the
    vocabulary; int32 token features, scalar int labels."""
    rng = np.random.RandomState(seed)
    half = VOCAB // 2
    return [cls(rng.randint(y * half, (y + 1) * half, T).astype(np.int32),
                np.int32(y)) for y in rng.randint(0, 2, n)]


# --------------------------------------------------------- classifier
def test_bigru_tree_carries_across():
    jv = bigru(jnn).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jv["params"]), device="cpu")
    tv = bigru(tnn).init(device="cpu")
    jpaths = [tuple(k.key for k in p)
              for p, _ in jax.tree_util.tree_leaves_with_path(jv["params"])]
    assert [p for p, _ in tree_leaves_with_path(tp)] == jpaths
    assert [p for p, _ in tree_leaves_with_path(tv["params"])] == jpaths
    assert set(tp) == {"0_embedding", "1_bigru", "2_Mean", "3_cls",
                       "4_LogSoftMax"}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_bigru_loss_and_grads_match_jax(precision):
    jm = bigru(jnn, fused="interpret" if precision == "bf16" else None)
    tm = bigru(tnn)
    jv = jm.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (N, T)).astype(np.int32)
    y = rng.randint(0, 2, N).astype(np.int32)
    jpol, tpol = (JMIXED, TMIXED) if precision == "bf16" else (None, None)
    jcall = jloss_fn(jm, jnn.ClassNLLCriterion(), jpol)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jcall(p, jv["state"], jnp.asarray(x), jnp.asarray(y),
                        None), has_aux=True))(jv["params"])
    tp = params_from_jax(jax.device_get(jv["params"]), device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, _ = tloss_fn(tm, tnn.ClassNLLCriterion(), tpol)(
        tp, tm.init_state(), torch.tensor(x), torch.tensor(y), None)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=LOSS_TOL[precision])
    jgl = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    top = max(float(np.abs(b).max()) for b in jgl)
    assert top > 0
    for (path, _), a, b in zip(tree_leaves_with_path(tp), tg, jgl):
        assert a.dtype == torch.float32
        scale = max(float(np.abs(b).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL[precision],
                                   err_msg=str(path))


# ------------------------------------------------------------ methods
METHODS = {  # name: (factory(pkg), output shape, target kind)
    "top1": (lambda p: p.Top1Accuracy(), (6, 7), "class"),
    "top5": (lambda p: p.Top5Accuracy(), (6, 7), "class"),
    "loss": (lambda p: p.Loss(p.nn_.ClassNLLCriterion()), (6, 7), "class"),
    "treenn": (lambda p: p.TreeNNAccuracy(), (6, 4, 7), "tree"),
    "hit_ratio": (lambda p: p.HitRatio(k=3), (6, 7), "class"),
    "ndcg": (lambda p: p.NDCG(k=3), (6, 7), "class"),
    "mae": (lambda p: p.MAE(), (6, 3), "value"),
}
# no padding; a ragged tail of 4 real rows; a row mask whose padded
# rows repeat the last real row, as the batching pads
REAL = {"none": None, "ragged": 4, "mask": [1, 1, 1, 0, 1, 0]}


class _Pkg:
    def __init__(self, optim, nn):
        self.__dict__.update(vars(optim))
        self.nn_ = nn


def _metric_data(shape, kind):
    rng = np.random.RandomState(11)
    out = rng.randn(*shape).astype(np.float32)
    if kind == "value":
        return out, rng.randn(*shape).astype(np.float32)
    out = out - np.log(np.exp(out).sum(-1, keepdims=True))  # log-probs
    tgt = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    out[4:] = out[3]          # padded rows repeat the last real one
    tgt[4:] = tgt[3]
    return out, tgt


@pytest.mark.parametrize("real", sorted(REAL))
@pytest.mark.parametrize("name", sorted(METHODS))
def test_validation_method_matches_jax(name, real):
    factory, shape, kind = METHODS[name]
    out, tgt = _metric_data(shape, kind)
    rs = REAL[real]
    jm = factory(_Pkg(jopt, jnn))
    tm = factory(_Pkg(topt, tnn))
    assert tm.name == jm.name
    js, jc = jm.stats(jnp.asarray(out), jnp.asarray(tgt),
                      None if rs is None else (
                          rs if isinstance(rs, int) else np.array(rs)))
    ts, tc = tm.stats(torch.tensor(out), torch.tensor(tgt), rs)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6, atol=1e-6)
    r = tm.apply(torch.tensor(out), torch.tensor(tgt), rs)
    assert isinstance(r, topt.ValidationResult) and r.fmt == jm.name


def test_validation_result_merges():
    a = topt.ValidationResult(3.0, 4.0, "Top1Accuracy")
    b = topt.ValidationResult(1.0, 4.0)
    assert (a + b).result() == (0.5, 8) and (a + b).fmt == "Top1Accuracy"
    assert topt.ValidationResult(0.0, 0.0).result() == (0.0, 0)
    assert repr(a) == "Top1Accuracy: 0.750000 (count 4)"


# -------------------------------------------------- Evaluator/Predictor
def test_evaluator_and_predictor_match_jax_with_a_ragged_tail():
    """10 samples in batches of 4: the last batch holds 2 real rows and
    2 repeats, which the metrics mask and the predictions drop."""
    jm, tm = _pair(2)
    data = _samples(JSample, 10, seed=6)
    tdata = TDataSet.array(_samples(TSample, 10, seed=6))
    jres = jopt.Evaluator(jm).test(
        JDataSet.array(data),
        [jopt.Top1Accuracy(), jopt.Loss(jnn.ClassNLLCriterion())],
        batch_size=4)
    methods = [topt.Top1Accuracy(), topt.Loss(tnn.ClassNLLCriterion())]
    tres = topt.Evaluator(tm).test(tdata, methods, batch_size=4)
    assert list(tres) == list(jres) == ["Top1Accuracy", "Loss"]
    for name in jres:
        assert tres[name].count == jres[name].count == 10
    assert tres["Top1Accuracy"].total == jres["Top1Accuracy"].total
    np.testing.assert_allclose(tres["Loss"].total, jres["Loss"].total,
                               rtol=0, atol=1e-5)
    over = tm.evaluate(tdata, methods, batch_size=4)
    assert {k: v.result() for k, v in over.items()} == \
        {k: v.result() for k, v in tres.items()}

    jpred = jopt.Predictor(jm, batch_size=4).predict(JDataSet.array(data))
    tpred = topt.Predictor(tm, batch_size=4).predict(tdata)
    assert tpred.shape == (10, 2) and jpred.shape == (10, 2)
    np.testing.assert_allclose(tpred.numpy(), jpred, rtol=0, atol=1e-5)
    tcls = tm.predict_class(tdata, batch_size=4)
    assert tcls.tolist() == jopt.Predictor(jm, batch_size=4) \
        .predict_class(JDataSet.array(data)).tolist()
    assert torch.equal(tm.predict(tdata, batch_size=4), tpred)


def test_evaluation_runs_without_autograd_and_refuses_a_mesh():
    _, tm = _pair(3)
    tdata = TDataSet.array(_samples(TSample, 5))
    for p in tree_leaves(tm.variables["params"]):
        p.requires_grad_()
    out = topt.Predictor(tm, batch_size=4).predict(tdata)
    assert out.grad_fn is None and out.shape == (5, 2)
    with pytest.raises(NotImplementedError, match="A.8"):
        topt.Evaluator(tm, mesh=object())


# ----------------------------------------------------------- trajectory
def _record_validations(monkeypatch, loop_cls, out):
    real = loop_cls._validate

    def wrapped(self, *args):
        res = real(self, *args)
        out.append({k: (v.total, v.count) for k, v in res.items()})
        return res

    monkeypatch.setattr(loop_cls, "_validate", wrapped)


def test_optimize_with_validation_matches_jax(monkeypatch):
    """Five Adam steps of Optimizer(...).set_validation(
    Trigger.several_iteration(2), ...).optimize() on the BiGRU over the
    same data in both packages (fp32): validation after steps 2 and 4,
    over 10 held-out samples in batches of 4 (a ragged tail). Top1
    counts equal, Loss and the training losses within 1e-4; the port
    keeps the last results in train_state["validation"] and the first
    method's value in train_state["score"]."""
    jm, tm = _pair(4)
    jval, tval, jl, tl, states = [], [], [], [], []
    _record_validations(monkeypatch, jopt_loop.LocalOptimizer, jval)
    _record_validations(monkeypatch, topt_loop.LocalOptimizer, tval)

    def recorder(trigger_cls, losses, keep=None):
        def fn(state):
            if state["loss"] is not None:
                losses.append(float(state["loss"]))
            if keep is not None:
                keep.append(dict(state))
            return state["neval"] >= STEPS
        return trigger_cls(fn)

    for pkg, nn_, ds, sample, model, losses, keep in (
            (jopt, jnn, JDataSet, JSample, jm, jl, None),
            (topt, tnn, TDataSet, TSample, tm, tl, states)):
        pkg.Optimizer(model, ds.array(_samples(sample, 20)),
                      nn_.ClassNLLCriterion(), batch_size=4) \
            .set_optim_method(pkg.Adam(1e-2)) \
            .set_validation(pkg.Trigger.several_iteration(2),
                            ds.array(_samples(sample, 10, seed=6)),
                            [pkg.Top1Accuracy(),
                             pkg.Loss(nn_.ClassNLLCriterion())]) \
            .set_end_when(recorder(pkg.Trigger, losses, keep)).optimize()
    assert len(tl) == len(jl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert len(tval) == len(jval) == 2
    for t, j in zip(tval, jval):
        assert t["Top1Accuracy"] == j["Top1Accuracy"]
        assert t["Loss"][1] == j["Loss"][1] == 10
        np.testing.assert_allclose(t["Loss"][0] / 10, j["Loss"][0] / 10,
                                   rtol=0, atol=1e-4)
    last = states[-1]
    assert {k: (v.total, v.count)
            for k, v in last["validation"].items()} == tval[-1]
    assert last["score"] == tval[-1]["Top1Accuracy"][0] / 10
