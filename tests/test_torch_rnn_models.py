"""The port's recurrent models (bigdl_tpu_torch/models/rnn.py) against
the JAX package's (bigdl_tpu/models/rnn.py): the BiLSTM sentiment
classifier (BASELINE config 4, cut to vocab 50, embed 8, hidden 8) and
a 2-layer LSTM language model, from the same weights carried across by
`params_from_jax`, on the same token batches.

Tolerances: fp32 loss 1e-5 and gradients 1e-5 relative; bf16 mixed
precision (DEFAULT_MIXED) loss 2e-2 and gradients 5e-2 relative, the
JAX side running its Pallas kernels in interpret mode — both packages
then round where the kernels round, and differ only in fp32 summation
order, which a bf16 recurrence carries into one-ulp flips. A gradient
is held relative to its own leaf's largest entry, floored at GRAD_FLOOR
of the largest entry of any leaf (a leaf whose exact gradient is near
zero is measured on the model's scale). The bf16 limit stands above
the worst reading, 3.3e-2 (the BiLSTM's backward-direction bias, a
cancelling sum over N x T steps; the other leaves read <= 2e-2), and far
below the 0.5 of a halved or 1.0 of a zeroed leaf. The 5-step
`Optimizer.optimize()` trajectory 1e-4 in fp32.
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
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.ops.losses import build_train_loss as jloss_fn
from bigdl_tpu.utils.precision import DEFAULT_MIXED as JMIXED
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset.sample import Sample as TSample
from bigdl_tpu_torch.models import rnn as trnn
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_leaves_with_path)
from bigdl_tpu_torch.ops.losses import build_train_loss as tloss_fn
from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED as TMIXED

VOCAB, EMBED, HIDDEN, N, T = 50, 8, 8, 4, 6
TOL = {"fp32": 1e-5, "bf16": 2e-2}            # loss, absolute
GRAD_TOL = {"fp32": 1e-5, "bf16": 5e-2}       # gradients, relative
GRAD_FLOOR = 1e-3
STEPS = 5


def _models(kind, jax_fused=None):
    if kind == "bilstm":
        jm = jrnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN, fused=jax_fused)
        return jm, trnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN), \
            jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()
    jm = jrnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2)
    if jax_fused is not None:
        for layer in jm.modules:
            if isinstance(layer, jnn.Recurrent):
                layer.fused = jax_fused
    return jm, trnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2), \
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                     size_average=True), \
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                     size_average=True)


def _batch(kind, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, (N, T)).astype(np.int32)
    y = rng.randint(0, 2, N) if kind == "bilstm" \
        else rng.randint(0, VOCAB, (N, T))
    return x, y.astype(np.int32)


def test_params_from_jax_carries_the_bilstm_tree():
    jm = jrnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN)
    jv = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jv), device="cpu")
    tv = trnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN).init(device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jv["params"])
    assert [p for p, _ in tree_leaves_with_path(tp)] == [
        tuple(k.key for k in p) for p, _ in jleaves]
    assert [p for p, _ in tree_leaves_with_path(tv["params"])] == [
        p for p, _ in tree_leaves_with_path(tp)]
    for (_, a), (_, b) in zip(tree_leaves_with_path(tp), jleaves):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(tp) == {"0_embedding", "1_bilstm", "2__MeanOverTime",
                       "3_cls", "4_LogSoftMax"}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["bilstm", "lstm_lm"])
def test_loss_and_grads_match_jax(kind, precision):
    jm, tm, jc, tc = _models(kind, "interpret" if precision == "bf16"
                             else None)
    jv = jm.init(jax.random.PRNGKey(1))
    x, y = _batch(kind)
    jpol, tpol = (JMIXED, TMIXED) if precision == "bf16" else (None, None)
    jl_call = jloss_fn(jm, jc, jpol)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jl_call(p, jv["state"], jnp.asarray(x), jnp.asarray(y),
                          None), has_aux=True)(jv["params"])
    tp = params_from_jax(jax.device_get(jv["params"]), device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, _ = tloss_fn(tm, tc, tpol)(tp, tm.init_state(), torch.tensor(x),
                                   torch.tensor(y), None)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=TOL[precision])
    jgl = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    top = max(float(np.abs(b).max()) for b in jgl)
    assert top > 0
    for (path, _), a, b in zip(tree_leaves_with_path(tp), tg, jgl):
        assert a.dtype == torch.float32
        scale = max(float(np.abs(b).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL[precision],
                                   err_msg=str(path))


def test_simple_rnn_matches_jax():
    jm, tm = jrnn.simple_rnn(VOCAB, 8), trnn.simple_rnn(VOCAB, 8)
    jv = jm.init(jax.random.PRNGKey(2))
    tv = {"params": params_from_jax(jax.device_get(jv["params"]),
                                    device="cpu"),
          "state": tm.init_state()}
    x, _ = _batch("lstm_lm", 3)
    jout, _ = jm.apply(jv, jnp.asarray(x))
    tout, _ = tm.apply(tv, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def _samples(cls, n=16):
    """Learnable sentiment data: class y draws its tokens from its own
    half of the vocabulary; int32 token features, scalar int labels."""
    rng = np.random.RandomState(5)
    half = VOCAB // 2
    return [cls(rng.randint(y * half, (y + 1) * half, T).astype(np.int32),
                np.int32(y)) for y in rng.randint(0, 2, n)]


def _recorder(trigger_cls, out):
    def fn(state):
        if state["loss"] is not None:
            out.append(float(state["loss"]))
        return state["neval"] >= STEPS
    return trigger_cls(fn)


def test_optimize_trajectory_matches_jax():
    """Five Adam steps of Optimizer(...).optimize() on the BiLSTM over
    the same data in both packages (fp32): losses and trained weights
    within 1e-4. The port's CPU run goes through bilstm_scan's plain
    version and its autograd Function."""
    jm = jrnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN)
    jm.build(jax.random.PRNGKey(3))
    tm = trnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN)
    tm.variables = {"params": params_from_jax(
        jax.device_get(jm.variables["params"]), device="cpu"),
        "state": tm.init_state()}
    jl, tl = [], []
    jopt.Optimizer(jm, JDataSet.array(_samples(JSample)),
                   jnn.ClassNLLCriterion(), batch_size=4) \
        .set_optim_method(jopt.Adam(1e-2)) \
        .set_end_when(_recorder(jopt.Trigger, jl)).optimize()
    topt.Optimizer(tm, TDataSet.array(_samples(TSample)),
                   tnn.ClassNLLCriterion(), batch_size=4) \
        .set_optim_method(topt.Adam(1e-2)) \
        .set_end_when(_recorder(topt.Trigger, tl)).optimize()
    assert len(tl) == len(jl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[-1] < tl[0]
    for (path, a), b in zip(
            tree_leaves_with_path(tm.variables["params"]),
            jax.tree_util.tree_leaves(jm.variables["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=str(path))


def test_optimizer_carries_int_tokens_and_scalar_labels_in_bf16():
    tm = trnn.bilstm_sentiment(VOCAB, EMBED, HIDDEN)
    tm.build(torch.Generator().manual_seed(0), device="cpu")
    losses = []
    topt.Optimizer(tm, TDataSet.array(_samples(TSample, 12)),
                   tnn.ClassNLLCriterion(), batch_size=4) \
        .set_optim_method(topt.Adam(1e-2)).set_precision("bf16") \
        .set_end_when(_recorder(topt.Trigger, losses)).optimize()
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert all(t.dtype == torch.float32
               for t in tree_leaves(tm.variables["params"]))


def test_inference_pass_takes_no_residuals():
    tm = trnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2)
    v = tm.init(device="cpu")
    x, _ = _batch("lstm_lm", 4)
    with torch.no_grad():
        out, _ = tm.apply(v, torch.tensor(x))
    assert out.shape == (N, T, VOCAB) and out.grad_fn is None
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)


def test_unported_options_raise():
    """lstm_lm(dropout=0.5), which raised until nn/dropout.py was
    ported: the JAX package's layers (a Dropout after each LSTM layer)
    and the same log-probabilities in evaluation, and in training with
    the Dropouts' p set to 0 (threefry is not ported, so masks drawn at
    p > 0 differ by design)."""
    jm = jrnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2, dropout=0.5)
    tm = trnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2, dropout=0.5)
    assert [type(m).__name__ for m in tm.modules_] \
        == [type(m).__name__ for m in jm.modules] \
        == ["LookupTable", "Recurrent", "Dropout", "Recurrent", "Dropout",
            "TimeDistributed", "TimeDistributed"]
    jv = jm.init(jax.random.PRNGKey(4))
    tv = {"params": params_from_jax(jax.device_get(jv["params"]),
                                    device="cpu"),
          "state": tm.init_state()}
    x, _ = _batch("lstm_lm", 5)
    jout, _ = jm.apply(jv, jnp.asarray(x))
    tout, _ = tm.apply(tv, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL["fp32"])
    for m in tm.modules_ + jm.modules:
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    jtrain, _ = jm.apply(jv, jnp.asarray(x), training=True,
                         rng=jax.random.PRNGKey(5))
    ttrain, _ = tm.apply(tv, torch.tensor(x), training=True,
                         rng=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(ttrain.numpy(), np.asarray(jtrain), rtol=0,
                               atol=TOL["fp32"])
