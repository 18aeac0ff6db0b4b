"""Slice 13 as a whole: the input pipelines feeding `Optimizer` in both
packages, from the same data and the same weights.

- Raw text to the LSTM LM: a seeded corpus through `Dictionary` and
  `DataSet.array(texts) >> (SentenceTokenizer >> SentenceBiPadding >>
  TextToLabeledSentence >> LabeledSentenceToSample)` into
  `Optimizer(lstm_lm, ..., TimeDistributedCriterion(ClassNLLCriterion))`
  for 3 Adam steps at small widths, the recurrences on their plain
  versions (the JAX package's LSTM on the CPU as
  tests/test_torch_rnn_models.py runs it).
- Disk to the CIFAR ResNet at depth 8: BDLS shards written by the port
  and read by both packages' `RecordFileDataSet` (the JAX package's on
  its Python plane), 2 SGD-with-momentum steps, then `Evaluator` over
  the shards.

Tolerance (fp32): the rnn and CNN trajectory tests' 1e-4 on every loss
and every final parameter and running statistic.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np

import test_torch_cnn_models as cm
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import records as jrecords
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import records as trecords
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.models import resnet as tresnet
from bigdl_tpu_torch.models import rnn as trnn
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            variables_from_jax)

TOL = 1e-4
VOCAB, EMBED, HIDDEN, SEQ, BATCH, STEPS = 40, 8, 8, 10, 4, 3
MEAN, STD = [125.3, 122.9, 113.8], [63.0, 62.1, 66.7]


def _recorder(trigger_cls, out, steps):
    def fn(state):
        if state["loss"] is not None:
            out.append(float(state["loss"]))
        return state["neval"] >= steps
    return trigger_cls(fn)


def _corpus(n, seed=0):
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghij"))
    words = ["".join(rng.choice(letters, rng.randint(1, 4)))
             for _ in range(80)]
    p = 1.0 / np.arange(1, 81)
    p /= p.sum()
    return [" ".join(words[i] for i in rng.choice(80, rng.randint(4, 14),
                                                  p=p)).capitalize() + "."
            for _ in range(n)]


def _text_data(text_mod, ds, texts):
    tokens = list((text_mod.SentenceTokenizer()
                   >> text_mod.SentenceBiPadding())(texts))
    d = text_mod.Dictionary(tokens, vocab_size=VOCAB - 1)
    assert d.vocab_size() == VOCAB
    return ds.array(texts) >> (
        text_mod.SentenceTokenizer() >> text_mod.SentenceBiPadding()
        >> text_mod.TextToLabeledSentence(d)
        >> text_mod.LabeledSentenceToSample(SEQ))


def test_raw_text_trains_the_lstm_lm_as_jax_does():
    texts = _corpus(24)
    jm = jrnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2)
    jm.build(jax.random.PRNGKey(5))
    tm = trnn.lstm_lm(VOCAB, EMBED, HIDDEN, num_layers=2)
    tm.variables = {"params": params_from_jax(
        jax.device_get(jm.variables["params"]), device="cpu"),
        "state": tm.init_state()}
    losses = {}
    for pkg, m, opt, nn, text_mod, ds in (
            ("jax", jm, jopt, jnn, jtext, JDataSet),
            ("torch", tm, topt, tnn, ttext, TDataSet)):
        losses[pkg] = []
        opt.Optimizer(m, _text_data(text_mod, ds, texts),
                      nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                  size_average=True),
                      batch_size=BATCH) \
            .set_optim_method(opt.Adam(1e-2)) \
            .set_end_when(_recorder(opt.Trigger, losses[pkg], STEPS)) \
            .optimize()
    assert len(losses["torch"]) == len(losses["jax"]) == STEPS
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=0,
                               atol=TOL)
    assert losses["torch"][-1] < losses["torch"][0]
    for a, b in zip(tree_leaves(tm.variables["params"]),
                    jax.tree_util.tree_leaves(jm.variables["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_records_train_resnet8_as_jax_does(tmp_path):
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (20, 32, 32, 3), np.uint8)
    labels = rng.randint(0, 10, 20).astype(np.int32)
    trecords.write_shards(images, labels, str(tmp_path), num_shards=2)
    jm, tm = jresnet.build_cifar(8, 10), tresnet.build_cifar(8, 10)
    jv = cm._seeded(jm, 6)
    jm.variables = jax.tree_util.tree_map(jnp.asarray, jv)
    tm.variables = variables_from_jax(jv, device="cpu")
    kw = dict(batch_size=8, mean=MEAN, std=STD, pad=4, hflip=True, seed=3)
    with mock.patch.object(jnative, "_load", return_value=None):
        jds = jrecords.RecordFileDataSet(str(tmp_path), **kw)
    # the port's C++ plane masked the same way: both run the Python plane
    with mock.patch.object(tnative, "_load", return_value=None):
        tds = trecords.RecordFileDataSet(str(tmp_path), **kw)
    losses, scores = {}, {}
    try:
        for pkg, m, opt, nn, ds in (("jax", jm, jopt, jnn, jds),
                                    ("torch", tm, topt, tnn, tds)):
            losses[pkg] = []
            opt.Optimizer(m, ds, nn.ClassNLLCriterion()) \
                .set_optim_method(opt.SGD(0.05, momentum=0.9)) \
                .set_end_when(_recorder(opt.Trigger, losses[pkg], 2)) \
                .optimize()
            scores[pkg] = opt.Evaluator(m).test(
                ds, [opt.Top1Accuracy(), opt.Loss(nn.ClassNLLCriterion())],
                batch_size=8)
    finally:
        jds.close()
        tds.close()
    assert len(losses["torch"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=0,
                               atol=TOL)
    for a, b in zip(tree_leaves(tm.variables),
                    jax.tree_util.tree_leaves(jm.variables)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=0, atol=TOL)
    for name in ("Top1Accuracy", "Loss"):
        (tv, tc), (jv_, jc) = (scores[p][name].result()
                               for p in ("torch", "jax"))
        assert tc == jc == 20
        np.testing.assert_allclose(tv, jv_, rtol=0, atol=TOL)
