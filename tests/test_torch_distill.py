"""The port's DraftDistiller (bigdl_tpu_torch/serving/distill.py) against
the JAX package's (bigdl_tpu/serving/distill.py) on the CPU: a tiny
draft LM built from one JAX key, its weights carried into the port,
the same seeded token streams.

- ingestion: the windows each stream yields (stride seq_len plus an
  end-anchored window; short streams none) are the reference's;
- one distill round (ZeRO-2 DistriOptimizer on a one-device JAX mesh /
  a one-rank gloo mesh, Adam, ChunkedSoftmaxCE, two epochs): the loss
  curve, read from the `train_step` events, within 1e-5 relative of the
  reference's (measured 3.7e-7), and each distilled weight within
  2 x lr x steps of the reference's. Both packages send gradients over
  a bf16 wire by default, so a gradient whose fp32 bits differ in the
  last place can round to another bf16 value, and Adam's normalised
  step can then move that weight up to lr further a step in either
  direction (measured over the 8 steps: 1.3e-3 against the bound's
  4.8e-2);
- two port rounds from the same weights over the same streams give
  bitwise-equal variables (one intra-op thread: the CPU's threaded
  reductions change their order run to run), and the round trains on
  copies: the returned tree shares no storage with the weights the
  serving side holds, and a failed round restores the model's
  variables.
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.obs as jobs
from bigdl_tpu.models.transformer import build_lm
from bigdl_tpu.serving import DraftDistiller as JDistiller
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.models.convert import (params_from_jax, tree_leaves,
                                            tree_map)
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.serving import DraftDistiller as TDistiller

LOSS_TOL = 1e-5
CFG = dict(vocab_size=50, dim=16, num_heads=2, num_layers=1, max_len=64)
KNOBS = dict(seq_len=8, batch_size=4, epochs=2, learningrate=3e-3)


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = {o: o.set_enabled(True) for o in (jobs, tobs)}
    for o in prev:
        o.reset_all()
    try:
        yield
    finally:
        for o, p in prev.items():
            o.reset_all()
            o.set_enabled(p)
        torch.set_num_threads(threads)


def _models():
    jm = build_lm(**CFG)
    jm.build(jax.random.PRNGKey(7))
    tm = TransformerLM(TransformerConfig(**CFG), device="cpu")
    tm.variables = {"params": params_from_jax(
        jax.device_get(jm.variables["params"]), device="cpu"), "state": {}}
    return jm, tm


def _streams():
    rng = np.random.RandomState(4)
    return [[int(t) for t in rng.randint(1, 50, n)]
            for n in (30, 9, 8, 21, 17, 40)]


def _losses(o):
    ev = o.get_event_log().events("train_step")
    o.reset_all()
    return [e["loss"] for e in ev]


def test_windows_match():
    jm, tm = _models()
    jd, td = JDistiller(jm, **KNOBS), TDistiller(tm, **KNOBS)
    for s in _streams():
        assert td.ingest(s) == jd.ingest(s)
    assert td.streams == jd.streams == 6
    want = [(np.asarray(x.feature), np.asarray(x.label))
            for x in jd._samples()]
    got = [(np.asarray(x.feature), np.asarray(x.label))
           for x in td._samples()]
    assert len(got) == len(want)
    for (gf, gl), (wf, wl) in zip(got, want):
        assert (gf == wf).all() and (gl == wl).all()
    with pytest.raises(ValueError, match="max_len"):
        TDistiller(tm, seq_len=65)
    with pytest.raises(RuntimeError, match="empty corpus"):
        TDistiller(tm, **KNOBS).distill()


def test_round_matches_the_reference_and_repeats_bitwise():
    jm, tm = _models()
    start = tree_map(lambda t: t.clone(), tm.variables)
    jd, td = JDistiller(jm, **KNOBS), TDistiller(tm, **KNOBS)
    for s in _streams():
        jd.ingest(s)
        td.ingest(s)
    jvars = jd.distill()
    jloss = _losses(jobs)
    served = {t.data_ptr() for t in tree_leaves(start)}
    tvars = td.distill()
    tloss = _losses(tobs)
    assert len(tloss) == len(jloss) > 0
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_TOL)
    assert tloss[-1] < tloss[0]
    want = params_from_jax(jax.device_get(jvars["params"]), device="cpu")
    bound = 2 * KNOBS["learningrate"] * len(tloss)
    for g, w in zip(tree_leaves(tvars["params"]), tree_leaves(want)):
        assert float((g - w).abs().max()) <= bound
    assert tm.variables is tvars and td.distills == 1
    assert not {t.data_ptr() for t in tree_leaves(tvars)} & served
    # a second round from the same weights over the same streams
    tm.variables = start
    again = TDistiller(tm, **KNOBS)
    for s in _streams():
        again.ingest(s)
    redo = again.distill()
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tvars), tree_leaves(redo)))


def test_failed_round_restores_the_variables(monkeypatch):
    from bigdl_tpu_torch.optim import Optimizer

    _, tm = _models()
    before = tm.variables
    d = TDistiller(tm, **KNOBS)
    d.ingest(_streams()[0])

    def boom(self):
        raise RuntimeError("injected")

    monkeypatch.setattr(Optimizer, "optimize", boom)
    with pytest.raises(RuntimeError, match="injected"):
        d.distill()
    assert tm.variables is before and d.distills == 0
