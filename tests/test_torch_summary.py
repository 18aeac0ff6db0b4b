"""The port's TensorBoard summaries (bigdl_tpu_torch/visualization/) and
their place in the training loop (obs/training.StepTelemetry, the
optimizer's summary setters) against the JAX package's
(bigdl_tpu/visualization/, bigdl_tpu/obs/training.py).

Tolerances: the event files are the same bytes on the wire — either
package reads the other's records with the same tags, steps and
float32 values, and crc32c agrees exactly. A 4-step optimize() of the
MLP of tests/test_torch_accum_resume.py with train and validation
summaries writes the same tags at the same steps in both packages;
Loss and the validation values within 1e-4 (fp32, as
tests/test_torch_optimizer.py holds the loss trajectory), LearningRate
exactly."""

import os

import numpy as np
import pytest

import test_torch_accum_resume as ar
from bigdl_tpu import visualization as jvis
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import visualization as tvis
from bigdl_tpu_torch.visualization import tensorboard as ttb

TOL = 1e-4


def _events(logdir, reader):
    out = []
    for fname in sorted(os.listdir(logdir)):
        if "tfevents" in fname:
            out.extend(reader(os.path.join(logdir, fname)))
    return out


@pytest.mark.parametrize("writer, reader", [(ttb, jtb), (jtb, ttb)])
def test_event_files_cross_read(tmp_path, writer, reader):
    rng = np.random.RandomState(0)
    w = writer.FileWriter(str(tmp_path))
    values = rng.randn(5).astype(np.float64) * 10
    for i, v in enumerate(values):
        w.add_scalar("Loss", float(v), i + 1)
    w.add_scalar("LearningRate", 1e-3, 7)
    w.add_histogram("0_Linear.weight", rng.randn(4, 3), 7)
    w.close()
    got = _events(str(tmp_path), reader.read_events)
    assert got == _events(str(tmp_path), writer.read_events)
    want = [("Loss", float(np.float32(v)), i + 1)
            for i, v in enumerate(values)]
    want += [("LearningRate", float(np.float32(1e-3)), 7),
             ("0_Linear.weight", None, 7)]
    assert got == want


def test_crc32c_like_jax():
    rng = np.random.RandomState(1)
    assert ttb.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check
    for n in (0, 1, 7, 64, 1000):
        data = rng.bytes(n)
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb.masked_crc32c(data) == jtb.masked_crc32c(data)


def test_summary_read_scalar_and_triggers(tmp_path):
    s = tvis.TrainSummary(str(tmp_path), "app")
    assert s.log_dir == str(tmp_path / "app" / "train")
    s.add_scalar("Loss", 2.5, 1).add_scalar("Loss", 1.5, 2)
    assert [(t, v, n) for t, v, n in s.read_scalar("Loss")] == [
        ("Loss", 2.5, 1), ("Loss", 1.5, 2)]
    trig = object()
    assert s.set_summary_trigger("Parameters", trig) is s
    assert s.get_summary_trigger("Parameters") is trig
    assert s.get_summary_trigger("Loss") is None
    v = tvis.ValidationSummary(str(tmp_path), "app")
    assert v.log_dir == str(tmp_path / "app" / "validation")
    s.close()
    v.close()


def _optimize_with_summaries(pkg, logdir):
    nn_, opt_, ds, sample, _ = ar.PKG[pkg]
    vis = jvis if pkg == "jax" else tvis
    train = vis.TrainSummary(str(logdir), "mlp")
    train.set_summary_trigger("Parameters", opt_.Trigger.several_iteration(2))
    val = vis.ValidationSummary(str(logdir), "mlp")
    opt_.Optimizer(ar._model(pkg), ds.array(ar._samples(sample)),
                   nn_.ClassNLLCriterion(), batch_size=8) \
        .set_optim_method(opt_.Adam(learningrate=1e-2)) \
        .set_end_when(opt_.Trigger.max_iteration(4)) \
        .set_validation(opt_.Trigger.several_iteration(2),
                        ds.array(ar._samples(sample, n=12, seed=4)),
                        [opt_.Top1Accuracy(),
                         opt_.Loss(nn_.ClassNLLCriterion())], 8) \
        .set_train_summary(train).set_validation_summary(val).optimize()
    return (_events(train.log_dir, jtb.read_events),
            _events(val.log_dir, jtb.read_events))


def test_optimize_summaries_match_jax(tmp_path):
    jt, jv = _optimize_with_summaries("jax", tmp_path / "j")
    tt, tv = _optimize_with_summaries("torch", tmp_path / "t")
    assert [(tag, step) for tag, _, step in tt] \
        == [(tag, step) for tag, _, step in jt]
    assert sorted({tag for tag, _, _ in tt}) == sorted(
        {"Loss", "Throughput", "LearningRate", "0_Linear.bias",
         "0_Linear.weight", "2_Linear.bias", "2_Linear.weight"})
    assert [s for tag, _, s in tt if tag == "Loss"] == [1, 2, 3, 4]
    assert [s for tag, v, s in tt if v is None] == [2] * 4 + [4] * 4
    for (tag, a, _), (_, b, _) in zip(tt, jt):
        if tag == "Loss":
            assert abs(a - b) <= TOL
        elif tag == "LearningRate":
            assert a == b
    assert [(tag, step) for tag, _, step in tv] \
        == [(tag, step) for tag, _, step in jv] \
        == [("Top1Accuracy", 2), ("Loss", 2), ("Top1Accuracy", 4),
            ("Loss", 4)]
    np.testing.assert_allclose([v for _, v, _ in tv], [v for _, v, _ in jv],
                               rtol=0, atol=TOL)
