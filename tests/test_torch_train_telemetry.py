"""The training plane's telemetry in the port (obs/training.py,
optim/metrics.py, utils/anomaly.py, serialization/checkpoint.py, the
loop's `preempted` event, models/perf.py's `perf_result`) against the
JAX package's, on the MLP of tests/test_torch_accum_resume.py with the
JAX model's weights carried into the port.

Each scenario runs the same Optimizer calls in both packages with obs
enabled on a fresh registry and event log, and holds the port's records
to the reference's:
- the events: counts by kind, the field set of each kind, and every
  field that does not read a clock (steps, epochs, actions, policies,
  update_applied, paths' names, shard counts); losses, learning rates
  and gradient norms within 1e-5 (fp32, the same arithmetic in another
  order);
- the registry: the `training_*` families (kind and label names), the
  counters' values by label, the histograms' observation counts by
  label (the phase stopwatches and the checkpoint timer).
With obs disabled the port records nothing and its losses are bitwise
those of the enabled run (telemetry reads only host values the loop
already holds). The fault plan and both packages' telemetry are
process-wide: every test restores them."""

import functools

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.obs as jobs
import test_torch_accum_resume as ar
from bigdl_tpu.models import perf as jperf
from bigdl_tpu.parallel import make_mesh as jmake_mesh
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.models import perf as tperf
from bigdl_tpu_torch.parallel import make_mesh as tmake_mesh
from bigdl_tpu_torch.utils import faults as tfaults

TOL = 1e-5
OBS = {"jax": jobs, "torch": tobs}
# fields read from a clock (wall time, rates)
_CLOCKED = {"ts", "throughput", "duration_s", "seq"}
_NUMERIC = {"loss", "lr", "gnorm"}


@pytest.fixture(autouse=True)
def _fresh():
    prev = {k: o.set_enabled(True) for k, o in OBS.items()}
    for o in OBS.values():
        o.reset_all()
    try:
        yield
    finally:
        for k, o in OBS.items():
            o.reset_all()
            o.set_enabled(prev[k])
        jfaults.set_plan(None)
        tfaults.set_plan(None)


def _records(pkg):
    o = OBS[pkg]
    events = o.get_event_log().events()
    snap = o.get_registry().snapshot()["metrics"]
    fams = {}
    for name, fam in snap.items():
        if not name.startswith("training_"):
            continue
        series = {}
        for s in fam["series"]:
            key = tuple(sorted(s["labels"].items()))
            series[key] = s["value"] if "value" in s else s["count"]
        if fam["kind"] == "gauge":
            series = sorted(series)            # gauges hold clocked values
        fams[name] = (fam["kind"], tuple(fam["labelnames"]), series)
    o.reset_all()
    return events, fams


def _compare(ref, got):
    (jev, jfam), (tev, tfam) = ref, got
    counts = {}
    for e in jev:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    assert counts == {k: sum(e["kind"] == k for e in tev) for k in
                      set(counts) | {e["kind"] for e in tev}}
    # in order within each kind (an async save's event lands from the
    # writer thread, and the JAX DistriOptimizer emits a step at once
    # where the port's shared loop emits it one step late)
    by_kind = {k: ([e for e in jev if e["kind"] == k],
                   [e for e in tev if e["kind"] == k]) for k in counts}
    for j, t in ((j, t) for js, ts in by_kind.values()
                 for j, t in zip(js, ts)):
        assert j["kind"] == t["kind"]
        assert set(j) == set(t), j["kind"]
        for k in set(j) - _CLOCKED:
            if k in _NUMERIC and j[k] is not None:
                np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=TOL)
            elif k == "path":
                assert t[k].split("/")[-1] == j[k].split("/")[-1]
            elif k != "error":
                assert t[k] == j[k], (j["kind"], k)
    assert jfam == tfam
    return counts


def _both(scenario, tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        scenario(pkg, tmp_path / pkg)
        out[pkg] = _records(pkg)
    return _compare(out["jax"], out["torch"])


def _guarded(pkg, d):
    ar._run(pkg, 6, accum=1, ckpt=d, ckpt_every=2, guard="skip_step",
            plan="nan@3")


def _accum_async(pkg, d):
    ar._run(pkg, 5, accum=2, ckpt=d, ckpt_every=3, async_save=True)


def _rollback(pkg, d):
    ar._run(pkg, 8, accum=1, ckpt=d, ckpt_every=3, guard="rollback",
            plan="nan@5")


def _fallback(pkg, d):
    ar._run(pkg, 7, accum=1, ckpt=d, ckpt_every=3, plan="ckpt_corrupt@6")
    ar._run(pkg, 9, accum=1, ckpt=d, ckpt_every=3, resume=True)


def _preempt(pkg, d):
    faults = ar.PKG[pkg][4]
    with pytest.raises(faults.Preempted):
        ar._run(pkg, 6, accum=1, ckpt=d, ckpt_every=2, plan="preempt@3")


def _halt(pkg, d):
    from bigdl_tpu.utils.anomaly import AnomalyError as JErr

    from bigdl_tpu_torch.utils.anomaly import AnomalyError as TErr
    with pytest.raises(JErr if pkg == "jax" else TErr):
        ar._run(pkg, 6, accum=1, guard="halt", plan="nan@2")


def _mesh(pkg, d):
    """A one-device (one-rank) mesh: DistriOptimizer's loop."""
    nn_, opt_, ds, sample, _ = ar.PKG[pkg]
    mesh = jmake_mesh({"data": 1}, devices=jax.devices()[:1]) \
        if pkg == "jax" else tmake_mesh({"data": 1}, device="cpu")
    o = (opt_.Optimizer(ar._model(pkg), ds.array(ar._samples(sample)),
                        nn_.ClassNLLCriterion(), batch_size=8)
         .set_optim_method(opt_.Adam(learningrate=1e-2))
         .set_end_when(opt_.Trigger.max_iteration(4))
         .set_checkpoint(str(d), opt_.Trigger.several_iteration(2))
         .set_mesh(mesh, zero=2))
    try:
        o.optimize()
    finally:
        if pkg == "torch":
            mesh.close()


SCENARIOS = {"guarded": _guarded, "accum_async": _accum_async,
             "rollback": _rollback, "fallback": _fallback,
             "preempt": _preempt, "halt": _halt, "mesh": _mesh}
# both packages' counts; a run that raises never emits its last step's
# record (the loop emits a step one step late), and a rollback replays
EXPECT = {
    "guarded": {"train_step": 6, "anomaly": 1, "fault_injected": 1,
                "checkpoint_save": 3},
    "accum_async": {"train_step": 5, "checkpoint_save": 1},
    "rollback": {"train_step": 10, "anomaly": 1, "fault_injected": 1,
                 "checkpoint_save": 2, "checkpoint_load": 1},
    "fallback": {"train_step": 13, "fault_injected": 1,
                 "checkpoint_save": 4, "checkpoint_load": 1,
                 "checkpoint_corrupt_skipped": 1},
    "preempt": {"train_step": 2, "fault_injected": 1, "preempted": 1,
                "checkpoint_save": 1},
    "halt": {"train_step": 1, "anomaly": 1, "fault_injected": 1},
    "mesh": {"train_step": 4, "checkpoint_save": 2},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_training_records_match_the_reference(tmp_path, name):
    counts = _both(SCENARIOS[name], tmp_path)
    assert counts == EXPECT[name]


def test_obs_off_records_nothing_and_moves_no_loss():
    losses = {}
    for enabled in (True, False):
        tobs.set_enabled(enabled)
        tobs.reset_all()
        record = []
        ar._run("torch", 6, accum=1, guard="skip_step", plan="nan@3",
                record=record)
        events, fams = _records("torch")
        losses[enabled] = [r[2] for r in record]
        if enabled:
            assert sum(e["kind"] == "train_step" for e in events) == 6
        else:
            assert events == []
            assert all(not series for _, _, series in fams.values())
    assert np.array_equal(np.asarray(losses[True], dtype=np.float64),
                          np.asarray(losses[False], dtype=np.float64),
                          equal_nan=True)


def test_perf_result_event(monkeypatch):
    """`python -m ...models.perf` emits one `perf_result` event with the
    JAX harness's fields (the port's run on the CPU)."""
    monkeypatch.setattr(tperf, "run_perf",
                        functools.partial(tperf.run_perf, device="cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    argv = ["--model", "lenet", "-b", "4", "-i", "1", "--class-num", "10"]
    jperf.main(argv)
    tperf.main(argv)
    (jev,), (tev,) = (OBS[p].get_event_log().events("perf_result")
                      for p in ("jax", "torch"))
    assert set(jev) == set(tev)
    for k in ("plane", "model", "batch_size", "iterations"):
        assert jev[k] == tev[k]
