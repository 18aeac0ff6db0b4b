"""The port's VisionEngine (bigdl_tpu_torch/serving/vision.py) against
the JAX package's (bigdl_tpu/serving/vision.py) on the CPU: LeNet-5
(BASELINE config 1, feature_len 784) with seeded weights carried from
the JAX model (`test_torch_cnn_models._seeded`, `variables_from_jax`),
the same pixel-int images, the same injected clock.

- The forward's log-probabilities agree within 1e-5 (fp32, cuDNN-free
  CPU convolutions in both) and the classes are equal;
- one engine's whole serving record is the reference's: results
  (statuses, reasons, classes, TTFT and latency on the clock), stats
  (forwards, classified, expired, rejected, forward builds), health,
  every event's fields, and the `serving_requests_total` series;
- behind an EngineRouter, a vision group of two engines beside nothing
  else serves the same burst with the same results and router stats;
- the refusals (an empty or too long vector, a duplicate id, drain,
  overload) and the KV-plane no-ops match.
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.obs as jobs
import test_torch_cnn_models as cm
from bigdl_tpu import serving as jserving
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import serving as tserving
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models.convert import variables_from_jax

TOL = 1e-5
FEATURES = 28 * 28
PKG = {"jax": (jserving, jobs), "torch": (tserving, tobs)}
_NETS: dict = {}


@pytest.fixture(autouse=True)
def _fresh():
    prev = {k: o.set_enabled(True) for k, (_, o) in PKG.items()}
    for _, o in PKG.values():
        o.reset_all()
    try:
        yield
    finally:
        for k, (_, o) in PKG.items():
            o.reset_all()
            o.set_enabled(prev[k])


def _predict(pkg):
    """The predict function of LeNet-5 with the seeded weights: one
    function object per package, so every engine shares its forward."""
    if not _NETS:
        jm = jlenet.build(10)
        jv = cm._seeded(jm, 5)
        tm = tlenet.build(10)
        tv = variables_from_jax(jv, device="cpu")
        _NETS["jax"] = lambda f: jm.apply(jv, f.reshape(-1, 28, 28, 1))[0]
        _NETS["torch"] = lambda f: tm.apply(tv, f.reshape(-1, 28, 28, 1))[0]
    return _NETS[pkg]


def _images(n, seed=11):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, FEATURES))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _requests(pkg, imgs, **kw):
    serving = PKG[pkg][0]
    return [serving.Request(prompt=[int(p) for p in im],
                            max_new_tokens=1, model_tag="vision",
                            priority=i % 3, **kw)
            for i, im in enumerate(imgs)]


def _engine(pkg, clock, **kw):
    serving = PKG[pkg][0]
    if pkg == "torch":
        kw["device"] = "cpu"
    return serving.VisionEngine(_predict(pkg), batch=4,
                                feature_len=FEATURES, clock=clock, **kw)


def _served(res):
    return [(r.id, r.status, r.finish_reason, list(r.tokens), r.ttft_s,
             r.latency_s) for r in res]


def _records(pkg):
    o = PKG[pkg][1]
    events = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
              for e in o.get_event_log().events()]
    snap = o.get_registry().snapshot()["metrics"].get(
        "serving_requests_total", {})
    return events, snap.get("series")


def test_forward_matches():
    x = _images(8).astype(np.float32)
    want = np.asarray(_predict("jax")(jax.numpy.asarray(x)))
    got = _predict("torch")(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_engine_serves_as_the_reference():
    out = {}
    for pkg in PKG:
        clk = _Clock()
        eng = _engine(pkg, clk, max_queue=16, obs_label="v0")
        reqs = _requests(pkg, _images(10))
        reqs[3].deadline_s = 0.5          # expires queued
        ids = [eng.submit(r) for r in reqs]
        results = []
        while not eng.idle:
            clk.t += 1.0
            results += eng.step()
        out[pkg] = (_served(results), eng.stats, eng.health(), ids,
                    _records(pkg))
    assert out["torch"] == out["jax"]
    served = out["torch"][0]
    assert sum(s[1] == "done" for s in served) == 9
    assert out["torch"][1]["forward_traces"] in (0, 1)


def test_router_vision_group_matches():
    out = {}
    for pkg in PKG:
        serving = PKG[pkg][0]
        clk = _Clock()
        engines = [_engine(pkg, clk, obs_label=f"v{i}") for i in range(2)]
        router = serving.EngineRouter(engines, clock=clk, obs_label="r0")
        ids = [router.submit(r) for r in _requests(pkg, _images(12, 3))]
        got = {}
        while len(got) < len(ids):
            clk.t += 1.0
            for r in router.step():
                got[r.id] = r
        out[pkg] = (_served([got[i] for i in ids]), router.stats,
                    [e.stats["forwards"] for e in engines])
    assert out["torch"] == out["jax"]


def test_refusals_and_no_ops_match():
    for pkg in PKG:
        serving = PKG[pkg][0]
        eng = _engine(pkg, _Clock(), max_queue=1)
        with pytest.raises(ValueError, match="empty"):
            eng.submit(serving.Request(prompt=[], max_new_tokens=1))
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit(serving.Request(prompt=[1] * (FEATURES + 1),
                                       max_new_tokens=1))
        eng.submit(serving.Request(prompt=[1, 2], max_new_tokens=1, id=7))
        with pytest.raises(ValueError, match="already in flight"):
            eng.submit(serving.Request(prompt=[1], max_new_tokens=1, id=7))
        with pytest.raises(serving.OverloadError):
            eng.submit(serving.Request(prompt=[1], max_new_tokens=1))
        assert eng.prefix_match_tokens([1, 2]) == 0
        assert eng.export_tree() == [] and eng.import_tree([]) == 0
        assert eng.import_handoff(None) is False
        assert eng.take_handoffs() == []
        assert [r.id for r, _ in eng.steal_queued(1)] == [7]
        eng.drain()
        assert eng.health()["state"] == "drained"
        with pytest.raises(serving.EngineDraining):
            eng.submit(serving.Request(prompt=[1], max_new_tokens=1))
