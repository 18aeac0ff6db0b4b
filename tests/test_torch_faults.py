"""The port's fault plans (bigdl_tpu_torch/utils/faults.py) and anomaly
guard (bigdl_tpu_torch/utils/anomaly.py) against the JAX package's
(bigdl_tpu/utils/faults.py, bigdl_tpu/utils/anomaly.py), on the same
specs, batches and health sequences.

Tolerances: parsing, firing, poisoning, file damage and the guard's
actions are host-side Python and numpy, so they agree exactly (the
guard's EMA threshold to the last bit: the same float arithmetic).
`global_norm` within 1e-6 relative (fp32 sums in another order);
`health_ok` exactly. The fault plan is process-global: every test
leaves both packages' plans unset."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.utils import anomaly as janomaly
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch.dataset.sample import MiniBatch as TMiniBatch
from bigdl_tpu_torch.utils import anomaly as tanomaly
from bigdl_tpu_torch.utils import faults as tfaults


@pytest.fixture(autouse=True)
def _no_plan():
    jfaults.set_plan(None)
    tfaults.set_plan(None)
    try:
        yield
    finally:
        jfaults.set_plan(None)
        tfaults.set_plan(None)


# ------------------------------------------------------------- FaultPlan

CONSULTS = [("nan", 4), ("nan", 4), ("nan", 5), ("ckpt_corrupt", 6),
            ("ckpt_corrupt", 6), ("ckpt_corrupt", 6), ("step", 7),
            ("preempt", 7), ("data", 0), ("data", 0), ("data", 0),
            ("serve_err", 2), ("serve_err", 2), ("nan", 4)]


@pytest.mark.parametrize("spec", [
    "", "nan@4,step@7,ckpt_corrupt@6x2", "data@0x3, preempt@7",
    "nan@4,nan@4", "serve_err@2x2,serve_nan@1,serve_slow@3",
    "ckpt_torn@1,ckpt_async_torn@2"])
def test_plan_fires_like_jax(spec):
    jp, tp = jfaults.FaultPlan(spec), tfaults.FaultPlan(spec)
    assert bool(jp) == bool(tp)
    got = [(tp.fires(k, s), jp.fires(k, s)) for k, s in CONSULTS]
    assert [t for t, _ in got] == [j for _, j in got]
    assert tp.fired == jp.fired


@pytest.mark.parametrize("spec", ["frobnicate@3", "nan@", "nan4",
                                  "nan@4x", "NAN@4"])
def test_plan_rejects_bad_specs_like_jax(spec):
    with pytest.raises(ValueError) as j:
        jfaults.FaultPlan(spec)
    with pytest.raises(ValueError) as t:
        tfaults.FaultPlan(spec)
    assert str(t.value) == str(j.value)


def test_maybe_raise_and_preempt():
    plan = tfaults.FaultPlan("step@3,preempt@5")
    plan.maybe_raise("step", 2)
    with pytest.raises(tfaults.FaultInjected, match="step@3"):
        plan.maybe_raise("step", 3)
    plan.maybe_raise("step", 3)  # one shot
    with pytest.raises(tfaults.Preempted, match="preempt@5"):
        plan.maybe_preempt(5)
    assert issubclass(tfaults.Preempted, tfaults.FaultInjected)


def test_plan_from_env(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_VAR, "data@2,nan@1x2")
    monkeypatch.setenv(jfaults.ENV_VAR, "data@2,nan@1x2")
    tfaults.set_plan(None)
    jfaults.set_plan(None)
    tp, jp = tfaults.get_plan(), jfaults.get_plan()
    assert tp is tfaults.get_plan()  # built once, then kept
    assert [tp.fires(k, s) for k, s in CONSULTS + [("data", 2)] * 2] \
        == [jp.fires(k, s) for k, s in CONSULTS + [("data", 2)] * 2]
    assert tp.fired == jp.fired == [("data", 2)]
    planned = tfaults.FaultPlan("nan@1")
    tfaults.set_plan(planned)
    assert tfaults.get_plan() is planned


def test_serving_kinds_fire_in_the_engine_like_jax():
    """A plan arming every serving kind fires in the port's engine at
    the decode steps where it fires in the JAX engine: serve_nan
    poisons the lowest active slot, serve_err is retried once,
    serve_slow (no watchdog armed) only slows its step."""
    import jax

    import test_torch_engine_lifecycle as lc

    jm = lc.build_lm(**lc.CFG)
    variables = jm.init(jax.random.PRNGKey(0))
    tm = lc.TransformerLM(lc.TransformerConfig(**lc.CFG), device="cpu")
    params = lc.params_from_jax(jax.device_get(variables["params"]),
                                device="cpu")
    spec = "serve_nan@1,serve_err@2,serve_slow@3"
    fired, statuses = [], []
    for s, mod in zip(lc.sides((jm, variables, tm, params)),
                      (jfaults, tfaults)):
        plan = mod.FaultPlan(spec)
        mod.set_plan(plan)
        eng = s.engine(step_retries=1, retry_backoff_s=0.0)
        out = eng.run([s.m.Request(prompt=[i + 1, i + 2, i + 3],
                                   max_new_tokens=5) for i in range(3)])
        mod.set_plan(None)
        fired.append(plan.fired)
        statuses.append([(r.status, r.tokens) for r in out]
                        + [eng.stats["retries"]])
    assert fired[1] == fired[0] == [("serve_nan", 1), ("serve_err", 2),
                                    ("serve_slow", 3)]
    assert statuses[1] == statuses[0]
    assert statuses[1][0][0] == "poisoned" and statuses[1][-1] == 1


def test_poison_minibatch_like_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3).astype(np.float32)
    ids = np.arange(2, dtype=np.int32)
    y = np.zeros(2, np.int64)
    jmb, tmb = JMiniBatch((x, ids), y), TMiniBatch((x, ids), y)
    tmb.real_size = jmb.real_size = 1
    jout, tout = jfaults.poison_minibatch(jmb), tfaults.poison_minibatch(tmb)
    assert isinstance(tout, TMiniBatch) and tout.real_size == 1
    for a, b in zip(tout.input, jout.input):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert np.isnan(tout.input[0]).all()
    np.testing.assert_array_equal(tout.input[1], ids)
    np.testing.assert_array_equal(tout.target, y)
    np.testing.assert_array_equal(x, rng.__class__(0).rand(2, 3).astype(
        np.float32))  # the batch itself is untouched
    with pytest.raises(ValueError, match="no floating-point"):
        tfaults.poison_minibatch(TMiniBatch(
            np.arange(6, dtype=np.int32).reshape(2, 3), y))


@pytest.mark.parametrize("mode", ["truncate", "garble"])
def test_corrupt_file_like_jax(tmp_path, mode):
    data = np.random.RandomState(1).bytes(301)
    for d in ("j", "t"):
        (tmp_path / d).write_bytes(data)
    jfaults.corrupt_file(str(tmp_path / "j"), mode)
    tfaults.corrupt_file(str(tmp_path / "t"), mode)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert (tmp_path / "t").read_bytes() != data
    with pytest.raises(ValueError, match="shred"):
        tfaults.corrupt_file(str(tmp_path / "t"), "shred")


# ---------------------------------------------------------- AnomalyGuard

NAN, INF = float("nan"), float("inf")

# (guard kwargs, [(ok, gnorm, step), ...]): each policy, the spike
# warm-up, the consecutive budget and the rollback replay budget
STREAMS = {
    "skip_budget": (dict(policy="skip_step", max_consecutive=2),
                    [(True, 1.0, 0), (False, INF, 1), (False, NAN, 2),
                     (True, 1.5, 3), (False, INF, 4), (False, INF, 5),
                     (False, INF, 6)]),
    "halt": (dict(policy="halt"), [(True, 1.0, 0), (True, 2.0, 1),
                                   (False, NAN, 2)]),
    "rollback_replays": (dict(policy="rollback", max_consecutive=2),
                         [(False, NAN, 5), (True, 1.0, 3), (True, 1.0, 4),
                          (False, NAN, 5), (True, 1.0, 3), (True, 1.0, 4),
                          (False, NAN, 5)]),
    "rollback_progress": (dict(policy="rollback", max_consecutive=1),
                          [(False, NAN, 5), (True, 1.0, 5),
                           (False, NAN, 9), (True, 2.0, 9)]),
    "spike_warmup": (dict(spike_factor=10.0, ema_decay=0.5,
                          warmup_steps=3),
                     [(True, 1.0, 0), (True, 1.0, 1), (True, 1.0, 2),
                      (True, 3.0, 3), (False, 1e9, 4), (True, 2.5, 5),
                      (False, NAN, 6), (True, 0.5, 7)]),
}


def _stream(mod, kwargs, seq):
    g = mod.AnomalyGuard(**kwargs)
    out = []
    for ok, gnorm, step in seq:
        before = g.threshold()
        try:
            out.append((before, g.observe(ok, gnorm, step)))
        except mod.AnomalyError as e:
            out.append((before, "raised", str(e)))
            break
    return out, g.stats()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_guard_actions_like_jax(name):
    kwargs, seq = STREAMS[name]
    t_out, t_stats = _stream(tanomaly, kwargs, seq)
    j_out, j_stats = _stream(janomaly, kwargs, seq)
    assert t_out == j_out
    assert t_stats == j_stats


def test_guard_rejects_bad_config_like_jax():
    for kw in (dict(policy="explode"), dict(max_consecutive=0),
               dict(spike_factor=0.5)):
        with pytest.raises(ValueError) as j:
            janomaly.AnomalyGuard(**kw)
        with pytest.raises(ValueError) as t:
            tanomaly.AnomalyGuard(**kw)
        assert str(t.value) == str(j.value)
    assert tanomaly.POLICIES == janomaly.POLICIES


def test_global_norm_and_health_like_jax():
    rng = np.random.RandomState(2)
    arrs = [rng.randn(5, 7).astype(np.float32) * 3,
            rng.randn(11).astype(np.float32),
            rng.randn(2, 3, 4).astype(np.float32) * 1e-3]
    j = float(janomaly.global_norm([jnp.asarray(a) for a in arrs]))
    t = tanomaly.global_norm([torch.from_numpy(a) for a in arrs])
    assert t.dtype == torch.float32
    np.testing.assert_allclose(float(t), j, rtol=1e-6, atol=0)
    bf = tanomaly.global_norm([torch.from_numpy(arrs[0]).bfloat16()])
    assert bf.dtype == torch.float32
    for loss, gnorm, thr in ((1.0, 2.0, INF), (NAN, 2.0, INF),
                             (1.0, NAN, INF), (1.0, 5.0, 4.0),
                             (INF, 1.0, INF), (1.0, INF, INF),
                             (-3.0, 4.0, 4.0)):
        want = bool(janomaly.health_ok(jnp.float32(loss), jnp.float32(gnorm),
                                       jnp.float32(thr)))
        got = tanomaly.health_ok(torch.tensor(loss), torch.tensor(gnorm),
                                 thr)
        assert got.dtype == torch.bool and bool(got) == want
    assert math.isinf(tanomaly.AnomalyGuard().threshold())
