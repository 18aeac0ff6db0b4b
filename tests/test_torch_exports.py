"""Package-level names of the port against the JAX package's (ROADMAP.md
C.3): `ops` exports the flash-attention functions, `utils` and
`serving` their ported names, `InferenceEngine(model)` takes the
model's own variables, and `Predictor(bucket_sizes=...)` pads to the
bucket and cuts the padded rows as the JAX Predictor does.

Tolerances: attention outputs 1e-5 absolute (fp32); predictions 1e-5.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu_torch.ops as tops
import bigdl_tpu_torch.serving as tserving
import bigdl_tpu_torch.utils as tutils
from bigdl_tpu import ops as jops
from bigdl_tpu import serving as jserving
from bigdl_tpu import utils as jutils

TOL = 1e-5


@pytest.mark.parametrize("pkg, names", [
    ("ops", ["attention_reference", "flash_attention",
             "flash_attention_with_lse", "bilstm_scan", "gru_scan",
             "lstm_scan"]),
    ("utils", ["Table", "T", "AnomalyError", "AnomalyGuard",
               "FaultInjected", "FaultPlan", "precision", "Engine", "Shape",
               "redirect_logs", "profiler"]),
    ("serving", ["bucket_for", "default_buckets", "pad_tokens", "pad_rows",
                 "sample_logits", "filter_logits", "InferenceEngine"]),
])
def test_names_import_from_both_packages(pkg, names):
    j = importlib.import_module(f"bigdl_tpu.{pkg}")
    t = importlib.import_module(f"bigdl_tpu_torch.{pkg}")
    for name in names:
        jv, tv = getattr(j, name), getattr(t, name)
        # a function in one is a function in the other, a module a module
        assert callable(jv) == callable(tv), name
        assert isinstance(jv, types.ModuleType) == isinstance(
            tv, types.ModuleType), name


@pytest.mark.parametrize("causal", [False, True])
def test_ops_flash_attention_is_the_function(causal):
    from bigdl_tpu_torch.ops import flash_attention

    assert callable(flash_attention)
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 2, 16, 32).astype(np.float32) for _ in range(3))
    want = jops.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    out, lse = tops.flash_attention_with_lse(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert lse.shape == (2, 2, 16)
    # the module is still reachable by its full name
    mod = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    assert mod.flash_attention is flash_attention


# the JAX serving plane's names whose modules wait for ROADMAP.md queue
# A.9's next slice (distill, vision, scenarios, sim)
SERVING_WAITING = {"DraftDistiller", "VisionEngine", "CostModel",
                   "SimulatedEngine", "BUILTIN_SCENARIOS",
                   "compile_scenario", "load_scenario", "list_scenarios"}


@pytest.mark.parametrize("pkg", ["obs", "serving"])
def test_obs_and_serving_export_the_reference_names(pkg):
    """`obs` exports exactly the JAX package's names; `serving` every
    one of them but the modules still waiting, and each is the same kind
    of object (class, function, module, constant) in both."""
    j = importlib.import_module(f"bigdl_tpu.{pkg}")
    t = importlib.import_module(f"bigdl_tpu_torch.{pkg}")
    want = set(j.__all__) - (SERVING_WAITING if pkg == "serving" else set())
    have = set(t.__all__)
    if pkg == "obs":
        assert have == want
    else:
        assert want <= have
        assert SERVING_WAITING.isdisjoint(have)
    for name in sorted(want):
        jv, tv = getattr(j, name), getattr(t, name)
        assert isinstance(jv, type) == isinstance(tv, type), name
        assert callable(jv) == callable(tv), name
        if not callable(jv) and not isinstance(jv, types.ModuleType):
            assert jv == tv, name


def test_utils_and_serving_exports_work():
    t = tutils.T(1, 2, a=3)
    assert t[1] == 1 and t["a"] == 3
    assert tutils.FaultPlan("nan@3").fires("nan", 3)
    assert isinstance(tutils.AnomalyGuard("skip_step"), tutils.AnomalyGuard)
    assert tserving.default_buckets(64) == jserving.default_buckets(64)
    assert tserving.bucket_for(17, (16, 32)) == jserving.bucket_for(17, (16,
                                                                          32))
    np.testing.assert_array_equal(tserving.pad_tokens([1, 2], 4),
                                  jserving.pad_tokens([1, 2], 4))
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(tserving.pad_rows(x, 5),
                                  jserving.pad_rows(x, 5))
    assert tutils.precision.DEFAULT_MIXED.compute_dtype == torch.bfloat16
    assert jutils.precision is not None


def test_engine_takes_the_models_variables():
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    model = TransformerLM(TransformerConfig(vocab_size=37, dim=16,
                                            num_heads=2, num_layers=1,
                                            max_len=32), device="cpu")
    model.build(torch.Generator().manual_seed(0), "cpu")
    eng = tserving.InferenceEngine(model, slots=2, device="cpu")
    assert eng.variables is model.variables
    explicit = tserving.InferenceEngine(model, model.variables, slots=2,
                                        device="cpu")
    req = [tserving.Request(prompt=[1, 2, 3], max_new_tokens=4)]
    a = eng.run(req)[0].tokens
    b = explicit.run([tserving.Request(prompt=[1, 2, 3],
                                       max_new_tokens=4)])[0].tokens
    assert list(a) == list(b) and len(a) == 4


@pytest.mark.parametrize("n, buckets", [(37, (8, 16)), (20, (16, 24)),
                                        (33, None)])
def test_predictor_bucket_sizes_as_jax(n, buckets):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import DataSet as JDataSet, Sample as JSample
    from bigdl_tpu.optim import Predictor as JPredictor
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import DataSet as TDataSet
    from bigdl_tpu_torch.dataset import Sample as TSample
    from bigdl_tpu_torch.models.convert import variables_from_jax
    from bigdl_tpu_torch.optim import Predictor as TPredictor

    rng = np.random.RandomState(n)
    xs = rng.rand(n, 6).astype(np.float32)
    jm = jnn.Sequential(jnn.Linear(6, 4), jnn.LogSoftMax())
    jm.build(jax.random.PRNGKey(0))
    tm = tnn.Sequential(tnn.Linear(6, 4), tnn.LogSoftMax())
    tm.variables = variables_from_jax(jm.variables, device="cpu")
    jout = JPredictor(jm, batch_size=8, bucket_sizes=buckets).predict(
        JDataSet.array([JSample(x, 0) for x in xs]))
    tp = TPredictor(tm, batch_size=8, bucket_sizes=buckets)
    rows, apply = [], tm.apply
    tm.apply = lambda v, x, **kw: (rows.append(x.shape[0]),
                                   apply(v, x, **kw))[1]
    tout = tp.predict(TDataSet.array([TSample(x, 0) for x in xs]))
    tm.apply = apply
    # every batch ran at its bucket (8 rows without buckets)
    assert set(rows) == {min(b for b in (buckets or (8,)) if b >= 8)}
    assert tout.shape == (n, 4)
    np.testing.assert_allclose(tout.numpy(), jout, atol=TOL, rtol=0)
    cls = tp.predict_class(TDataSet.array([TSample(x, 0) for x in xs]))
    np.testing.assert_array_equal(cls.numpy(), np.argmax(jout, -1))
    if buckets:
        with pytest.raises(ValueError, match="cover batch_size"):
            TPredictor(tm, batch_size=64, bucket_sizes=buckets)


def test_parallel_exports_equal_jax():
    """`bigdl_tpu_torch.parallel` exports the JAX package's names, each
    a function where the JAX one is a function and a class where it is
    a class (its submodules aside)."""
    import inspect

    import bigdl_tpu.parallel as jparallel

    import bigdl_tpu_torch.parallel as tparallel

    jnames = {n for n in dir(jparallel) if not n.startswith("_")
              and not isinstance(getattr(jparallel, n), types.ModuleType)}
    assert set(tparallel.__all__) == jnames
    for n in jnames:
        jv, tv = getattr(jparallel, n), getattr(tparallel, n)
        assert inspect.isclass(jv) == inspect.isclass(tv), n
        assert callable(jv) == callable(tv), n


def test_transformer_config_fields_equal_jax():
    import dataclasses

    from bigdl_tpu.models.transformer import TransformerConfig as JCfg

    from bigdl_tpu_torch.models.transformer import TransformerConfig

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(TransformerConfig) == fields(JCfg)
