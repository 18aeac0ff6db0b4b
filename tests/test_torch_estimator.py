"""The port's pipeline API (bigdl_tpu_torch/ml/estimator.py: DLEstimator,
DLModel, DLClassifier, DLClassifierModel) and `nn.MSECriterion` against
the JAX package's (bigdl_tpu/ml/estimator.py, nn/criterion.py):
tests/test_estimator.py's regression, classifier and transfer cases fit
by both packages from the same weights, over a dict-of-lists frame and
a pandas DataFrame, comparing the fitted weights and `transform`'s
prediction column.

Weights are drawn from a seed with numpy (shapes from
`jax.eval_shape`) and carried across with `params_from_jax`; both
packages shuffle the same way (`DataSet.array`'s seeded permutation).
Tolerances: fitted weights and regression predictions within 1e-4
(tests/test_torch_cnn_models.py's fp32 trajectory tolerance; the longest
fit here is 120 Adam steps); class predictions equal.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as jopt
from bigdl_tpu.ml import DLClassifier as JDLClassifier
from bigdl_tpu.ml import DLEstimator as JDLEstimator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.ml import DLClassifier as TDLClassifier
from bigdl_tpu_torch.ml import DLEstimator as TDLEstimator
from bigdl_tpu_torch.ml import estimator as testimator
from bigdl_tpu_torch.models.convert import params_from_jax, tree_leaves

KEY = jax.random.PRNGKey(0)
TOL = 1e-4


def _toy_df(n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.int64)
    return {"features": list(X), "label": list(y)}, X, y


def _frame(df, kind):
    if kind == "pandas":
        pd = pytest.importorskip("pandas")
        return pd.DataFrame(df)
    return df


def _pair(factory, seed=0):
    """One architecture in both packages on one seeded weight tree."""
    jm, tm = factory(jnn), factory(tnn)
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, KEY)
    jp = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32),
        shapes["params"])
    jm.variables = {"params": jp, "state": shapes["state"]}  # no leaves
    tm.variables = {"params": params_from_jax(jp, device="cpu"),
                    "state": tm.init(device="cpu")["state"]}
    return jm, tm


def _fit_both(factory, make, df, configure):
    jm, tm = _pair(factory)
    out = {}
    for pkg, m, nn, opt in (("jax", jm, jnn, jopt), ("torch", tm, tnn, topt)):
        est = configure(make[pkg](m, nn), opt)
        fitted = est.fit(df)
        out[pkg] = (fitted, fitted.transform(df))
    for a, b in zip(tree_leaves(out["torch"][0].model.variables["params"]),
                    jax.tree_util.tree_leaves(
                        out["jax"][0].model.variables["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    return out["jax"][1], out["torch"][1]


def test_mse_criterion_matches_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(
        np.float32)
    for avg in (True, False):
        j = jnn.MSECriterion(size_average=avg)(a, b)
        t = tnn.MSECriterion(size_average=avg)(torch.from_numpy(a),
                                               torch.from_numpy(b))
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


@pytest.mark.parametrize("frame", ["dict", "pandas"])
def test_regression_fit_matches_jax(frame):
    rng = np.random.RandomState(1)
    X = rng.randn(96, 3).astype(np.float32)
    y = X @ np.asarray([1.0, -2.0, 0.5], np.float32)
    df = _frame({"features": list(X), "label": list(y[:, None])}, frame)
    make = {"jax": lambda m, nn: JDLEstimator(m, nn.MSECriterion(), [3],
                                              [1]),
            "torch": lambda m, nn: TDLEstimator(m, nn.MSECriterion(), [3],
                                                [1])}
    jout, tout = _fit_both(
        lambda nn: nn.Sequential(nn.Linear(3, 1)), make, df,
        lambda e, opt: e.set_batch_size(32).set_optim_method(opt.Adam(5e-2))
        .set_max_epoch(40))
    tp = np.asarray(list(tout["prediction"]), np.float32).reshape(-1)
    jp = np.asarray(list(jout["prediction"]), np.float32).reshape(-1)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)
    assert float(((tp - y) ** 2).mean()) < 0.05
    assert type(tout) is type(df)


def _classifier_make():
    return {"jax": lambda m, nn: JDLClassifier(m, nn.ClassNLLCriterion(),
                                               [4]),
            "torch": lambda m, nn: TDLClassifier(m, nn.ClassNLLCriterion(),
                                                 [4])}


@pytest.mark.parametrize("frame", ["dict", "pandas"])
def test_classifier_fit_matches_jax(frame):
    df, X, y = _toy_df(128)
    df = _frame(df, frame)
    jout, tout = _fit_both(
        lambda nn: nn.Sequential(nn.Linear(4, 16), nn.ReLU(),
                                 nn.Linear(16, 2), nn.LogSoftMax()),
        _classifier_make(), df,
        lambda e, opt: e.set_batch_size(32).set_optim_method(opt.Adam(1e-2))
        .set_max_epoch(30))
    preds = np.asarray(list(tout["prediction"]))
    np.testing.assert_array_equal(preds, np.asarray(list(jout["prediction"])))
    assert (preds == y).mean() > 0.9 and len(preds) == 128
    assert list(tout["features"]) is not None and type(tout) is type(df)


def test_transfer_learning_matches_jax():
    """A composed Sequential (a body, a new head) fit through the
    classifier: tests/test_estimator.py's transfer case."""
    df, X, y = _toy_df(32)
    jout, tout = _fit_both(
        lambda nn: nn.Sequential(nn.Sequential(nn.Linear(4, 8), nn.ReLU()),
                                 nn.Linear(8, 2), nn.LogSoftMax()),
        _classifier_make(), df,
        lambda e, opt: e.set_batch_size(16).set_max_epoch(2))
    assert len(tout["prediction"]) == 32
    np.testing.assert_array_equal(np.asarray(tout["prediction"]),
                                  np.asarray(jout["prediction"]))


def test_frames_without_pandas(monkeypatch):
    """`_set_column` falls back to a dict when pandas cannot be
    imported, and keeps a pandas frame a frame when it can."""
    pd = pytest.importorskip("pandas")
    frame = pd.DataFrame({"a": [1, 2]})
    assert isinstance(testimator._set_column(frame, "b", [3, 4]),
                      pd.DataFrame)
    monkeypatch.setitem(sys.modules, "pandas", None)
    out = testimator._set_column({"a": [1, 2]}, "b", np.asarray([3, 4]))
    assert out == {"a": [1, 2], "b": [3, 4]}
    df, _, _ = _toy_df(8)
    _, tm = _pair(lambda nn: nn.Sequential(nn.Linear(4, 2),
                                           nn.LogSoftMax()))
    model = TDLClassifier(tm, tnn.ClassNLLCriterion(), [4]) \
        .set_batch_size(4).set_max_epoch(1).fit(df)
    got = model.transform(df)
    assert isinstance(got, dict) and len(got["prediction"]) == 8


def test_set_mesh_names_its_queue():
    _, tm = _pair(lambda nn: nn.Sequential(nn.Linear(4, 2)))
    with pytest.raises(NotImplementedError, match="A.8"):
        TDLEstimator(tm, tnn.MSECriterion(), [4], [2]).set_mesh(object())
