"""Spark-ML-Pipeline-shaped estimator API.

Ports bigdl_tpu/ml/estimator.py (reference: org.apache.spark.ml.
{DLEstimator, DLModel, DLClassifier, DLClassifierModel}):
`DLEstimator.fit(df)` trains the wrapped model and criterion over a
DataFrame's feature and label columns through the Optimizer and
returns a `DLModel`; `DLModel.transform(df)` appends a prediction
column. The "DataFrame" is columnar host data: a pandas DataFrame or a
dict of numpy arrays or lists (pandas is optional). Training runs on
the device of the model's weights (a model not yet built is built on
the card). Distributed fitting (`set_mesh`) is not ported (ROADMAP.md
queue A.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.optim import (OptimMethod, Optimizer, Predictor, SGD,
                                   Trigger)


def _get_column(df, col: str) -> np.ndarray:
    # works for pandas DataFrames and plain dict-of-lists alike
    return np.asarray(list(df[col]))


def _set_column(df, col: str, values):
    """A copy of `df` with column `col` set to `values`: a pandas
    DataFrame stays one; anything else (or no pandas) becomes a dict."""
    try:
        import pandas as pd

        if isinstance(df, pd.DataFrame):
            out = df.copy()
            out[col] = list(values)
            return out
    except ImportError:
        pass
    out = dict(df)
    out[col] = list(values)
    return out


class DLEstimator:
    """(reference: org.apache.spark.ml.DLEstimator)"""

    def __init__(self, model: Module, criterion: Criterion,
                 feature_size: Sequence[int], label_size: Sequence[int],
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction"):
        self.model = model
        self.criterion = criterion
        self.feature_size = tuple(feature_size)
        self.label_size = tuple(label_size)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.batch_size = 32
        self.max_epoch = 10
        self.optim_method: OptimMethod = SGD(learningrate=1e-2)
        self._learning_rate: Optional[float] = None
        self.end_trigger: Optional[Trigger] = None

    # setters (reference: setBatchSize/setMaxEpoch/setLearningRate)
    def set_batch_size(self, v: int) -> "DLEstimator":
        self.batch_size = v
        return self

    def set_max_epoch(self, v: int) -> "DLEstimator":
        self.max_epoch = v
        return self

    def set_learning_rate(self, v: float) -> "DLEstimator":
        # stored and applied at fit() time, so the call order relative to
        # set_optim_method doesn't matter
        self._learning_rate = v
        self.optim_method.learningrate = v
        return self

    def set_optim_method(self, m: OptimMethod) -> "DLEstimator":
        self.optim_method = m
        return self

    def set_end_when(self, t: Trigger) -> "DLEstimator":
        self.end_trigger = t
        return self

    def set_mesh(self, mesh) -> "DLEstimator":
        raise NotImplementedError(
            "DLEstimator.set_mesh: distributed fitting is not ported to "
            "bigdl_tpu_torch yet (ROADMAP.md, queue A.8)")

    # ------------------------------------------------------------------ fit
    def _make_sample(self, feat, label) -> Sample:
        f = np.asarray(feat, np.float32).reshape(self.feature_size)
        return Sample(f, self._convert_label(label))

    def _convert_label(self, label):
        return np.asarray(label, np.float32).reshape(self.label_size)

    def fit(self, df) -> "DLModel":
        if self._learning_rate is not None:
            self.optim_method.learningrate = self._learning_rate
        feats = _get_column(df, self.features_col)
        labels = _get_column(df, self.label_col)
        samples = [self._make_sample(f, l) for f, l in zip(feats, labels)]
        trained = Optimizer(self.model, DataSet.array(samples),
                            self.criterion, batch_size=self.batch_size) \
            .set_optim_method(self.optim_method) \
            .set_end_when(self.end_trigger
                          or Trigger.max_epoch(self.max_epoch)).optimize()
        return self._make_model(trained)

    def _make_model(self, trained: Module) -> "DLModel":
        return DLModel(trained, self.feature_size,
                       features_col=self.features_col,
                       prediction_col=self.prediction_col,
                       batch_size=self.batch_size)


class DLModel:
    """(reference: org.apache.spark.ml.DLModel) transform = batch
    predict; the predictions come back to the host as numpy."""

    def __init__(self, model: Module, feature_size: Sequence[int],
                 features_col: str = "features",
                 prediction_col: str = "prediction", batch_size: int = 32):
        self.model = model
        self.feature_size = tuple(feature_size)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = batch_size

    def _predictions(self, df) -> np.ndarray:
        feats = _get_column(df, self.features_col)
        samples = [Sample(np.asarray(f, np.float32).reshape(
            self.feature_size), np.float32(0)) for f in feats]
        out = Predictor(self.model, self.batch_size).predict(
            DataSet.array(samples))
        return out.float().cpu().numpy()

    def transform(self, df):
        return _set_column(df, self.prediction_col, self._predictions(df))


class DLClassifier(DLEstimator):
    """(reference: org.apache.spark.ml.DLClassifier) int class labels in
    [0, C); the prediction column is the argmax class id."""

    def __init__(self, model: Module, criterion: Criterion,
                 feature_size: Sequence[int], **kw):
        super().__init__(model, criterion, feature_size, label_size=(), **kw)

    def _convert_label(self, label):
        return np.int32(label)

    def _make_model(self, trained: Module) -> "DLClassifierModel":
        return DLClassifierModel(trained, self.feature_size,
                                 features_col=self.features_col,
                                 prediction_col=self.prediction_col,
                                 batch_size=self.batch_size)


class DLClassifierModel(DLModel):
    def transform(self, df):
        preds = np.argmax(self._predictions(df), axis=-1)
        return _set_column(df, self.prediction_col, preds)
