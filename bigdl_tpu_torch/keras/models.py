"""Keras-style Sequential with compile/fit/evaluate/predict.

Ports bigdl_tpu/keras/models.py (reference: the nn/keras model classes —
sugar that lowers onto the core `Optimizer`/`Evaluator`/`Predictor`
stack, not a separate trainer). The port's models take a `device` (None:
the card; "cpu" for the plain path on the host): the built module's
variables are placed there, and training, evaluation and prediction run
on it. `predict` returns a numpy array, as the JAX package's does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.keras.layers import KerasLayer
from bigdl_tpu_torch.optim import (
    Adam, Evaluator, Loss, Optimizer, Predictor, RMSprop, SGD, Top1Accuracy,
    Trigger,
)
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

_OPTIMIZERS = {
    "sgd": lambda: SGD(learningrate=0.01),
    "adam": lambda: Adam(),
    "rmsprop": lambda: RMSprop(),
}

_LOSSES = {
    "sparse_categorical_crossentropy": nn.CrossEntropyCriterion,
    "categorical_crossentropy": nn.CrossEntropyCriterion,
    "nll": nn.ClassNLLCriterion,
    "mse": nn.MSECriterion,
    "mean_squared_error": nn.MSECriterion,
    "binary_crossentropy": nn.BCECriterion,
}

_METRICS = {
    "accuracy": Top1Accuracy,
    "acc": Top1Accuracy,
    "loss": Loss,
}


class _Trainable:
    """compile/fit/evaluate/predict surface shared by keras.Sequential
    and the functional keras.Model — both lower onto the core
    Optimizer/Evaluator/Predictor stack."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._module = None
        self._optim = None
        self._criterion = None
        self._metrics = None

    def build(self):
        raise NotImplementedError

    def _placed(self, module):
        """`module` with its variables built on this model's device (the
        first time; trained or assigned variables stay)."""
        if module._variables is None:
            module.build(device=self.device)
        return module

    # ---- data adaptation (Model overrides for multi-input) ----------

    def _to_samples(self, x, y):
        xs = np.asarray(x)
        ys = np.asarray(y)
        return [Sample(xi, yi) for xi, yi in zip(xs, ys)]

    def _to_dataset(self, x, y) -> "DataSet":
        return DataSet.array(self._to_samples(x, y))

    # ---- training ---------------------------------------------------

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = ()):
        self._optim = _OPTIMIZERS[optimizer]() \
            if isinstance(optimizer, str) else optimizer
        self._criterion = _LOSSES[loss]() if isinstance(loss, str) else loss
        self._metrics = [_METRICS[m]() if isinstance(m, str) else m
                         for m in metrics]
        return self

    def fit(self, x, y, batch_size: int = 32, epochs: int = 1,
            validation_data=None, precision=None):
        if self._optim is None:
            raise RuntimeError("call compile() before fit()")
        module = self._placed(self.build())
        opt = (Optimizer(module, self._to_dataset(x, y), self._criterion,
                         batch_size=batch_size)
               .set_optim_method(self._optim)
               .set_end_when(Trigger.max_epoch(epochs)))
        if validation_data is not None and self._metrics:
            vx, vy = validation_data
            opt.set_validation(Trigger.every_epoch(),
                               self._to_dataset(vx, vy), self._metrics,
                               batch_size=batch_size)
        if precision is not None:
            opt.set_precision(precision)
        trained = opt.optimize()
        self._module = trained
        return self

    def evaluate(self, x, y, batch_size: int = 32) -> dict:
        module = self._placed(self.build())
        methods = self._metrics or [Loss(self._criterion
                                         or nn.ClassNLLCriterion())]
        res = Evaluator(module).test(self._to_dataset(x, y), methods,
                                     batch_size=batch_size)
        return {k: v.result()[0] for k, v in res.items()}

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        module = self._placed(self.build())
        samples = [Sample(f, np.int32(0))
                   for f in self._predict_features(x)]
        return Predictor(module, batch_size=batch_size).predict(
            DataSet.array(samples)).cpu().numpy()

    def _predict_features(self, x):
        return np.asarray(x)

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        return np.argmax(self.predict(x, batch_size), axis=-1)


class Sequential(_Trainable):
    """keras.models.Sequential-shaped builder; the first layer must carry
    `input_shape` (batch dim excluded, as in Keras)."""

    def __init__(self, layers: Optional[Sequence[KerasLayer]] = None,
                 device: DeviceLike = None):
        super().__init__(device)
        self.layers: List[KerasLayer] = []
        for l in layers or []:
            self.add(l)

    def add(self, layer: KerasLayer) -> "Sequential":
        if not self.layers and layer.input_shape is None:
            raise ValueError("first layer needs input_shape=...")
        self.layers.append(layer)
        self._module = None  # invalidate built module
        return self

    # ---- build ---------------------------------------------------------

    def build(self) -> nn.Sequential:
        if self._module is not None:
            return self._module
        seq = nn.Sequential()
        shape = self.layers[0].input_shape
        for layer in self.layers:
            if layer.input_shape is not None:
                shape = layer.input_shape
            m, shape = layer.build(shape)
            if m is not None:
                seq.add(m)
        self._module = seq
        self.output_shape = shape
        return seq

    @property
    def module(self) -> nn.Sequential:
        return self.build()

    def summary(self) -> str:
        lines = ["Layer (type)                 Output Shape"]
        shape = self.layers[0].input_shape
        for layer in self.layers:
            if layer.input_shape is not None:
                shape = layer.input_shape
            _, shape = layer.build(shape)
            lname = layer.name or type(layer).__name__
            lines.append(f"{lname:<29}{(None,) + tuple(shape)}")
        return "\n".join(lines)
