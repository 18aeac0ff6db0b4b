"""Evaluation and batch prediction.

Ports `Evaluator.test` and `Predictor.predict` / `predict_class` from
bigdl_tpu/optim/evaluator.py (reference: optim/Evaluator.scala,
optim/Predictor.scala, optim/LocalPredictor.scala). The forward runs
under `torch.no_grad()` on the device of the model's variables, so the
recurrent kernels take their inference variant. A ragged final batch is
padded by the batching (`SampleToMiniBatch` repeats the last sample)
and its padded rows are masked out of the metrics and cut from the
predictions (`real_size`).

Evaluating over a device mesh (`Evaluator(model, mesh=...)`) is not
ported (ROADMAP.md queue A.8). The JAX Predictor pads ragged batches up
to an already-compiled shape (`bucket_sizes`) and counts compilations
(`n_traces`): both serve XLA's retracing, which eager PyTorch does not
have, so they are left out and a batch runs at its own size.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.optimizer import _batch_iterator, _to_device
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult, reduce_stats)


def _device_of(variables) -> torch.device:
    leaves = [t for t in tree_leaves(variables)
              if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _forward_batches(model: Module, dataset: AbstractDataSet,
                     batch_size: int, variables=None, policy=None):
    """(output, minibatch, device) for each batch of `dataset` in order,
    the forward under torch.no_grad() with `variables` (the model's own
    by default); with a precision `policy` the params and inputs are cast
    to its compute dtype and the output back."""
    variables = model.variables if variables is None else variables
    device = _device_of(variables)
    with torch.no_grad():
        if policy is not None:
            variables = {**variables,
                         "params": policy.cast_to_compute(
                             variables["params"])}
        for mb in _batch_iterator(dataset, False, batch_size):
            x = _to_device(mb.input, device)
            out, _ = model.apply(
                variables, x if policy is None else policy.cast_to_compute(x),
                training=False)
            if policy is not None:
                out = policy.cast_to_output(out)
            yield out, mb, device


def evaluate(model: Module, dataset: AbstractDataSet,
             methods: Sequence[ValidationMethod], batch_size: int,
             variables=None, policy=None) -> Dict[str, ValidationResult]:
    """`methods` over `dataset`, each batch's padded rows masked out
    (`real_size`); `variables` and `policy` as in _forward_batches."""
    stats = []
    for out, mb, device in _forward_batches(model, dataset, batch_size,
                                            variables, policy):
        real = getattr(mb, "real_size", mb.size)
        tgt = _to_device(mb.target, device)
        stats.append([m.stats(out, tgt, real) for m in methods])
    return reduce_stats(methods, stats)


class Evaluator:
    """(reference: optim/Evaluator.scala#Evaluator.test)"""

    def __init__(self, model: Module, mesh=None, axis: str = "data"):
        if mesh is not None:
            raise NotImplementedError(
                "Evaluator(mesh=...): evaluation over a device mesh is not "
                "ported to bigdl_tpu_torch yet (ROADMAP.md, queue A.8)")
        self.model = model

    def test(self, dataset: AbstractDataSet,
             methods: Sequence[ValidationMethod],
             batch_size: int = 32) -> Dict[str, ValidationResult]:
        return evaluate(self.model, dataset, methods, batch_size)


class Predictor:
    """Batch inference (reference: optim/Predictor.scala). `predict`
    returns the per-sample outputs stacked along the batch axis, on the
    model's device; `predict_class` their argmax ids."""

    def __init__(self, model: Module, batch_size: int = 32):
        self.model = model
        self.batch_size = batch_size

    def predict(self, dataset: AbstractDataSet) -> torch.Tensor:
        outs = [out[:getattr(mb, "real_size", mb.size)]
                for out, mb, _ in _forward_batches(self.model, dataset,
                                                   self.batch_size)]
        return torch.cat(outs, dim=0)

    def predict_class(self, dataset: AbstractDataSet) -> torch.Tensor:
        return torch.argmax(self.predict(dataset), dim=-1)


LocalPredictor = Predictor
