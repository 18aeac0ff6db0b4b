"""Evaluation and batch prediction.

Ports `Evaluator.test` and `Predictor.predict` / `predict_class` from
bigdl_tpu/optim/evaluator.py (reference: optim/Evaluator.scala,
optim/Predictor.scala, optim/LocalPredictor.scala). The forward runs
under `torch.no_grad()` on the device of the model's variables, so the
recurrent kernels take their inference variant. A ragged final batch is
padded by the batching (`SampleToMiniBatch` repeats the last sample)
and its padded rows are masked out of the metrics and cut from the
predictions (`real_size`).

`Evaluator(model, mesh=...)` evaluates data-parallel over a process
mesh (parallel/mesh.make_mesh), as the JAX package's `_test_mesh`:
each batch is padded to a multiple of the axis size by repeating its
last row, each rank runs `make_dp_eval_step` on its rows with a row
mask, and the masked statistics are summed over the axis, so padded
rows never count. `Predictor(bucket_sizes=...)`
pads a batch up to the smallest bucket that covers it, repeating its
last row as the JAX Predictor does, and cuts the padded rows from the
output; without buckets a batch runs at its own size (eager PyTorch
does not retrace, so the JAX Predictor's learned buckets and its
compile counter `n_traces` have nothing to save here).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.optimizer import _batch_iterator, _to_device
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult, reduce_stats)
from bigdl_tpu_torch.serving.bucketing import bucket_for, pad_rows


def _device_of(variables) -> torch.device:
    leaves = [t for t in tree_leaves(variables)
              if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _forward_batches(model: Module, dataset: AbstractDataSet,
                     batch_size: int, variables=None, policy=None,
                     rows_for=None):
    """(output, minibatch, device) for each batch of `dataset` in order,
    the forward under torch.no_grad() with `variables` (the model's own
    by default); with a precision `policy` the params and inputs are cast
    to its compute dtype and the output back. `rows_for(n)` gives the
    row count a batch of n rows is padded up to (edge rows)."""
    variables = model.variables if variables is None else variables
    device = _device_of(variables)
    with torch.no_grad():
        if policy is not None:
            variables = {**variables,
                         "params": policy.cast_to_compute(
                             variables["params"])}
        for mb in _batch_iterator(dataset, False, batch_size):
            x = mb.input
            if rows_for is not None:
                x = pad_rows(x, rows_for(mb.size))
            x = _to_device(x, device)
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
        self.model = model
        self.mesh = mesh
        self.axis = axis

    def test(self, dataset: AbstractDataSet,
             methods: Sequence[ValidationMethod],
             batch_size: int = 32) -> Dict[str, ValidationResult]:
        if self.mesh is not None:
            return self._test_mesh(dataset, methods, batch_size)
        return evaluate(self.model, dataset, methods, batch_size)

    def _test_mesh(self, dataset, methods, batch_size):
        import numpy as np

        from bigdl_tpu_torch.dataset.sample import MiniBatch
        from bigdl_tpu_torch.parallel.data_parallel import make_dp_eval_step
        from bigdl_tpu_torch.parallel.mesh import host_to_global

        model, mesh, axis = self.model, self.mesh, self.axis
        n = mesh.shape[axis]
        variables = model.variables
        eval_fn = make_dp_eval_step(model, methods, mesh, axis)
        results = [ValidationResult(0.0, 0.0, m.name) for m in methods]
        for mb in _batch_iterator(dataset, False, batch_size):
            real = getattr(mb, "real_size", mb.size)
            rows = -(-mb.size // n) * n
            if rows != mb.size:
                # filler rows repeat the batch's last row, so Loss-style
                # metrics' edge correction cancels them exactly
                mb = MiniBatch(pad_rows(mb.input, rows),
                               pad_rows(mb.target, rows))
            mask = (np.arange(rows) < real).astype(np.float32)
            stats = eval_fn(variables["params"], variables["state"],
                            host_to_global(mesh, mb.input, axis),
                            host_to_global(mesh, mb.target, axis),
                            host_to_global(mesh, mask, axis))
            for i, (s, c) in enumerate(stats):
                results[i] = results[i] + ValidationResult(float(s),
                                                           float(c))
        return {m.name: r for m, r in zip(methods, results)}


class Predictor:
    """Batch inference (reference: optim/Predictor.scala). `predict`
    returns the per-sample outputs stacked along the batch axis, on the
    model's device; `predict_class` their argmax ids. With
    `bucket_sizes` a batch is padded to its bucket; a pre-batched
    MiniBatch larger than every bucket runs at its own size."""

    def __init__(self, model: Module, batch_size: int = 32,
                 bucket_sizes: Optional[Sequence[int]] = None):
        self.model = model
        self.batch_size = batch_size
        self.bucket_sizes = tuple(sorted(bucket_sizes)) \
            if bucket_sizes else None
        if self.bucket_sizes and max(self.bucket_sizes) < batch_size:
            raise ValueError("largest bucket must cover batch_size")

    def _rows_for(self, n: int) -> int:
        if n > max(self.bucket_sizes):
            return n
        return bucket_for(n, self.bucket_sizes)

    def predict(self, dataset: AbstractDataSet) -> torch.Tensor:
        rows_for = self._rows_for if self.bucket_sizes else None
        outs = [out[:getattr(mb, "real_size", mb.size)]
                for out, mb, _ in _forward_batches(self.model, dataset,
                                                   self.batch_size,
                                                   rows_for=rows_for)]
        return torch.cat(outs, dim=0)

    def predict_class(self, dataset: AbstractDataSet) -> torch.Tensor:
        return torch.argmax(self.predict(dataset), dim=-1)


LocalPredictor = Predictor
