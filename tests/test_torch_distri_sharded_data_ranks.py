"""Rank bodies for tests/test_torch_distri_sharded_data.py, run by
parallel/launch.spawn: DistriOptimizer over `DataSet.sharded`, each
rank holding its own shard, with the model, data and schedule of the
JAX package's multi-process smoke (scripts/multihost_smoke.py's child).
This module imports neither JAX nor the JAX package: spawn re-imports
it in every rank.
"""

from unittest import mock

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.optim import Adam, Loss, Optimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.parallel import make_mesh
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer

GLOBAL_BATCH = 32
STEPS = 6


def smoke_elements():
    """The smoke's 128 samples: four separable classes of 32."""
    rng = np.random.RandomState(0)
    x = (rng.randn(128, 8).astype(np.float32)
         + np.repeat(np.eye(4, 8) * 3, 32, 0).astype(np.float32))
    y = np.repeat(np.arange(4), 32)
    return [Sample(x[i], int(y[i])) for i in range(128)]


def smoke_model():
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                         nn.LogSoftMax()).build(
        torch.Generator().manual_seed(0), device="cpu")


def smoke_optimizer(dataset, val, val_batch, end=None, val_trigger=None):
    return (Optimizer(smoke_model(), dataset, nn.ClassNLLCriterion(),
                      batch_size=GLOBAL_BATCH)
            .set_optim_method(Adam(learningrate=1e-2))
            .set_gradient_accumulation(2)
            .set_end_when(end or Trigger.max_iteration(STEPS))
            .set_validation(val_trigger or Trigger.several_iteration(3),
                            val, [Loss(nn.ClassNLLCriterion())], val_batch))


def recording_every_epoch(fired):
    """Trigger.every_epoch that appends (neval, epoch) to `fired` each
    time it fires."""
    every = Trigger.every_epoch()

    def fn(state):
        if every(state):
            fired.append((state["neval"], state["epoch"]))
            return True
        return False

    return Trigger(fn)


def recording_validation(cls):
    """A patch of `cls._validate` that also appends each result's
    (sum, count) of the Loss to the returned list."""
    seen = []
    validate = cls._validate

    def wrapped(self):
        out = validate(self)
        r = out["Loss"]
        seen.append((float(r.total), float(r.count)))
        return out

    return mock.patch.object(cls, "_validate", wrapped), seen


def rank_train_sharded(rank, world, val_batch, val_samples=33, epochs=None):
    """One rank of the smoke's run over its own shards, the exact
    (fp32) gradient wire: the flat params after STEPS steps (or
    `epochs` epochs, validating every epoch) and every validation's
    Loss (sum, count), and with `epochs` also the (neval, epoch) at
    each validation."""
    elements = smoke_elements()
    dataset = DataSet.sharded(elements, seed=3)
    val = DataSet.sharded(elements[:val_samples], seed=3)
    assert (dataset.pid, dataset.nproc) == (rank, world)
    fired = []
    if epochs is None:
        opt = smoke_optimizer(dataset, val, val_batch)
    else:
        opt = smoke_optimizer(dataset, val, val_batch,
                              Trigger.max_epoch(epochs),
                              recording_every_epoch(fired))
    mesh = make_mesh({"data": world}, device="cpu")
    patch, seen = recording_validation(DistriOptimizer)
    with patch:
        model = DistriOptimizer(opt, mesh, grad_dtype=None).run()
    flat = torch.cat([t.detach().reshape(-1)
                      for _, t in model.parameters()]).numpy()
    return (flat, seen) if epochs is None else (flat, seen, fired)


def oracle_run(world, val_batch, epochs=None):
    """One process on the explicitly assembled global batches: batch k
    is each rank's k-th run of GLOBAL_BATCH // world rows of its own
    shard's stream, concatenated in rank order (the JAX package's
    multi-process rule); validation over all 33 samples."""
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    elements = smoke_elements()
    local = GLOBAL_BATCH // world

    class Assembled(AbstractDataSet):
        def size(self):
            return len(elements)

        def data(self, train):
            streams = [DataSet.sharded(elements, process_id=r,
                                       process_count=world,
                                       seed=3).data(True)
                       for r in range(world)]
            while True:
                rows = [next(s) for s in streams for _ in range(local)]
                yield MiniBatch.from_samples(rows)

    fired = []
    if epochs is None:
        opt = smoke_optimizer(Assembled(), DataSet.array(elements[:33]),
                              val_batch)
    else:
        opt = smoke_optimizer(Assembled(), DataSet.array(elements[:33]),
                              val_batch, Trigger.max_epoch(epochs),
                              recording_every_epoch(fired))
    patch, seen = recording_validation(LocalOptimizer)
    with patch:
        model = LocalOptimizer(opt).run()
    flat = torch.cat([t.detach().reshape(-1)
                      for _, t in model.parameters()]).numpy()
    return (flat, seen) if epochs is None else (flat, seen, fired)
