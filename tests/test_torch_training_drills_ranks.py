"""Rank bodies for the port's training-drill tests, run by
parallel/launch.spawn: `rank_recover_after_async_save` for
tests/test_torch_async_save_recovery.py, through the port script's
(bigdl_tpu_torch/scripts/fault_drill.py) `_train`, the drill MLP
carrying the JAX model's initial weights. This module imports neither
JAX nor the JAX package: spawn re-imports it in every rank.
"""

import os
from unittest import mock

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.scripts import fault_drill
from bigdl_tpu_torch.utils import faults


def rank_recover_after_async_save(rank, world, workdir, weights):
    """One rank of three mesh runs with an asynchronous sharded save at
    step 2: a clean run, a step fault at step 2 (retried from the
    checkpoint) and a NaN at step 2 under the 'rollback' guard. Rank
    0's writer starts late and the other ranks test for a checkpoint
    late, so that, unless every rank drains before it decides, rank 0
    finds no checkpoint while the others find the one rank 0 published
    in between. Each run's flat params."""
    import time

    import torch

    from bigdl_tpu_torch.serialization.checkpoint import Checkpoint

    torch.set_num_threads(1)
    write, latest = Checkpoint._write_sharded, Checkpoint.latest

    def late_write(self, *args, **kwargs):
        time.sleep(0.5)
        return write(self, *args, **kwargs)

    def late_latest(self, *args, **kwargs):
        time.sleep(1.0)
        return latest(self, *args, **kwargs)

    fault_drill.configure("cpu", train=weights)
    out = {}
    for kind, plan, guard in (("clean", "", None), ("step", "step@2", None),
                              ("rollback", "nan@2", "rollback")):
        patch = (mock.patch.object(Checkpoint, "_write_sharded", late_write)
                 if rank == 0 else
                 mock.patch.object(Checkpoint, "latest", late_latest))
        with patch:
            try:
                out[kind], _, _ = fault_drill._train(
                    os.path.join(workdir, kind), 5, faults=plan,
                    guard=guard, mesh=True, ckpt_iter=2, tag=kind,
                    zero=2, sharded=True, async_save=True)
            finally:
                faults.set_plan(None)
                obs.reset_all()
    return out
