"""A step retry and an anomaly rollback that come while an
asynchronous sharded save is still in flight, on 2 gloo ranks
(parallel/launch.spawn; the rank body is
tests/test_torch_training_drills_ranks.py's
`rank_recover_after_async_save`, which imports no JAX).

Rank 0's writer is slowed and the other rank's test for a checkpoint
too, so that the save is published between the two ranks' tests: every
rank must still take the same branch (recover from the step-2
checkpoint) and end on the weights of the fault-free run, bitwise, as
the single-process drills do."""

import numpy as np
import pytest

import test_torch_training_drills as td
import test_torch_training_drills_ranks as ranks
from bigdl_tpu_torch.parallel.launch import spawn

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("async_recover")
    return spawn(ranks.rank_recover_after_async_save, WORLD,
                 str(base / "w"), str(base / "runs"), td.jax_weights(),
                 timeout=120)


@pytest.mark.parametrize("kind", ("step", "rollback"))
def test_recovery_decided_alike_on_every_rank(runs, kind):
    for r in runs:
        np.testing.assert_array_equal(r[kind], runs[0]["clean"])
