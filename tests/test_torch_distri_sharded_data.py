"""DistriOptimizer on per-process shards (`DataSet.sharded`), as the
JAX package's multi-process path feeds them
(bigdl_tpu/parallel/distri_optimizer.py: each process reads its own
shard at batch_size // nproc, a global batch is every process's local
batch side by side; validation exchanges have-data flags every round
and an exhausted process feeds an all-masked copy of its last batch).

Spawned gloo ranks (the rank bodies are in
test_torch_distri_sharded_data_ranks.py) run the model, data and
schedule of scripts/multihost_smoke.py's child, on the exact fp32
gradient wire. An oracle in one process trains on the explicitly
assembled global batches and validates over all 33 samples. Tolerance:
fp32, params 1e-5 absolute (the ranks' all-reduced mean of local means
against one mean over the global batch, through 3 Adam updates);
validation loss sums 1e-4 relative, counts exact.
"""

import numpy as np
import pytest

from bigdl_tpu_torch.parallel.launch import spawn

import test_torch_distri_sharded_data_ranks as ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded_run(request, tmp_path_factory):
    world = request.param
    out = spawn(ranks.rank_train_sharded, world,
                str(tmp_path_factory.mktemp(f"sharded{world}")),
                ranks.GLOBAL_BATCH, timeout=120)
    return world, out, ranks.oracle_run(world, ranks.GLOBAL_BATCH)


def test_params_match_the_assembled_batch_oracle(sharded_run):
    _, out, (oracle, _) = sharded_run
    for flat, _ in out:
        np.testing.assert_array_equal(flat, out[0][0])
    np.testing.assert_allclose(out[0][0], oracle, rtol=0, atol=1e-5)


def test_validation_loss_covers_every_sample(sharded_run):
    _, out, (_, oracle_seen) = sharded_run
    assert len(oracle_seen) == 2
    assert [c for _, c in oracle_seen] == [33.0, 33.0]
    for _, seen in out:
        assert [c for _, c in seen] == [33.0, 33.0]
        np.testing.assert_allclose([s for s, _ in seen],
                                   [s for s, _ in oracle_seen], rtol=1e-4)


def test_uneven_validation_shards_finish(tmp_path):
    """33 samples on 4 ranks at a validation batch of 8: shards of 9,
    8, 8 and 8 read 2 rows a round, so rank 0 runs a fifth round that
    the others join with an all-masked batch."""
    out = spawn(ranks.rank_train_sharded, 4, str(tmp_path), 8, timeout=90)
    _, oracle_seen = ranks.oracle_run(4, 8)
    for _, seen in out:
        assert [c for _, c in seen] == [33.0, 33.0]
        np.testing.assert_allclose([s for s, _ in seen],
                                   [s for s, _ in oracle_seen], rtol=1e-4)


def test_an_empty_validation_shard_raises_on_every_rank(tmp_path):
    """3 validation samples on 4 ranks: rank 3's shard is empty, and
    every rank raises the JAX package's error (none waits alone)."""
    with pytest.raises(RuntimeError, match="empty validation shard"):
        spawn(ranks.rank_train_sharded, 4, str(tmp_path), 8, 3, timeout=90)


def test_an_epoch_is_one_pass_over_the_whole_set(tmp_path):
    """Trigger.max_epoch(2) with validation every epoch on 2 ranks: each
    rank counts its local rows against its shard's size, as each
    process of the JAX package does, so an epoch is 128 samples, 4
    steps of 16 rows a rank, and validation fires at steps 4 and 8."""
    out = spawn(ranks.rank_train_sharded, 2, str(tmp_path),
                ranks.GLOBAL_BATCH, 33, 2, timeout=120)
    oracle, oracle_seen, oracle_fired = ranks.oracle_run(
        2, ranks.GLOBAL_BATCH, epochs=2)
    assert oracle_fired == [(4, 2), (8, 3)]
    for flat, seen, fired in out:
        assert fired == oracle_fired
        assert [c for _, c in seen] == [33.0, 33.0]
        np.testing.assert_allclose([s for s, _ in seen],
                                   [s for s, _ in oracle_seen], rtol=1e-4)
        np.testing.assert_allclose(flat, oracle, rtol=0, atol=1e-5)
