"""Data-parallel training of the port from BDLS record shards on the C++
data plane: DistriOptimizer at gloo world size 2 over RecordFileDataSet.

The C++ plane orders batches by its worker threads, so the ranks cannot
share one stream; each reads its own partition (`for_rank`: shards
`paths[rank::2]` at half the global batch). Records are labelled by
their index, so the labels a rank trains on say which records it read.

- At the default four worker threads each rank reads only its own
  shards and the two ranks read disjoint records; their weights end
  equal, and the epoch counter rolls over on the global record count.
  (Before the partition, both ranks read every shard: the membership
  check fails on that.)
- At one worker thread each partition's stream is deterministic, so the
  run is held, fp32 on the exact gradient wire, to LocalOptimizer over
  the global batches formed from the two partitions' batches, within
  2e-5 relative / 1e-6 absolute (the exact wire's tolerance in
  test_torch_distributed.py).

`for_rank` refuses fewer shards than ranks and a batch that does not
divide by them.

The ranks are spawned once (parallel/launch.spawn, a `file://`
rendezvous in the test's temporary directory); this module does not
import JAX.
"""

import numpy as np
import torch

N, SHARDS, BATCH, STEPS, SIZE = 64, 4, 16, 4, 8
MEAN, STD = [127.5] * 3, [64.0] * 3
EXACT = dict(rtol=2e-5, atol=1e-6)


def _write(d):
    from bigdl_tpu_torch.dataset import write_shards

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (N, SIZE, SIZE, 3), np.uint8)
    return write_shards(images, np.arange(N, dtype=np.int32), d, SHARDS)


def _opt(ds):
    from bigdl_tpu_torch import nn, optim

    model = nn.Sequential(nn.Reshape([SIZE * SIZE * 3]),
                          nn.Linear(SIZE * SIZE * 3, N), nn.LogSoftMax())
    model.build(torch.Generator().manual_seed(0), "cpu")
    return (optim.Optimizer(model, ds, nn.ClassNLLCriterion(),
                            batch_size=BATCH)
            .set_optim_method(optim.SGD(learningrate=0.5, momentum=0.9,
                                        dampening=0.0))
            .set_end_when(optim.Trigger.max_iteration(STEPS)))


def _records(shards, n_threads):
    from bigdl_tpu_torch.dataset import RecordFileDataSet

    return RecordFileDataSet(shards, BATCH, MEAN, STD, pad=1, hflip=True,
                             n_threads=n_threads)


def _flat(model):
    from bigdl_tpu_torch.models.convert import tree_leaves

    return np.concatenate([t.detach().numpy().reshape(-1)
                           for t in tree_leaves(model.variables["params"])])


def _rank(rank, world, shards):
    """Both runs on this rank: per thread count, the labels of the rows
    the rank trained on in each step, whether its partition rode the C++
    plane, its final weights and train state."""
    from bigdl_tpu_torch.parallel import DistriOptimizer, make_mesh

    out = {}
    for n_threads in (4, 1):
        seen = []

        class Tapped(DistriOptimizer):
            def _train_step(self, mb, *args):
                seen.append(self._feed(mb.target).numpy().copy())
                return super()._train_step(mb, *args)

        ds = _records(shards, n_threads)
        mesh = make_mesh({"data": world}, "cpu")
        try:
            opt = _opt(ds)
            loop = Tapped(opt, mesh, grad_dtype=None)
            loop.run()
        finally:
            ds.close()
        out[n_threads] = dict(seen=seen, native=loop.rank_dataset.native,
                              flat=_flat(opt.model),
                              state={k: opt.train_state[k] for k in
                                     ("epoch", "neval", "records")})
    return out


class _Batches:
    """A dataset of fixed MiniBatches (the reference run's stream)."""

    def __init__(self, mbs):
        self.mbs = mbs

    def size(self):
        return N

    def data(self, train):
        return iter(self.mbs)


def test_distri_reads_rank_partitions_of_the_cpp_plane(tmp_path):
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.parallel.launch import spawn

    shards = _write(str(tmp_path / "shards"))
    ranks = spawn(_rank, 2, str(tmp_path / "spawn"), shards)

    # four threads: each rank reads its own shards, and only those
    owned = [set(np.arange(N)[s * 16:(s + 1) * 16]) for s in range(SHARDS)]
    got = [set(np.concatenate(r[4]["seen"]).tolist()) for r in ranks]
    for r in range(2):
        assert ranks[r][4]["native"]
        assert len(ranks[r][4]["seen"]) == STEPS
        assert all(len(b) == BATCH // 2 for b in ranks[r][4]["seen"])
        assert got[r] <= owned[r] | owned[r + 2]
        assert ranks[r][4]["state"] == {"epoch": 2, "neval": STEPS,
                                        "records": 0}
    assert not got[0] & got[1]
    np.testing.assert_array_equal(ranks[0][4]["flat"], ranks[1][4]["flat"])

    # one thread: the run equals LocalOptimizer on the global batches
    parts = []
    for r in range(2):
        whole = _records(shards, 1)
        ds = whole.for_rank(r, 2)
        try:
            it = ds.data(True)
            parts.append([next(it) for _ in range(STEPS)])
        finally:
            ds.close()
            whole.close()
        assert [mb.target.tolist() for mb in parts[r]] == \
            [b.tolist() for b in ranks[r][1]["seen"]]
    batches = [MiniBatch(np.concatenate([a.input, b.input]),
                         np.concatenate([a.target, b.target]))
               for a, b in zip(*parts)]
    opt = _opt(_Batches(batches))
    opt.optimize()
    np.testing.assert_array_equal(ranks[0][1]["flat"], ranks[1][1]["flat"])
    np.testing.assert_allclose(ranks[0][1]["flat"], _flat(opt.model),
                               **EXACT)


def test_for_rank_refuses_what_it_cannot_split(tmp_path):
    import pytest

    shards = _write(str(tmp_path / "shards"))
    ds = _records(shards, 1)
    try:
        with pytest.raises(ValueError, match="4 record shards cannot be "
                           "split over 8 ranks"):
            ds.for_rank(0, 8)
        with pytest.raises(ValueError, match="batch_size 16 does not "
                           "divide by 3 ranks"):
            ds.for_rank(0, 3)
        part = ds.for_rank(1, 2)
        try:
            assert part.paths == ds.paths[1::2]
            assert part.batch_size == BATCH // 2 and part.size() == N // 2
        finally:
            part.close()
    finally:
        ds.close()
