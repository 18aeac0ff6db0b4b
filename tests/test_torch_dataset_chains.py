"""The port's transformer chains and datasets
(bigdl_tpu_torch/dataset/transformer.py, dataset.py, native.py) against
the JAX package's (bigdl_tpu/dataset/): `>>`, `chain`,
`MapTransformer`, `TransformedDataSet` and `.transform` chaining,
`ShardedDataSet` and `PrefetchDataSet`, on the same seeded numpy data.

Tolerance: none — the host data plane is numpy in both packages, so
every train and eval sequence is equal bit for bit (the JAX package's
prefetcher on its Python plane, its C++ library masked as
tests/test_native_dataplane.py masks it). Every prefetcher is closed.
"""

import unittest.mock as mock

import numpy as np
import pytest

from bigdl_tpu.dataset import dataset as jdataset
from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import sample as jsample
from bigdl_tpu.dataset import transformer as jtransformer
from bigdl_tpu_torch.dataset import dataset as tdataset
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import sample as tsample
from bigdl_tpu_torch.dataset import transformer as ttransformer

PKGS = {"jax": (jdataset, jtransformer, jsample),
        "torch": (tdataset, ttransformer, tsample)}


def _take(it, n):
    return [next(it) for _ in range(n)]


def _samples(sample_mod, n=13, seed=0):
    rng = np.random.RandomState(seed)
    return [sample_mod.Sample(rng.randn(3).astype(np.float32),
                              np.int32(rng.randint(0, 5)))
            for _ in range(n)]


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x.input),
                                      np.asarray(y.input))
        np.testing.assert_array_equal(np.asarray(x.target),
                                      np.asarray(y.target))
        assert getattr(x, "real_size", None) == getattr(y, "real_size", None)


def _add(tr, k):
    """A transformer of package `tr` adding k to each element."""
    class Add(tr.Transformer):
        def apply(self, it):
            return (v + k for v in it)
    return Add()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rshift_chain_and_map_flatten(pkg):
    _, tr, _ = PKGS[pkg]
    a, b, c = _add(tr, 1), tr.MapTransformer(lambda v: v * 10), _add(tr, 2)
    for chained in ((a >> b) >> c, a >> (b >> c), tr.chain(a, b, c),
                    tr.chain(a >> b, c)):
        assert isinstance(chained, tr.ChainedTransformer)
        assert chained.stages == [a, b, c]
        assert list(chained(range(4))) == [12, 22, 32, 42]
    assert list(tr.chain()(iter([5]))) == [5]


def test_chains_match_jax():
    out = {}
    for pkg, (ds, tr, sm) in PKGS.items():
        pipe = tr.MapTransformer(lambda s, sm=sm: sm.Sample(
            s.feature * 2.0 + 1.0, s.label)) >> tr.SampleToMiniBatch(4)
        d = ds.DataSet.array(_samples(sm), seed=3) >> pipe
        assert isinstance(d, ds.TransformedDataSet) and d.size() == 13
        out[pkg] = (_take(d.data(train=True), 9), list(d.data(train=False)))
    _assert_batches_equal(out["jax"][0], out["torch"][0])
    _assert_batches_equal(out["jax"][1], out["torch"][1])
    assert len(out["torch"][1]) == 4
    assert out["torch"][1][-1].real_size == 1       # the padded tail


def test_transform_extends_the_chain_over_the_same_base():
    ds, tr, sm = PKGS["torch"]
    base = ds.DataSet.array(list(range(6)), seed=2)
    once = base.transform(_add(tr, 1))
    twice = once.transform(tr.MapTransformer(lambda v: v * 3))
    assert twice.base is base and isinstance(twice.transformer,
                                             tr.ChainedTransformer)
    assert list(twice.data(False)) == [(v + 1) * 3 for v in range(6)]
    jds, jtr, _ = PKGS["jax"]
    jtwice = (jds.DataSet.array(list(range(6)), seed=2) >> _add(jtr, 1)) \
        >> jtr.MapTransformer(lambda v: v * 3)
    assert _take(twice.data(True), 20) == _take(jtwice.data(True), 20)


@pytest.mark.parametrize("nproc", [1, 3, 4])
def test_sharded_partitions_and_matches_jax(nproc):
    elems = list(range(22))
    shards = {}
    for pkg, (ds, _, _) in PKGS.items():
        shards[pkg] = [ds.DataSet.sharded(elems, process_id=p,
                                          process_count=nproc, seed=5)
                       for p in range(nproc)]
    for j, t in zip(shards["jax"], shards["torch"]):
        assert t.size() == j.size() and t.total_size() == 22
        assert list(t.data(False)) == list(j.data(False))
        assert _take(t.data(True), 40) == _take(j.data(True), 40)
    # eval shards partition the elements; each epoch's train shards
    # partition that epoch's permutation
    evals = [list(s.data(False)) for s in shards["torch"]]
    assert sorted(sum(evals, [])) == elems
    per = [len(e) for e in evals]
    epoch0 = [_take(s.data(True), n) for s, n in zip(shards["torch"], per)]
    assert sorted(sum(epoch0, [])) == elems


def test_sharded_replays_statelessly_and_steps_in_lockstep():
    ds = tdataset.DataSet
    a = ds.sharded(list(range(10)), process_id=1, process_count=2, seed=7)
    first = a.data(True)
    consumed = _take(first, 15)                 # three epochs
    assert _take(a.data(True), 15) == consumed  # a new iterator replays
    other = _take(ds.sharded(list(range(10)), process_id=0, process_count=2,
                             seed=7).data(True), 15)
    # both processes draw one permutation per epoch (lockstep): epoch e
    # of rank 0 and rank 1 together are RandomState(7 + e)'s permutation
    for e in range(3):
        perm = np.random.RandomState(7 + e).permutation(10)
        assert consumed[5 * e:5 * e + 5] == list(perm[1::2])
        assert other[5 * e:5 * e + 5] == list(perm[0::2])


def test_sharded_defaults_to_the_process_group(tmp_path):
    import torch.distributed as dist

    s = tdataset.ShardedDataSet(list(range(5)))
    assert (s.pid, s.nproc) == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        s = tdataset.ShardedDataSet(list(range(5)))
        assert (s.pid, s.nproc) == (0, 1)
        s = tdataset.ShardedDataSet(list(range(5)), process_id=2,
                                    process_count=3)
        assert (s.pid, s.nproc) == (2, 3)     # explicit values win
    finally:
        dist.destroy_process_group()


def _prefetch(pkg, images, labels, **kw):
    if pkg == "jax":
        with mock.patch.object(jnative, "_load", return_value=None):
            d = jdataset.PrefetchDataSet(images, labels, **kw)
        assert not d.native
        return d
    # the port's C++ plane masked the same way: this holds the Python planes
    with mock.patch.object(tnative, "_load", return_value=None):
        return tdataset.PrefetchDataSet(images, labels, **kw)


@pytest.mark.parametrize("aug", [dict(), dict(pad=2, hflip=True)],
                         ids=["plain", "pad_hflip"])
def test_prefetch_dataset_matches_jax(aug):
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (20, 6, 5, 3), np.uint8)
    labels = rng.randint(0, 10, 20).astype(np.int32)
    kw = dict(batch_size=4, mean=[120.0, 110.0, 100.0],
              std=[60.0, 50.0, 40.0], seed=3, **aug)
    out = {}
    for pkg in ("jax", "torch"):
        d = _prefetch(pkg, images, labels, **kw)
        try:
            assert not d.native
            out[pkg] = (_take(d.data(True), 12), list(d.data(False)))
        finally:
            d.close()
    _assert_batches_equal(out["jax"][0], out["torch"][0])
    _assert_batches_equal(out["jax"][1], out["torch"][1])
    assert out["torch"][0][0].input.dtype == np.float32
    # 12 batches of 4 cover 2.4 epochs of 20: each epoch is a permutation
    seen = np.concatenate([b.target for b in out["torch"][0][:5]])
    assert sorted(seen.tolist()) == sorted(labels.tolist())


def test_prefetcher_close_stops_the_worker_and_refuses_next():
    images = np.zeros((8, 2, 2), np.uint8)
    with mock.patch.object(tnative, "_load", return_value=None):
        p = tnative.Prefetcher(images, np.arange(8), 2, [0.0], [1.0],
                               capacity=1)
    assert p.next()[0].shape == (2, 2, 2, 1)
    p.close()
    assert not p._t.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        p.next()
    with pytest.raises(ValueError, match="2 entries for 1 channels"):
        tnative.Prefetcher(images, np.arange(8), 2, [0.0, 1.0], [1.0])
