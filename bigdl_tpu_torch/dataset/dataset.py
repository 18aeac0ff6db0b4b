"""DataSet abstractions.

Ports bigdl_tpu/dataset/dataset.py (reference: dataset/DataSet.scala —
`LocalDataSet`, in-memory, with the `data(train=)` iterator contract
and a per-epoch shuffle; `CachedDistriDataSet`'s partitioned, cached,
per-partition shuffle as `ShardedDataSet`). Each epoch's permutation
is `np.random.RandomState(seed + epoch)`, exactly the JAX package's, so
both packages see the same batches in the same order. A transformer
chain attaches with `dataset.transform(t)` or `dataset >> t`
(`TransformedDataSet`); `PrefetchDataSet` streams augmented batches
from dataset/native.py's `Prefetcher`.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import ChainedTransformer, Transformer


class AbstractDataSet:
    """`data(train)` iterator + `size()` (reference:
    dataset/DataSet.scala). No shuffle(): data(train=True) derives each
    epoch's permutation from (seed, epoch) statelessly."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        """Attach a transformer chain (the reference's
        `dataset -> transformer`)."""
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "TransformedDataSet":
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset (reference: dataset/LocalArrayDataSet).

    train=True iterates forever over reshuffled epochs; train=False
    iterates once in order. Every data(train=True) call restarts the
    same epoch sequence (the epoch counter is local to the iterator)."""

    def __init__(self, elements: Sequence, seed: int = 1):
        self.elements = list(elements)
        self.seed = seed

    def size(self) -> int:
        return len(self.elements)

    def data(self, train: bool) -> Iterator:
        if not train:
            yield from self.elements
            return
        epoch = 0
        while True:
            perm = np.random.RandomState(
                self.seed + epoch).permutation(len(self.elements))
            for i in perm:
                yield self.elements[i]
            epoch += 1


def _process_group() -> tuple:
    """(rank, world size) of the initialised torch.distributed process
    group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedDataSet(AbstractDataSet):
    """Deterministic per-process shard of a dataset (reference:
    dataset/DataSet.scala#CachedDistriDataSet). Each process takes the
    strided shard `perm[pid::nproc]` of a permutation drawn from the
    shared seed + epoch, so processes stay in lockstep without
    coordination. `process_id`/`process_count` default to the
    torch.distributed rank and world size when a process group is
    initialised, and to 0 and 1 otherwise."""

    def __init__(self, elements: Sequence, process_id: Optional[int] = None,
                 process_count: Optional[int] = None, seed: int = 1):
        rank, world = _process_group()
        self.elements = list(elements)
        self.pid = rank if process_id is None else process_id
        self.nproc = world if process_count is None else process_count
        self.seed = seed

    def size(self) -> int:
        """The shard's size (the reference reports partition-local
        counts too)."""
        return len(range(self.pid, len(self.elements), self.nproc))

    def total_size(self) -> int:
        return len(self.elements)

    def data(self, train: bool) -> Iterator:
        if not train:
            for i in range(self.pid, len(self.elements), self.nproc):
                yield self.elements[i]
            return
        epoch = 0
        while True:
            perm = np.random.RandomState(self.seed + epoch).permutation(
                len(self.elements))
            for i in perm[self.pid::self.nproc]:
                yield self.elements[i]
            epoch += 1


class TransformedDataSet(AbstractDataSet):
    """A dataset with a transformer chain attached; a further
    `transform` extends the chain over the same base."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(
            self.base, ChainedTransformer(self.transformer, transformer))

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))


class DataSet:
    """Factory namespace (reference: dataset/DataSet object)."""

    @staticmethod
    def array(elements: Sequence, seed: int = 1) -> LocalDataSet:
        return LocalDataSet(elements, seed=seed)

    @staticmethod
    def sharded(elements: Sequence, **kw) -> ShardedDataSet:
        return ShardedDataSet(elements, **kw)


class PrefetchDataSet(AbstractDataSet):
    """In-memory u8 images streamed by dataset/native.py's `Prefetcher`
    (a worker thread shuffles, normalizes and augments batches into a
    bounded queue off the training thread). train=True streams forever;
    train=False iterates the raw arrays once, normalized only."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, mean, std, pad: int = 0,
                 hflip: bool = False, n_threads: int = 2,
                 capacity: int = 4, seed: int = 0):
        from bigdl_tpu_torch.dataset import native

        self._prefetcher = native.Prefetcher(
            images, labels, batch_size, mean, std, pad=pad, hflip=hflip,
            n_threads=n_threads, capacity=capacity, seed=seed)
        self.images = self._prefetcher.images
        self.labels = self._prefetcher.labels
        self.batch_size = batch_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    @property
    def native(self) -> bool:
        return self._prefetcher.native

    def size(self) -> int:
        return len(self.labels)

    def data(self, train: bool) -> Iterator:
        if train:
            def forever():
                while True:
                    img, lbl = self._prefetcher.next()
                    yield MiniBatch(img, lbl)
            return forever()

        def once():
            for i in range(0, len(self.labels), self.batch_size):
                img = self.images[i:i + self.batch_size]
                yield MiniBatch(
                    (img.astype(np.float32) - self.mean) / self.std,
                    self.labels[i:i + self.batch_size].copy())
        return once()

    def close(self) -> None:
        self._prefetcher.close()
