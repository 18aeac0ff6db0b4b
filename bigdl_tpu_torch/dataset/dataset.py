"""DataSet abstractions.

Ports `AbstractDataSet`, `LocalDataSet` and `DataSet.array` from
bigdl_tpu/dataset/dataset.py (reference:
dataset/DataSet.scala — in-memory array, `data(train=)` iterator
contract, per-epoch shuffle). Each epoch's permutation is
`np.random.RandomState(seed + epoch)`, exactly the JAX package's, so
both packages see the same batches in the same order. The sharded,
prefetching and record-file datasets and transformer chains
(`transform`, `>>`) are queued (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class AbstractDataSet:
    """`data(train)` iterator + `size()` (reference:
    dataset/DataSet.scala). No shuffle(): data(train=True) derives each
    epoch's permutation from (seed, epoch) statelessly."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


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


class DataSet:
    """Factory namespace (reference: dataset/DataSet object)."""

    @staticmethod
    def array(elements: Sequence, seed: int = 1) -> LocalDataSet:
        return LocalDataSet(elements, seed=seed)
