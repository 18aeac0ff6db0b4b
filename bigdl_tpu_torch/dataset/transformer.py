"""Transformer — composable preprocessing over iterators.

Ports bigdl_tpu/dataset/transformer.py (numpy only; reference:
dataset/Transformer.scala, dataset/SampleToMiniBatch.scala). Each
transformer is `Iterator[A] -> Iterator[B]`, so transforms stay
streaming. Python has no `->` operator: `a >> b` (and `chain(a, b,
c)`) chains, flattening nested chains; `MapTransformer` lifts a
per-element function.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, List

from bigdl_tpu_torch.dataset.sample import MiniBatch


class Transformer:
    """Iterator→iterator transform (reference: dataset/Transformer.scala)."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """`a >> b` — the reference's `a -> b`."""
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    """Stages applied in order; a nested chain's stages are spliced in,
    so `(a >> b) >> c` and `a >> (b >> c)` hold [a, b, c]."""

    def __init__(self, *stages: Transformer):
        flat: List[Transformer] = []
        for s in stages:
            if isinstance(s, ChainedTransformer):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages = flat

    def apply(self, it: Iterator) -> Iterator:
        for s in self.stages:
            it = s.apply(it)
        return it


def chain(*stages: Transformer) -> ChainedTransformer:
    return ChainedTransformer(*stages)


class MapTransformer(Transformer):
    """Lift a per-element function into a transformer."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, it):
        return map(self.fn, it)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches
    (reference: dataset/SampleToMiniBatch.scala).

    partial="pad" keeps the trailing partial batch, padded to full size
    with `real_size` recorded (static shapes under jit);
    partial="drop" mirrors dropping it.
    """

    def __init__(self, batch_size: int, partial: str = "pad",
                 feature_padding=None, label_padding=None,
                 padding_length=None):
        """`feature_padding`/`label_padding`/`padding_length` stack
        variable-length samples by right-padding their first axis
        (reference: SampleToMiniBatch's featurePaddingParam /
        labelPaddingParam, dataset/PaddingParam.scala)."""
        if partial not in ("pad", "drop"):
            raise ValueError(f"partial must be 'pad' or 'drop', got "
                             f"{partial!r}")
        self.batch_size = batch_size
        self.partial = partial
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.padding_length = padding_length

    def apply(self, it):
        while True:
            group = list(itertools.islice(it, self.batch_size))
            if not group:
                return
            if len(group) < self.batch_size and self.partial == "drop":
                return
            yield MiniBatch.from_samples(
                group, pad_to=self.batch_size,
                feature_padding=self.feature_padding,
                label_padding=self.label_padding,
                padding_length=self.padding_length)
