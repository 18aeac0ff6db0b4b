"""Transformer — preprocessing over iterators.

Ports `Transformer` and `SampleToMiniBatch` from
bigdl_tpu/dataset/transformer.py (numpy only; reference:
dataset/Transformer.scala, dataset/SampleToMiniBatch.scala). Each
transformer is `Iterator[A] -> Iterator[B]`, so transforms stay
streaming. Chaining (`>>`, `chain`) and `MapTransformer` are queued
(ROADMAP.md).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

from bigdl_tpu_torch.dataset.sample import MiniBatch


class Transformer:
    """Iterator→iterator transform (reference: dataset/Transformer.scala)."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))


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
