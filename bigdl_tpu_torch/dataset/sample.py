"""Sample and MiniBatch.

A copy of bigdl_tpu/dataset/sample.py (numpy only). Reference parity:
dataset/Sample.scala (feature+label tensor pair), dataset/MiniBatch.scala
(batched samples; `slice` for per-thread splits); the batcher lives in
transformer.py.

Host-side data is numpy; it becomes tensors on the model's device once
per step, in the optimizer loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Sample:
    """One training example: feature(s) + label(s)
    (reference: dataset/Sample.scala#Sample)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = np.asarray(feature) if not isinstance(feature, (tuple, list)) \
            else tuple(np.asarray(f) for f in feature)
        if label is None:
            self.label = None
        elif isinstance(label, (tuple, list)):
            self.label = tuple(np.asarray(l) for l in label)
        else:
            self.label = np.asarray(label)

    def feature_size(self):
        if isinstance(self.feature, tuple):
            return tuple(f.shape for f in self.feature)
        return self.feature.shape

    def label_size(self):
        if self.label is None:
            return None
        if isinstance(self.label, tuple):
            return tuple(l.shape for l in self.label)
        return self.label.shape

    def __repr__(self):
        return f"Sample(feature={self.feature_size()}, label={self.label_size()})"


def _stack_padded(arrays, pad_value, target_len=None):
    """np.stack, right-padding each array's first axis with `pad_value`
    to the common (or `target_len`) length when pad_value is given."""
    if pad_value is None:
        return np.stack(arrays)
    arrays = [np.asarray(a) for a in arrays]
    if arrays[0].ndim == 0:
        return np.stack(arrays)
    length = target_len if target_len is not None \
        else max(a.shape[0] for a in arrays)

    def pad(a):
        if a.shape[0] > length:
            raise ValueError(
                f"sample length {a.shape[0]} exceeds padding_length "
                f"{length}")
        if a.shape[0] == length:
            return a
        widths = [(0, length - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=pad_value)

    return np.stack([pad(a) for a in arrays])


class MiniBatch:
    """A batch of stacked samples (reference: dataset/MiniBatch.scala).

    `input`/`target` are numpy arrays (or tuples of arrays for multi-IO).
    `slice(offset, length)` mirrors the reference's per-thread split API.
    """

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    @staticmethod
    def from_samples(samples: Sequence[Sample],
                     pad_to: Optional[int] = None,
                     feature_padding: Optional[float] = None,
                     label_padding: Optional[float] = None,
                     padding_length: Optional[int] = None) -> "MiniBatch":
        """Stack samples; optionally right-pad the batch dim to `pad_to` by
        repeating the last sample (keeps jit shapes static for the final
        partial batch — the reference instead drops or shrinks).

        `feature_padding`/`label_padding` enable variable-length stacking
        (reference: dataset/PaddingParam.scala via SampleToMiniBatch):
        each array is right-padded along its first axis with the given
        value to the batch max — or to `padding_length` when set (fixed
        length keeps jit shapes static across batches)."""
        n = len(samples)
        if padding_length is not None and feature_padding is None \
                and label_padding is None:
            raise ValueError(
                "padding_length needs feature_padding and/or "
                "label_padding to supply the pad value")
        if pad_to is not None and n < pad_to:
            samples = list(samples) + [samples[-1]] * (pad_to - n)

        def stack(get, pad_value):
            first = get(samples[0])
            if first is None:
                return None
            if isinstance(first, tuple):
                return tuple(
                    _stack_padded([get(s)[i] for s in samples], pad_value,
                                  padding_length)
                    for i in range(len(first)))
            return _stack_padded([get(s) for s in samples], pad_value,
                                 padding_length)

        mb = MiniBatch(stack(lambda s: s.feature, feature_padding),
                       stack(lambda s: s.label, label_padding))
        mb.real_size = n
        return mb

    @property
    def size(self) -> int:
        first = self.input[0] if isinstance(self.input, tuple) else self.input
        return first.shape[0]

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """0-based slice along batch (reference MiniBatch.slice is 1-based)."""

        def cut(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(e[offset:offset + length] for e in x)
            return x[offset:offset + length]

        return MiniBatch(cut(self.input), cut(self.target))

    def __repr__(self):
        shp = (tuple(i.shape for i in self.input)
               if isinstance(self.input, tuple) else self.input.shape)
        return f"MiniBatch(input={shp}, size={self.size})"
