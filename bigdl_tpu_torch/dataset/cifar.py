"""CIFAR-10 loader.

Ports bigdl_tpu/dataset/cifar.py (reference: models/resnet/Utils.scala
`loadTrain`/`loadTest` — the binary version: each record is one label
byte and 3072 pixel bytes, data_batch_{1..5}.bin / test_batch.bin — and
the reference's normalization constants). The record decoder is the
numpy one the JAX package falls back to when its native data plane is
not built. Files are read only if present; nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

# reference models/resnet/Utils.scala: trainMean/trainStd (RGB order)
TRAIN_MEAN = np.asarray([125.30691805, 122.95039414, 113.86538318],
                        np.float32)
TRAIN_STD = np.asarray([62.99321928, 62.08870764, 66.70489964], np.float32)
_RECORD = 1 + 3072


def decode_cifar10(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records → (images uint8 NHWC, labels uint8)."""
    if len(raw) % _RECORD:
        raise ValueError(
            f"CIFAR decode failed: {len(raw)} bytes is not a whole "
            f"number of {_RECORD}-byte records")
    recs = np.frombuffer(raw, np.uint8).reshape(-1, _RECORD)
    chw = recs[:, 1:].reshape(-1, 3, 32, 32)
    return chw.transpose(0, 2, 3, 1).copy(), recs[:, 0].copy()


def _read_bin(path: str):
    with open(path, "rb") as f:
        imgs, labels = decode_cifar10(f.read())
    return imgs, labels.astype(np.int32)


def load_cifar10(folder: str, train: bool = True) -> List[Sample]:
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    samples: List[Sample] = []
    for fname in files:
        imgs, labels = _read_bin(os.path.join(folder, fname))
        feats = (imgs.astype(np.float32) - TRAIN_MEAN) / TRAIN_STD
        samples.extend(Sample(feats[i], labels[i])
                       for i in range(len(labels)))
    return samples


def synthetic_cifar10(n: int = 256, seed: int = 0) -> List[Sample]:
    """Learnable stand-in (a class-dependent channel offset): the JAX
    package's draws, sample for sample."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = rng.randint(0, 10)
        img = rng.randn(32, 32, 3).astype(np.float32) * 0.3
        img[:, :, label % 3] += 0.5 + 0.2 * label
        out.append(Sample(img, np.int32(label)))
    return out
