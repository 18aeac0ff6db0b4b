"""MNIST loader.

Ports bigdl_tpu/dataset/mnist.py (reference: models/lenet/Utils.scala
`load` — IDX ubyte files, big-endian magic 2051/2049 — and the
`BytesToGreyImg >> GreyImgNormalizer >> GreyImgToSample` chain of
models/lenet/Train.scala). The IDX decoders are the numpy ones the JAX
package falls back to when its native data plane is not built.

`load_mnist(folder)` reads the standard IDX files if they are present
and downloads nothing; tests and the perf harness use `synthetic_mnist`.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN = 0.13066047740239436 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def decode_idx_images(raw: bytes) -> np.ndarray:
    """IDX3 bytes → (n, rows, cols) uint8."""
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    if magic != 2051:
        raise ValueError(f"bad IDX magic {magic}")
    buf = np.frombuffer(raw, np.uint8)
    return buf[16:16 + n * rows * cols].reshape(n, rows, cols).copy()


def decode_idx_labels(raw: bytes) -> np.ndarray:
    """IDX1 bytes → (n,) uint8."""
    magic, n = struct.unpack(">II", raw[:8])
    if magic != 2049:
        raise ValueError(f"bad IDX magic {magic}")
    return np.frombuffer(raw, np.uint8)[8:8 + n].copy()


def read_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        return decode_idx_images(f.read())


def read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        return decode_idx_labels(f.read())


def _find(folder: str, stem: str) -> str:
    for suffix in ("", ".gz"):
        p = os.path.join(folder, stem + suffix)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{stem} not found under {folder}")


def load_mnist(folder: str, train: bool = True) -> List[Sample]:
    """IDX MNIST as normalized (28, 28, 1) float Samples, int labels."""
    stem = "train" if train else "t10k"
    images = read_idx_images(_find(folder, f"{stem}-images-idx3-ubyte"))
    labels = read_idx_labels(_find(folder, f"{stem}-labels-idx1-ubyte"))
    mean, std = (TRAIN_MEAN, TRAIN_STD) if train else (TEST_MEAN, TEST_STD)
    feats = (images.astype(np.float32) - mean) / std
    return [Sample(feats[i][..., None], np.int32(labels[i]))
            for i in range(len(labels))]


def synthetic_mnist(n: int = 512, seed: int = 0,
                    separable: bool = True) -> List[Sample]:
    """Synthetic stand-in with class-dependent structure so models can
    learn (each class gets a distinct bright patch): the JAX package's
    draws, sample for sample."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        label = rng.randint(0, 10)
        img = rng.randn(28, 28).astype(np.float32) * 0.25
        if separable:
            r, c = divmod(label, 4)
            img[4 + r * 7:11 + r * 7, 2 + c * 6:9 + c * 6] += 2.0
        samples.append(Sample(img[..., None], np.int32(label)))
    return samples
