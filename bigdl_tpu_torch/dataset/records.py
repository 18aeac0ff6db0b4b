"""BDLS sharded record files — the disk-resident image dataset path.

Ports bigdl_tpu/dataset/records.py (the counterpart of the reference's
Hadoop sequence files partitioned across Spark executors; SURVEY.md
§2.4, §7 "input pipeline throughput"): fixed-size records in shards
on local or network storage, streamed by dataset/native.py's
`FilePrefetcher` so the host keeps the card fed without holding the
dataset in RAM. The format is the JAX package's, byte for byte, so a
shard written by either package is read by the other.

Format (one shard): 32-byte header
    magic "BDLS" | u32 version=1 | u64 n | u32 h | u32 w | u32 c | u32 0
then n records of [label i32 LE][h*w*c u8 HWC image].

Shards are written `{prefix}-{i:05d}-of-{k:05d}.bdls`; readers accept a
directory, a glob, or an explicit list.
"""

from __future__ import annotations

import glob as _glob
import os
import struct
from typing import Iterator, List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch

_HDR = struct.Struct("<4sIQIIII")
HEADER_BYTES = _HDR.size
MAGIC = b"BDLS"
VERSION = 1


def write_shards(images: np.ndarray, labels: np.ndarray, out_dir: str,
                 num_shards: int = 1, prefix: str = "data") -> List[str]:
    """Write (n, h, w, c) u8 images + int labels into BDLS shards."""
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim == 3:
        images = images[..., None]
    labels = np.asarray(labels, np.int32)
    n, h, w, c = images.shape
    if len(labels) != n:
        raise ValueError(f"{len(labels)} labels for {n} images")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    bounds = np.linspace(0, n, num_shards + 1).astype(np.int64)
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        path = os.path.join(
            out_dir, f"{prefix}-{s:05d}-of-{num_shards:05d}.bdls")
        with open(path, "wb") as f:
            f.write(_HDR.pack(MAGIC, VERSION, hi - lo, h, w, c, 0))
            # labels and images interleaved in one buffer a shard (the
            # records are fixed-size; one write)
            rec = np.zeros((hi - lo, 4 + h * w * c), np.uint8)
            rec[:, :4] = labels[lo:hi].astype("<i4").view(np.uint8) \
                .reshape(hi - lo, 4)
            rec[:, 4:] = images[lo:hi].reshape(hi - lo, -1)
            f.write(rec.tobytes())
        paths.append(path)
    return paths


def read_header(path: str) -> Tuple[int, int, int, int]:
    """(n, h, w, c) of one shard."""
    with open(path, "rb") as f:
        raw = f.read(_HDR.size)
    if len(raw) < _HDR.size:
        raise ValueError(f"{path}: not a BDLS v{VERSION} shard")
    magic, version, n, h, w, c, _ = _HDR.unpack(raw)
    if magic != MAGIC or version != VERSION:
        raise ValueError(f"{path}: not a BDLS v{VERSION} shard")
    return int(n), int(h), int(w), int(c)


def resolve_shards(spec, pattern: str = "*.bdls") -> List[str]:
    """Directory | glob | list of paths → sorted shard list (shared by
    the BDLS and TFRecord datasets; `pattern` is the in-directory
    glob)."""
    if isinstance(spec, (list, tuple)):
        paths = [os.fspath(p) for p in spec]
    elif os.path.isdir(spec):
        paths = _glob.glob(os.path.join(spec, pattern))
    else:
        paths = _glob.glob(spec)
    if not paths:
        raise FileNotFoundError(f"no {pattern} shards match {spec!r}")
    return sorted(paths)


class RecordFileDataSet(AbstractDataSet):
    """Disk-resident dataset streaming BDLS shards through
    `native.FilePrefetcher`.

    train=True yields augmented, normalized MiniBatches forever (epoch
    reshuffles inside the worker); train=False maps the shards once, in
    order, normalized only (a shard's last batch may be short).
    """

    def __init__(self, shards, batch_size: int, mean, std, pad: int = 0,
                 hflip: bool = False, n_threads: int = 4,
                 capacity: int = 3, seed: int = 0):
        from bigdl_tpu_torch.dataset import native

        self.paths = resolve_shards(shards)
        self.batch_size = batch_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._prefetcher = native.FilePrefetcher(
            self.paths, batch_size, mean, std, pad=pad, hflip=hflip,
            n_threads=n_threads, capacity=capacity, seed=seed)
        self.n = self._prefetcher.n
        self.shape = self._prefetcher.shape

    @property
    def native(self) -> bool:
        return self._prefetcher.native

    def size(self) -> int:
        return self.n

    def data(self, train: bool) -> Iterator:
        if train:
            def forever():
                while True:
                    img, lbl = self._prefetcher.next()
                    yield MiniBatch(img, lbl)
            return forever()

        def once():
            for path in self.paths:
                n, h, w, c = read_header(path)
                rec = 4 + h * w * c
                mm = np.memmap(path, np.uint8, mode="r",
                               offset=_HDR.size).reshape(n, rec)
                for i in range(0, n, self.batch_size):
                    chunk = np.asarray(mm[i:i + self.batch_size])
                    lbl = chunk[:, :4].copy().view("<i4")[:, 0]
                    img = chunk[:, 4:].reshape(-1, h, w, c)
                    yield MiniBatch(
                        (img.astype(np.float32) - self.mean) / self.std,
                        lbl.astype(np.int32))
        return once()

    def close(self) -> None:
        self._prefetcher.close()
