"""Host batch producers: the Python plane of the JAX package's data
plane.

Ports `Prefetcher` and `FilePrefetcher` (with `_per_channel`) from
bigdl_tpu/dataset/native.py as the numpy worker threads that file runs
when its C++ library (native/dataplane.cpp, bound there by ctypes) is
absent. The C++ plane is not bound here: `.native` is always False.
The workers copy the JAX package's Python plane line for line — the
same `RandomState(seed)` draws in the same order (each epoch's
permutation, then per image `randint(-pad, pad + 1, 2)` for the shift,
then `rand(n) < 0.5` for the flips) — so both packages produce the same
batches, bit for bit.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Sequence, Tuple

import numpy as np


def _per_channel(vals, c, what) -> np.ndarray:
    """Validate/broadcast a per-channel vector to exactly c entries."""
    arr = np.asarray(vals, np.float32).reshape(-1)
    if arr.size == 1:
        arr = np.full((c,), float(arr[0]), np.float32)
    if arr.size != c:
        raise ValueError(
            f"{what} has {arr.size} entries for {c} channels")
    return np.ascontiguousarray(arr)


class _Worker:
    """One daemon thread filling a bounded queue with
    `self._produce()`'s batches until `close()`."""

    native = False

    def _start(self, capacity: int, seed: int) -> None:
        self._q = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._rng = np.random.RandomState(seed)
        self._t = threading.Thread(target=self._py_worker, daemon=True)
        self._t.start()

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._stop.is_set():
            # get() would block forever on a queue whose producer exited
            raise RuntimeError(f"{type(self).__name__} used after close()")
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self) -> None:
        """Stop the worker and wait for it: draining the queue lets a
        put() it is blocked in return, after which it sees the stop."""
        self._stop.set()
        while self._t.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)

    def __del__(self):  # pragma: no cover - best effort
        if getattr(self, "_t", None) is not None:
            self._stop.set()


def _shift(img, rng, pad, h, w, shifted):
    """Per image a random (dy, dx) in [-pad, pad] shift into the
    prefilled `shifted` (the JAX package's shift-crop)."""
    for j in range(len(img)):
        dy, dx = rng.randint(-pad, pad + 1, 2)
        y0, y1 = max(0, dy), min(h, h + dy)
        x0, x1 = max(0, dx), min(w, w + dx)
        shifted[j, y0:y1, x0:x1] = img[j, y0 - dy:y1 - dy, x0 - dx:x1 - dx]
    return shifted


class Prefetcher(_Worker):
    """Batch producer over an in-memory u8 dataset: (images f32
    (B, H, W, C), labels i32 (B,)) batches, shuffled every epoch,
    normalized, optionally shift-crop/hflip augmented, by a worker
    thread into a bounded queue. `n_threads` is the C++ plane's
    worker count, kept for the JAX package's signature."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, mean: Sequence[float],
                 std: Sequence[float], pad: int = 0, hflip: bool = False,
                 n_threads: int = 2, capacity: int = 4, seed: int = 0):
        self.images = np.ascontiguousarray(images, np.uint8)
        if self.images.ndim == 3:  # greyscale → add channel dim
            self.images = self.images[..., None]
        self.labels = np.ascontiguousarray(labels, np.int32)
        self.batch_size = batch_size
        n, h, w, c = self.images.shape
        self.shape = (h, w, c)
        self.mean = _per_channel(mean, c, "mean")
        self.std = _per_channel(std, c, "std")
        self.pad, self.hflip = pad, hflip
        self._start(capacity, seed)

    def _py_worker(self):
        n = len(self.labels)
        h, w, c = self.shape
        while not self._stop.is_set():
            order = self._rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                if self._stop.is_set():
                    return
                idx = order[i:i + self.batch_size]
                img = (self.images[idx].astype(np.float32) - self.mean) \
                    / self.std
                if self.pad:
                    img = _shift(img, self._rng, self.pad, h, w,
                                 np.zeros_like(img))
                if self.hflip:
                    flips = self._rng.rand(len(idx)) < 0.5
                    img[flips] = img[flips, :, ::-1]
                self._q.put((img, self.labels[idx].copy()))


class FilePrefetcher(_Worker):
    """Batch producer over BDLS shard files (dataset/records.py format),
    read through `np.memmap`, so a dataset larger than RAM rides the OS
    page cache. out_dtype="u8" skips host normalization and yields raw
    u8 batches (a quarter of the host-to-device bytes; normalize on the
    device); its shifted borders are filled with the mean byte, which
    normalizes to the f32 plane's zero."""

    def __init__(self, paths, batch_size: int, mean: Sequence[float],
                 std: Sequence[float], pad: int = 0, hflip: bool = False,
                 n_threads: int = 4, capacity: int = 3, seed: int = 0,
                 out_dtype: str = "f32"):
        from bigdl_tpu_torch.dataset.records import HEADER_BYTES, read_header

        if out_dtype not in ("f32", "u8"):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', got "
                             f"{out_dtype!r}")
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = batch_size
        metas = [read_header(p) for p in self.paths]
        if len({m[1:] for m in metas}) != 1:
            raise ValueError("shards disagree on (h, w, c)")
        self.n = sum(m[0] for m in metas)
        self.shape = metas[0][1:]
        h, w, c = self.shape
        self.mean = _per_channel(mean, c, "mean")
        self.std = _per_channel(std, c, "std")
        self.pad, self.hflip = pad, hflip
        self.out_dtype = out_dtype
        rec = 4 + h * w * c
        self._maps = []
        self._starts = [0]
        for p, m in zip(self.paths, metas):
            self._maps.append(np.memmap(p, np.uint8, mode="r",
                                        offset=HEADER_BYTES
                                        ).reshape(m[0], rec))
            self._starts.append(self._starts[-1] + m[0])
        self._start(capacity, seed)

    def _record_batch(self, idx):
        h, w, c = self.shape
        starts = np.asarray(self._starts)
        out = np.empty((len(idx), 4 + h * w * c), np.uint8)
        for j, i in enumerate(idx):
            s = int(np.searchsorted(starts, i, side="right")) - 1
            out[j] = self._maps[s][i - starts[s]]
        lbl = out[:, :4].copy().view("<i4")[:, 0].astype(np.int32)
        img = out[:, 4:].reshape(len(idx), h, w, c)
        return img, lbl

    def _py_worker(self):
        h, w, c = self.shape
        while not self._stop.is_set():
            order = self._rng.permutation(self.n)
            for i in range(0, self.n - self.batch_size + 1,
                           self.batch_size):
                if self._stop.is_set():
                    return
                raw, lbl = self._record_batch(order[i:i + self.batch_size])
                img = raw.copy() if self.out_dtype == "u8" else \
                    (raw.astype(np.float32) - self.mean) / self.std
                if self.pad:
                    if self.out_dtype == "u8":
                        shifted = np.empty_like(img)
                        shifted[:] = np.clip(self.mean + 0.5, 0,
                                             255).astype(np.uint8)
                    else:
                        shifted = np.zeros_like(img)
                    img = _shift(img, self._rng, self.pad, h, w, shifted)
                if self.hflip:
                    flips = self._rng.rand(len(img)) < 0.5
                    img[flips] = img[flips, :, ::-1]
                self._q.put((img, lbl))
