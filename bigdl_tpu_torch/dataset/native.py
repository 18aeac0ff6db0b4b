"""Host batch producers and image kernels: the C++ data plane and its
Python fallback.

Ports bigdl_tpu/dataset/native.py. The C++ plane is the port's copy of
native/dataplane.cpp (`dataset/csrc/dataplane.cpp`), compiled at first
use with the JAX package's `g++` line into the git-ignored
`bigdl_tpu_torch/ops/build/` under a name hashed from the source and
the flags (as ops/_build.py names its libraries), and bound through
ctypes: `normalize_u8`, `resize_bilinear`, the IDX and CIFAR-10
decoders, `Prefetcher` (`bdl_prefetcher_*`) and `FilePrefetcher`
(`bdl_file_prefetcher_create`, `bdl_prefetcher_next_u8`).
`available()` keeps the reference's meaning: True when the library is
(or can be) built and loaded; without a toolchain every entry point
runs its Python plane, and each producer's `.native` says which plane
runs.

The Python plane copies the JAX package's line for line — the same
`RandomState(seed)` draws in the same order (each epoch's permutation,
then per image `randint(-pad, pad + 1, 2)` for the shift, then
`rand(n) < 0.5` for the flips) — so both packages' Python planes give
the same batches, bit for bit. The C++ plane draws from `std::mt19937`
in its worker threads, as the reference's does, so its stream order is
its own; each record in it is the Python plane's output for that record
and that record's shift and flip, bit for bit (the port's normalize
divides where the reference's multiplies by a reciprocal).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "dataplane.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "build"
# the JAX package's g++ line (bigdl_tpu/dataset/native.py `_build`)
_CXX = ("g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
        "-shared")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the plane's library is (or will be) built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX).encode())
    return _BUILD_DIR / f"libdataplane-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent builders (test
    # workers, ranks) never load a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([*_CXX, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def _bind(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bdl_normalize_u8.argtypes = [u8p, f32p, ctypes.c_int64,
                                     ctypes.c_int, f32p, f32p, ctypes.c_int]
    lib.bdl_hflip.argtypes = [f32p, u8p] + [ctypes.c_int] * 4
    lib.bdl_shift_crop.argtypes = [f32p, f32p, ip, ip] + [ctypes.c_int] * 4
    lib.bdl_resize_bilinear.argtypes = [f32p, f32p] + [ctypes.c_int] * 6
    lib.bdl_decode_idx_images.argtypes = [u8p, ctypes.c_int64, u8p, i64p,
                                          i64p, i64p]
    lib.bdl_decode_idx_images.restype = ctypes.c_int
    lib.bdl_decode_idx_labels.argtypes = [u8p, ctypes.c_int64, u8p, i64p]
    lib.bdl_decode_idx_labels.restype = ctypes.c_int
    lib.bdl_decode_cifar10.argtypes = [u8p, ctypes.c_int64, u8p, u8p, i64p]
    lib.bdl_decode_cifar10.restype = ctypes.c_int
    lib.bdl_prefetcher_create.argtypes = [
        u8p, i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, f32p, f32p]
    lib.bdl_prefetcher_create.restype = ctypes.c_void_p
    lib.bdl_prefetcher_next.argtypes = [ctypes.c_void_p, f32p, i32p]
    lib.bdl_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.bdl_file_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, i64p, ip, ip, ip]
    lib.bdl_file_prefetcher_create.restype = ctypes.c_void_p
    lib.bdl_prefetcher_next_u8.argtypes = [ctypes.c_void_p, u8p, i32p]
    return lib


def _load():
    """The bound library, built at first use; None when it cannot be
    built (no g++) — the Python plane then runs."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _lib_failed:
            so = _build()
            if so is None:
                _lib_failed = True
            else:
                _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def available() -> bool:
    """True if the C++ plane is (or can be) built and loaded."""
    return _load() is not None


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _per_channel(vals, c, what) -> np.ndarray:
    """Validate/broadcast a per-channel vector to exactly c entries (the
    C++ side reads exactly c floats)."""
    arr = np.asarray(vals, np.float32).reshape(-1)
    if arr.size == 1:
        arr = np.full((c,), float(arr[0]), np.float32)
    if arr.size != c:
        raise ValueError(
            f"{what} has {arr.size} entries for {c} channels")
    return np.ascontiguousarray(arr)


# ------------------------------------------------------------ functions
def normalize_u8(images: np.ndarray, mean: Sequence[float],
                 std: Sequence[float], n_threads: int = 4) -> np.ndarray:
    """u8 (..., C) → f32 (x - mean[c]) / std[c]; the C++ plane when it
    is available (the same bits either way)."""
    images = np.ascontiguousarray(images, np.uint8)
    c = images.shape[-1]
    mean = _per_channel(mean, c, "mean")
    std = _per_channel(std, c, "std")
    lib = _load()
    if lib is None:
        return (images.astype(np.float32) - mean) / std
    out = np.empty(images.shape, np.float32)
    lib.bdl_normalize_u8(_u8(images), _f32(out), images.size // c, c,
                         _f32(mean), _f32(std), n_threads)
    return out


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int,
                    n_threads: int = 1) -> Optional[np.ndarray]:
    """f32 HWC bilinear resize (align_corners=False) in C++, or None
    when the C++ plane is unavailable (the caller's numpy path runs)."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.bdl_resize_bilinear(_f32(img), _f32(out), h, w, c, out_h, out_w,
                            n_threads)
    return out


def decode_idx_images(raw: bytes) -> np.ndarray:
    """IDX (MNIST) image file bytes → u8 (n, rows, cols)."""
    lib = _load()
    buf = np.frombuffer(raw, np.uint8)
    if lib is None:
        import struct
        magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
        if magic != 2051:
            raise ValueError(f"bad IDX magic {magic}")
        return buf[16:16 + n * rows * cols].reshape(n, rows, cols).copy()
    n, rows, cols = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.bdl_decode_idx_images(_u8(buf), len(raw), None,
                                   ctypes.byref(n), ctypes.byref(rows),
                                   ctypes.byref(cols))
    if rc:
        raise ValueError(f"IDX image decode failed ({rc})")
    out = np.empty((n.value, rows.value, cols.value), np.uint8)
    lib.bdl_decode_idx_images(_u8(buf), len(raw), _u8(out),
                              ctypes.byref(n), ctypes.byref(rows),
                              ctypes.byref(cols))
    return out


def decode_idx_labels(raw: bytes) -> np.ndarray:
    """IDX (MNIST) label file bytes → u8 (n,)."""
    lib = _load()
    buf = np.frombuffer(raw, np.uint8)
    if lib is None:
        import struct
        magic, n = struct.unpack(">II", raw[:8])
        if magic != 2049:
            raise ValueError(f"bad IDX magic {magic}")
        return buf[8:8 + n].copy()
    n = ctypes.c_int64()
    rc = lib.bdl_decode_idx_labels(_u8(buf), len(raw), None,
                                   ctypes.byref(n))
    if rc:
        raise ValueError(f"IDX label decode failed ({rc})")
    out = np.empty((n.value,), np.uint8)
    lib.bdl_decode_idx_labels(_u8(buf), len(raw), _u8(out),
                              ctypes.byref(n))
    return out


def decode_cifar10(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records → (images u8 NHWC, labels u8)."""
    lib = _load()
    buf = np.frombuffer(raw, np.uint8)
    rec = 1 + 3072
    if len(raw) % rec:
        raise ValueError(
            f"CIFAR decode failed: {len(raw)} bytes is not a whole "
            f"number of {rec}-byte records")
    if lib is None:
        n = len(raw) // rec
        recs = buf.reshape(n, rec)
        chw = recs[:, 1:].reshape(n, 3, 32, 32)
        return chw.transpose(0, 2, 3, 1).copy(), recs[:, 0].copy()
    n = ctypes.c_int64()
    rc = lib.bdl_decode_cifar10(_u8(buf), len(raw), None, None,
                                ctypes.byref(n))
    if rc:
        raise ValueError(f"CIFAR decode failed ({rc})")
    images = np.empty((n.value, 32, 32, 3), np.uint8)
    labels = np.empty((n.value,), np.uint8)
    lib.bdl_decode_cifar10(_u8(buf), len(raw), _u8(images), _u8(labels),
                           ctypes.byref(n))
    return images, labels


# ------------------------------------------------------------ producers
class _Worker:
    """A batch producer on one of two planes: a C++ handle whose worker
    threads fill the library's ring buffer (`native`), or one Python
    daemon thread filling a bounded queue with `_py_worker`'s batches.
    Both stop at `close()`."""

    native = False
    _handle = None
    _t = None

    def _start(self, capacity: int, seed: int) -> None:
        self._q = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._rng = np.random.RandomState(seed)
        self._t = threading.Thread(target=self._py_worker, daemon=True)
        self._t.start()

    def _native_next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise RuntimeError(f"{type(self).__name__} used after close()")
        h, w, c = self.shape
        lbl = np.empty((self.batch_size,), np.int32)
        if getattr(self, "out_dtype", "f32") == "u8":
            img = np.empty((self.batch_size, h, w, c), np.uint8)
            self._lib.bdl_prefetcher_next_u8(self._handle, _u8(img),
                                             _i32(lbl))
        else:
            img = np.empty((self.batch_size, h, w, c), np.float32)
            self._lib.bdl_prefetcher_next(self._handle, _f32(img),
                                          _i32(lbl))
        return img, lbl

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.native:
            return self._native_next()
        if self._stop.is_set():
            # get() would block forever on a queue whose producer exited
            raise RuntimeError(f"{type(self).__name__} used after close()")
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self) -> None:
        """Stop the workers and wait for them. On the Python plane,
        draining the queue lets a put() the thread is blocked in return,
        after which it sees the stop."""
        if self.native:
            if self._handle is not None:
                self._lib.bdl_prefetcher_destroy(self._handle)
                self._handle = None
            return
        if self._t is None:
            return
        self._stop.set()
        while self._t.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)

    def __del__(self):  # pragma: no cover - best effort
        try:
            if self.native:
                self.close()
            elif self._t is not None:
                self._stop.set()
        except Exception:
            pass


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
    normalized, optionally shift-crop/hflip augmented, by the C++
    plane's `n_threads` workers or one Python thread (`.native` says
    which) into a bounded buffer."""

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
        self._lib = _load()
        self.native = self._lib is not None
        if self.native:
            self._handle = self._lib.bdl_prefetcher_create(
                _u8(self.images), _i32(self.labels), n, h, w, c,
                batch_size, capacity, n_threads, seed, pad,
                1 if hflip else 0, _f32(self.mean), _f32(self.std))
        else:
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
    """Batch producer over BDLS shard files (dataset/records.py format).
    The C++ plane mmap()s every shard and streams records through
    `n_threads` workers; the Python plane reads through `np.memmap` on
    one thread. Either way a dataset larger than RAM rides the OS page
    cache. out_dtype="u8" skips host normalization and yields raw u8
    batches (a quarter of the host-to-device bytes; normalize on the
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
        self._lib = _load()
        self.native = self._lib is not None
        if self.native:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            n, hh, ww, cc = (ctypes.c_int64(), ctypes.c_int(),
                             ctypes.c_int(), ctypes.c_int())
            self._handle = self._lib.bdl_file_prefetcher_create(
                arr, len(self.paths), batch_size, capacity, n_threads,
                seed, pad, 1 if hflip else 0,
                1 if out_dtype == "u8" else 0, _f32(self.mean),
                _f32(self.std), ctypes.byref(n), ctypes.byref(hh),
                ctypes.byref(ww), ctypes.byref(cc))
            if not self._handle:
                raise ValueError(
                    f"native shard open failed (bad/missing BDLS files "
                    f"or mismatched shapes): {self.paths[:3]}...")
            return
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
