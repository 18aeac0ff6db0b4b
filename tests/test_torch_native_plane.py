"""The port's C++ data plane (bigdl_tpu_torch/dataset/csrc/dataplane.cpp,
bound by dataset/native.py) against its Python plane and the JAX
package's C++ plane.

- It builds here with g++ into bigdl_tpu_torch/ops/build/ under a hashed
  name, never into native/; `.native` is True for every producer.
- Its normalize divides, so its values equal numpy's (x - mean) / std —
  the Python plane's — bit for bit; the JAX package's multiplies by a
  reciprocal, so the two C++ planes agree bit for bit where 1 / std is
  exact (a power of two) and within one float32 ulp elsewhere.
- Its producers' streams equal the JAX package's C++ streams bit for bit
  with one worker thread (the same source, seeds and `std::mt19937`
  draws), with shifts, flips and normalisation on; each record of them
  is the Python plane's output for that record under one of its shifts
  and flips, bit for bit.
- The decoders and the bilinear resize equal the JAX package's bit for
  bit; with `_load` masked every entry point runs its Python plane.
"""

import os
import unittest.mock as mock

import numpy as np
import pytest

from bigdl_tpu.dataset import native as jnative
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import records as trecords

POW2_MEAN, POW2_STD = [120.0, 110.0, 100.0], [64.0, 32.0, 128.0]
CIFAR_MEAN, CIFAR_STD = [125.3, 122.9, 113.8], [63.0, 62.1, 66.7]


@pytest.fixture(scope="module", autouse=True)
def planes():
    assert tnative.available(), "the port's C++ plane did not build (g++)"
    assert jnative.available()


def _images(n=40, h=7, w=6, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, h, w, c), np.uint8)


def test_library_builds_into_the_ports_build_dir():
    so = tnative.library_path()
    assert so.exists()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert so.parent == tnative._BUILD_DIR
    assert os.path.relpath(so, repo).startswith(
        os.path.join("bigdl_tpu_torch", "ops", "build"))
    assert so.name.startswith("libdataplane-")
    assert not os.path.relpath(tnative._SRC, repo).startswith("native")


def test_normalize_equals_numpy_and_jax():
    img = _images(8, 16, 16)
    for mean, std in ((CIFAR_MEAN, CIFAR_STD), (POW2_MEAN, POW2_STD)):
        m, s = np.float32(mean), np.float32(std)
        want = (img.astype(np.float32) - m) / s
        got = tnative.normalize_u8(img, mean, std)
        np.testing.assert_array_equal(got, want)
        j = jnative.normalize_u8(img, mean, std)
        np.testing.assert_array_max_ulp(j, got, maxulp=1)
        if std is POW2_STD:
            np.testing.assert_array_equal(j, got)
    with mock.patch.object(tnative, "_load", return_value=None):
        np.testing.assert_array_equal(
            tnative.normalize_u8(img, CIFAR_MEAN, CIFAR_STD),
            (img.astype(np.float32) - np.float32(CIFAR_MEAN))
            / np.float32(CIFAR_STD))


def test_decoders_and_resize_equal_jax():
    import struct

    imgs = _images(5, 4, 3, 1)[..., 0]
    raw = struct.pack(">IIII", 2051, 5, 4, 3) + imgs.tobytes()
    labels = np.arange(5, dtype=np.uint8)
    raw_l = struct.pack(">II", 2049, 5) + labels.tobytes()
    recs = np.random.RandomState(1).randint(0, 256, (3, 3073), np.uint8)
    for nat in (tnative, jnative):
        np.testing.assert_array_equal(nat.decode_idx_images(raw), imgs)
        np.testing.assert_array_equal(nat.decode_idx_labels(raw_l), labels)
    ti, tl = tnative.decode_cifar10(recs.tobytes())
    ji, jl = jnative.decode_cifar10(recs.tobytes())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    with mock.patch.object(tnative, "_load", return_value=None):
        pi, pl = tnative.decode_cifar10(recs.tobytes())
        np.testing.assert_array_equal(tnative.decode_idx_images(raw), imgs)
    np.testing.assert_array_equal(pi, ti)
    np.testing.assert_array_equal(pl, tl)
    with pytest.raises(ValueError, match="IDX"):
        tnative.decode_idx_images(struct.pack(">IIII", 7, 0, 0, 0))
    f = np.random.RandomState(2).rand(9, 11, 3).astype(np.float32)
    np.testing.assert_array_equal(tnative.resize_bilinear(f, 5, 14),
                                  jnative.resize_bilinear(f, 5, 14))
    with mock.patch.object(tnative, "_load", return_value=None):
        assert tnative.resize_bilinear(f, 5, 14) is None


def _python_candidates_match(img, raw_norm, pad):
    h, w = raw_norm.shape[:2]
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            out = np.zeros_like(raw_norm)
            y0, y1 = max(0, dy), min(h, h + dy)
            x0, x1 = max(0, dx), min(w, w + dx)
            out[y0:y1, x0:x1] = raw_norm[y0 - dy:y1 - dy, x0 - dx:x1 - dx]
            if np.array_equal(img, out) or np.array_equal(img, out[:, ::-1]):
                return True
    return False


@pytest.mark.parametrize("source", ["memory", "files"])
def test_streams_equal_jax_cpp_and_python_records(tmp_path, source):
    images = _images()
    labels = np.arange(len(images), dtype=np.int32)   # record ids
    kw = dict(batch_size=8, mean=POW2_MEAN, std=POW2_STD, pad=2, hflip=True,
              n_threads=1, seed=11)
    if source == "memory":
        tp = tnative.Prefetcher(images, labels, **kw)
        jp = jnative.Prefetcher(images, labels, **kw)
    else:
        paths = trecords.write_shards(images, labels, str(tmp_path), 3)
        tp = tnative.FilePrefetcher(paths, **kw)
        jp = jnative.FilePrefetcher(paths, **kw)
    try:
        assert tp.native and jp.native
        seen = []
        for _ in range(10):                 # two epochs of 5 batches
            (ti, tl), (ji, jl) = tp.next(), jp.next()
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
            for img, i in zip(ti, tl):
                raw = (images[i].astype(np.float32) - np.float32(POW2_MEAN)) \
                    / np.float32(POW2_STD)
                assert _python_candidates_match(img, raw, 2), i
            seen.extend(tl.tolist())
        assert sorted(seen[:40]) == list(range(40))   # an epoch each
    finally:
        tp.close()
        jp.close()
    with pytest.raises(RuntimeError, match="after close"):
        tp.next()


def test_u8_mode_and_cifar_normalisation_record_by_record(tmp_path):
    images = _images(24, 8, 8)
    labels = np.arange(24, dtype=np.int32)
    paths = trecords.write_shards(images, labels, str(tmp_path), 2)
    kw = dict(batch_size=6, mean=CIFAR_MEAN, std=CIFAR_STD, pad=1,
              hflip=True, n_threads=3, seed=2)
    tp = tnative.FilePrefetcher(paths, **kw)
    up = tnative.FilePrefetcher(paths, out_dtype="u8", **kw)
    try:
        assert tp.native and up.native
        for _ in range(6):
            img, lbl = tp.next()
            for x, i in zip(img, lbl):
                raw = (images[i].astype(np.float32) - np.float32(CIFAR_MEAN)) \
                    / np.float32(CIFAR_STD)
                assert _python_candidates_match(x, raw, 1), i
            u8, ulbl = up.next()
            assert u8.dtype == np.uint8 and u8.shape == (6, 8, 8, 3)
            assert set(ulbl.tolist()) <= set(range(24))
    finally:
        tp.close()
        up.close()


def test_datasets_report_the_plane(tmp_path):
    from bigdl_tpu_torch.dataset import PrefetchDataSet, RecordFileDataSet

    images = _images(20, 6, 5)
    labels = np.arange(20, dtype=np.int32)
    paths = trecords.write_shards(images, labels, str(tmp_path), 2)
    kw = dict(batch_size=4, mean=CIFAR_MEAN, std=CIFAR_STD)
    ds = RecordFileDataSet(paths, pad=1, hflip=True, **kw)
    mem = PrefetchDataSet(images, labels, **kw)
    try:
        assert ds.native and mem.native
        # eval mode maps the shards in order: numpy's normalisation
        got = list(ds.data(train=False))
        np.testing.assert_array_equal(
            np.concatenate([b.input for b in got]),
            (images.astype(np.float32) - np.float32(CIFAR_MEAN))
            / np.float32(CIFAR_STD))
        b = next(iter(ds.data(train=True)))
        assert b.input.shape == (4, 6, 5, 3)
        assert next(iter(mem.data(train=True))).input.shape == (4, 6, 5, 3)
    finally:
        ds.close()
        mem.close()
    with mock.patch.object(tnative, "_load", return_value=None):
        py = RecordFileDataSet(paths, **kw)
    try:
        assert not py.native
    finally:
        py.close()
    with pytest.raises(ValueError, match="native shard open failed"):
        bad = tmp_path / "bad.bdls"
        bad.write_bytes(open(paths[0], "rb").read()[:40])
        tnative.FilePrefetcher([str(bad)], 2, [0.0], [1.0])
