"""The port's disk datasets (bigdl_tpu_torch/dataset/records.py,
tfrecord.py and native.py's FilePrefetcher) against the JAX package's:
BDLS shards written by either package and read by the other,
`RecordFileDataSet`'s train and eval batches and `FilePrefetcher` in
f32 and u8 against the JAX package's Python plane (its C++ library
masked as tests/test_native_dataplane.py masks it), the TFRecord frame
and tf.train.Example codec in both directions, `TFRecordDataSet`'s
order, `count_tfrecords`' sidecar, and the refusals of a bad magic, a
truncated frame and a damaged CRC.

Tolerance: none — files are compared byte for byte and batches bit for
bit. Every prefetcher is closed.
"""

import os
import unittest.mock as mock

import numpy as np
import pytest

from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import records as jrecords
from bigdl_tpu.dataset import tfrecord as jtf
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import records as trecords
from bigdl_tpu_torch.dataset import tfrecord as ttf

MEAN, STD = [125.3, 122.9, 113.8], [63.0, 62.1, 66.7]


def _images(n, seed=0, shape=(6, 5, 3)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n,) + shape, np.uint8),
            rng.randint(0, 10, n).astype(np.int32))


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


def test_shards_are_byte_equal_and_cross_read(tmp_path):
    images, labels = _images(23)
    jpaths = jrecords.write_shards(images, labels, str(tmp_path / "j"),
                                   num_shards=3)
    tpaths = trecords.write_shards(images, labels, str(tmp_path / "t"),
                                   num_shards=3)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths] == \
        [f"data-{i:05d}-of-00003.bdls" for i in range(3)]
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    for jp, tp in zip(jpaths, tpaths):
        assert trecords.read_header(jp) == jrecords.read_header(tp)
    assert [trecords.read_header(p)[0] for p in tpaths] == [7, 8, 8]
    assert trecords.resolve_shards(str(tmp_path / "t")) == tpaths
    assert trecords.resolve_shards(str(tmp_path / "t" / "*-00001-*")) == \
        tpaths[1:2]
    # greyscale (n, h, w) gains a channel axis, as in the JAX package
    g = trecords.write_shards(images[..., 0], labels, str(tmp_path / "g"))
    assert trecords.read_header(g[0]) == (23, 6, 5, 1)


def _record_ds(pkg, paths, **kw):
    if pkg == "jax":
        with mock.patch.object(jnative, "_load", return_value=None):
            d = jrecords.RecordFileDataSet(paths, **kw)
        assert not d.native
        return d
    d = trecords.RecordFileDataSet(paths, **kw)
    assert not d.native
    return d


@pytest.mark.parametrize("aug", [dict(), dict(pad=2, hflip=True)],
                         ids=["plain", "pad_hflip"])
def test_record_dataset_matches_jax(tmp_path, aug):
    images, labels = _images(30, seed=1)
    # the JAX package writes, both read: the cross-package direction
    paths = jrecords.write_shards(images, labels, str(tmp_path), 4)
    out = {}
    for pkg in ("jax", "torch"):
        d = _record_ds(pkg, str(tmp_path), batch_size=6, mean=MEAN, std=STD,
                       seed=5, **aug)
        try:
            it = d.data(True)
            out[pkg] = ([next(it) for _ in range(9)], list(d.data(False)))
            assert d.size() == 30 and d.shape == (6, 5, 3)
        finally:
            d.close()
    for jb, tb in zip(out["jax"][0] + out["jax"][1],
                      out["torch"][0] + out["torch"][1]):
        assert tb.input.dtype == np.float32 and tb.target.dtype == np.int32
        np.testing.assert_array_equal(tb.input, jb.input)
        np.testing.assert_array_equal(tb.target, jb.target)
    # eval: the shards in order, a short last batch a shard, normalized
    ev = out["torch"][1]
    assert [len(b.target) for b in ev] == [6, 1, 6, 2, 6, 1, 6, 2]
    np.testing.assert_array_equal(np.concatenate([b.target for b in ev]),
                                  labels)
    np.testing.assert_array_equal(
        np.concatenate([b.input for b in ev]),
        (images.astype(np.float32) - np.float32(MEAN)) / np.float32(STD))


@pytest.mark.parametrize("out_dtype", ["f32", "u8"])
def test_file_prefetcher_matches_jax(tmp_path, out_dtype):
    images, labels = _images(21, seed=2)
    paths = trecords.write_shards(images, labels, str(tmp_path), 2)
    kw = dict(batch_size=5, mean=MEAN, std=STD, pad=1, hflip=True, seed=9,
              out_dtype=out_dtype)
    with mock.patch.object(jnative, "_load", return_value=None):
        jp = jnative.FilePrefetcher(paths, **kw)
    tp = tnative.FilePrefetcher(paths, **kw)
    try:
        assert not jp.native and not tp.native
        for _ in range(10):                    # 2.5 epochs of 4 batches
            (ja, jl), (ta, tl) = jp.next(), tp.next()
            assert ta.dtype == (np.uint8 if out_dtype == "u8"
                                else np.float32)
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tl, jl)
    finally:
        jp.close()
        tp.close()
    assert not tp._t.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        tp.next()


def test_file_prefetcher_refusals(tmp_path):
    images, labels = _images(4)
    a = trecords.write_shards(images, labels, str(tmp_path / "a"))
    b = trecords.write_shards(images[:, :3], labels, str(tmp_path / "b"))
    with pytest.raises(ValueError, match="disagree"):
        tnative.FilePrefetcher(a + b, 2, MEAN, STD)
    with pytest.raises(ValueError, match="2 entries for 3 channels"):
        tnative.FilePrefetcher(a, 2, [0.0, 1.0], STD)
    with pytest.raises(ValueError, match="out_dtype"):
        tnative.FilePrefetcher(a, 2, MEAN, STD, out_dtype="f16")
    bad = str(tmp_path / "bad.bdls")
    raw = bytearray(open(a[0], "rb").read())
    raw[:4] = b"XXXX"
    open(bad, "wb").write(bytes(raw))
    for mod in (trecords, jrecords):
        with pytest.raises(ValueError, match="not a BDLS v1 shard"):
            mod.read_header(bad)
    with pytest.raises(FileNotFoundError, match="no \\*.bdls shards"):
        trecords.resolve_shards(str(tmp_path / "nothing"))


def _examples():
    return [{"image": b"\x00\x01\xff", "name": "café",
             "shape": np.asarray([1, 3, 1], np.int64),
             "label": np.asarray([-3], np.int64),
             "scores": np.asarray([0.5, -1.25, 3e-8], np.float32),
             "flags": np.asarray([True, False])},
            {"empty": np.zeros((0,), np.float32),
             "big": np.asarray([2 ** 62, -(2 ** 62)], np.int64)}]


def test_example_codec_both_directions():
    for ex in _examples():
        raw = ttf.encode_example(ex)
        assert raw == jtf.encode_example(ex)
        for decoded in (ttf.decode_example(raw), jtf.decode_example(raw)):
            assert set(decoded) == set(ex)
        t, j = ttf.decode_example(raw), jtf.decode_example(raw)
        for k in ex:
            if isinstance(j[k], np.ndarray):
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
            else:
                assert t[k] == j[k]
        if "name" in ex:                        # a str comes back as bytes
            assert t["name"] == "café".encode()
    with pytest.raises(TypeError, match="unsupported dtype"):
        ttf.encode_example({"x": np.asarray(["a"])})


def test_tfrecord_frames_both_directions(tmp_path):
    payloads = [ttf.encode_example(e) for e in _examples()] + [b"", b"z" * 300]
    jpath, tpath = str(tmp_path / "j.tfrecord"), str(tmp_path / "t.tfrecord")
    jtf.write_tfrecords(jpath, payloads)
    ttf.write_tfrecords(tpath, payloads)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert list(ttf.read_tfrecords(jpath)) == payloads
    assert list(jtf.read_tfrecords(tpath)) == payloads
    assert ttf.count_tfrecords(tpath) == jtf.count_tfrecords(tpath) == 4


def test_tfrecord_refusals(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    ttf.write_tfrecords(path, [b"hello world"])
    raw = open(path, "rb").read()
    cases = {"header CRC mismatch": raw[:8] + b"\0\0\0\0" + raw[12:],
             "record CRC mismatch": raw[:-1] + bytes([raw[-1] ^ 1]),
             "truncated record body": raw[:16],
             "truncated record header": raw[:5]}
    for what, damaged in cases.items():
        p = str(tmp_path / f"{what.replace(' ', '_')}.tfrecord")
        open(p, "wb").write(damaged)
        for mod in (ttf, jtf):
            with pytest.raises(ValueError, match=what):
                list(mod.read_tfrecords(p))
    short = str(tmp_path / "truncated_record_body.tfrecord")
    with pytest.raises(ValueError, match="truncated record body"):
        ttf.count_tfrecords(short)


def test_tfrecord_dataset_order_and_sidecar(tmp_path):
    images, labels = _images(11, seed=3)
    paths = []
    for i, (lo, hi) in enumerate(((0, 4), (4, 9), (9, 11))):
        p = str(tmp_path / f"part-{i}.tfrecord")
        ttf.write_image_examples(p, images[lo:hi], labels[lo:hi])
        jp = str(tmp_path / f"jax-{i}.tfr")
        jtf.write_image_examples(jp, images[lo:hi], labels[lo:hi])
        assert open(p, "rb").read() == open(jp, "rb").read()
        paths.append(p)
    td = ttf.TFRecordDataSet(str(tmp_path), seed=2)
    jd = jtf.TFRecordDataSet(str(tmp_path), seed=2)
    assert td.paths == jd.paths == paths       # the .tfr copies: no match
    assert td.size() == jd.size() == 11
    once = list(td.data(False))
    np.testing.assert_array_equal(np.stack([s.feature for s in once]),
                                  images.astype(np.float32))
    assert [int(s.label) for s in once] == labels.tolist()
    tit, jit = td.data(True), jd.data(True)
    for _ in range(25):                        # into the third epoch
        a, b = next(tit), next(jit)
        np.testing.assert_array_equal(a.feature, b.feature)
        assert a.label == b.label and a.label.dtype == np.int32
    # a sidecar at least as new as its shard stands in for the scan; a
    # stale one (older than a rewritten shard) is ignored
    side = paths[1] + ".count"
    open(side, "w").write("99\n")
    assert ttf.count_tfrecords(paths[1]) == 99
    assert ttf.TFRecordDataSet(str(tmp_path)).paths == paths
    st = os.stat(paths[1])
    os.utime(side, (st.st_atime - 10, st.st_mtime - 10))
    assert ttf.count_tfrecords(paths[1]) == 5 == jtf.count_tfrecords(
        paths[1])
