"""TFRecord dataset interop — read/write tf.train.Example records.

Ports bigdl_tpu/dataset/tfrecord.py (the TFRecord container stands
where the reference ingests Hadoop sequence files). The frame format
(length + masked CRC32C) is the one the TensorBoard event writer uses
(visualization/tensorboard.py, whose `masked_crc32c` this file takes;
no tensorflow import); the tf.train.Example message is hand-decoded
from protobuf wire format here:

    Example        = 1: Features
    Features       = 1: map<string, Feature>   (wire: repeated entry)
    Feature        = oneof 1: BytesList | 2: FloatList | 3: Int64List
    BytesList      = 1: repeated bytes
    FloatList      = 1: repeated float   (packed)
    Int64List      = 1: repeated varint  (packed)

`TFRecordDataSet` streams shards into Samples via a parser; the default
parser expects the conventional "image"/"label" keys with raw u8 HWC
image bytes + a "shape" int64 list. Files and records are the JAX
package's byte for byte, so either package reads the other's shards.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.records import resolve_shards
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.visualization.tensorboard import masked_crc32c

# ------------------------------------------------------------ wire codec


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int):
    v, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, Any]) -> bytes:
    """dict of {name: bytes | str | ints | floats | ndarray} →
    serialized tf.train.Example."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            lst = _len_delim(1, _len_delim(1, value))              # BytesList
        elif isinstance(value, str):
            lst = _len_delim(1, _len_delim(1, value.encode()))
        else:
            arr = np.asarray(value)
            if arr.dtype.kind in "iub":
                payload = b"".join(
                    _varint(int(x) & 0xFFFFFFFFFFFFFFFF)
                    for x in arr.reshape(-1))
                lst = _len_delim(3, _len_delim(1, payload))        # Int64List
            elif arr.dtype.kind == "f":
                payload = arr.reshape(-1).astype("<f4").tobytes()
                lst = _len_delim(2, _len_delim(1, payload))        # FloatList
            else:
                raise TypeError(
                    f"feature {name!r}: unsupported dtype {arr.dtype}")
        entry = _len_delim(1, name.encode()) + _len_delim(2, lst)
        entries += _len_delim(1, entry)                            # map entry
    return _len_delim(1, entries)                                  # Features


def decode_example(raw: bytes) -> Dict[str, Any]:
    """serialized tf.train.Example → {name: bytes | np.ndarray}."""

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = _read_varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 2:
                n, i = _read_varint(buf, i)
                yield field, buf[i:i + n]
                i += n
            elif wire == 0:
                v, i = _read_varint(buf, i)
                yield field, v
            elif wire == 5:
                yield field, buf[i:i + 4]
                i += 4
            elif wire == 1:
                yield field, buf[i:i + 8]
                i += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    def parse_feature(buf):
        for field, val in fields(buf):
            if field == 1:      # BytesList
                items = [v for f, v in fields(val) if f == 1]
                return items[0] if len(items) == 1 else items
            if field == 2:      # FloatList (packed or repeated)
                packed = b"".join(v for f, v in fields(val) if f == 1)
                return np.frombuffer(packed, "<f4").copy()
            if field == 3:      # Int64List
                out = []
                for f, v in fields(val):
                    if f != 1:
                        continue
                    if isinstance(v, int):
                        out.append(v)
                    else:  # packed varints
                        i = 0
                        while i < len(v):
                            x, i = _read_varint(v, i)
                            out.append(x)
                return np.asarray(
                    [x - (1 << 64) if x >= (1 << 63) else x
                     for x in out], np.int64)
        return None

    out: Dict[str, Any] = {}
    for field, feats in fields(raw):
        if field != 1:
            continue
        for f2, entry in fields(feats):
            if f2 != 1:
                continue
            name, feat = None, None
            for f3, v in fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feat = parse_feature(v)
            if name is not None:
                out[name] = feat
    return out


# ------------------------------------------------------------ file frame

def write_tfrecords(path: str, payloads: Sequence[bytes]) -> None:
    """Frame serialized messages into a TFRecord file (masked CRC32C)."""
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))


def read_tfrecords(path: str) -> Iterator[bytes]:
    """Stream the framed records of one file, verifying both CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError(f"{path}: truncated record header")
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError(f"{path}: header CRC mismatch")
            (n,) = struct.unpack("<Q", header)
            data = f.read(n)
            if len(data) < n:
                raise ValueError(f"{path}: truncated record body")
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != masked_crc32c(data):
                raise ValueError(f"{path}: record CRC mismatch")
            yield data


# ------------------------------------------------------------ dataset

def default_image_parser(example: Dict[str, Any]) -> Sample:
    """The conventional layout: 'image' raw u8 bytes + 'shape' int64
    HWC dims + 'label' int64."""
    shape = tuple(int(d) for d in example["shape"])
    img = np.frombuffer(example["image"], np.uint8).reshape(shape)
    label = np.int32(int(example["label"][0]))
    return Sample(img.astype(np.float32), label)


def count_tfrecords(path: str) -> int:
    """Record count of one shard by seeking over the framing (length
    header → skip body), no CRC work and no body reads — O(records)
    seeks instead of a full decode. A sidecar `<path>.count` file
    holding the integer short-circuits even that (write one when
    producing ImageNet-scale shards)."""
    sidecar = path + ".count"
    # trust the sidecar only if it's at least as new as the shard — a
    # regenerated shard with a stale sidecar must fall back to the scan
    if (os.path.exists(sidecar)
            and os.path.getmtime(sidecar) >= os.path.getmtime(path)):
        with open(sidecar) as f:
            return int(f.read().strip())
    n = 0
    total = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return n
            if len(header) < 8:
                raise ValueError(f"{path}: truncated record header")
            (ln,) = struct.unpack("<Q", header)
            f.seek(4 + ln + 4, 1)  # header crc + body + body crc
            if f.tell() > total:   # seek past EOF succeeds silently —
                # raise the same error the reading iterator would
                raise ValueError(f"{path}: truncated record body")
            n += 1


class TFRecordDataSet(AbstractDataSet):
    """Dataset over TFRecord shards of tf.train.Example records.

    `parser`: Example dict → Sample (default: image/shape/label keys).
    train=True shuffles shard order and in-shard record order per epoch
    (statelessly, like every dataset here — resume fast-forward safe);
    train=False streams in order once.

    Memory note: the train iterator materializes ONE shard at a time to
    shuffle in-shard order — size shards accordingly (the conventional
    100–200 MB TFRecord shard is fine; don't write one giant shard).
    `size()` counts by framing seeks (or a `<shard>.count` sidecar),
    not a full CRC decode.
    """

    def __init__(self, paths, parser: Callable[[Dict[str, Any]], Sample]
                 = default_image_parser, seed: int = 1):
        self.paths = [p for p in resolve_shards(paths,
                                                pattern="*.tfrecord*")
                      if not p.endswith(".count")]  # count sidecars
        self.parser = parser
        self.seed = seed
        self._n: Optional[int] = None

    def size(self) -> int:
        if self._n is None:
            self._n = sum(count_tfrecords(p) for p in self.paths)
        return self._n

    def data(self, train: bool) -> Iterator:
        if not train:
            def once():
                for p in self.paths:
                    for raw in read_tfrecords(p):
                        yield self.parser(decode_example(raw))
            return once()

        def forever():
            epoch = 0
            while True:
                rng = np.random.RandomState(self.seed + epoch)
                for pi in rng.permutation(len(self.paths)):
                    records = list(read_tfrecords(self.paths[pi]))
                    for ri in rng.permutation(len(records)):
                        yield self.parser(decode_example(records[ri]))
                epoch += 1
        return forever()


def write_image_examples(path: str, images: np.ndarray,
                         labels: Sequence[int]) -> None:
    """Convenience: (n,h,w,c) u8 images + labels → one TFRecord shard
    in the default_image_parser layout."""
    images = np.ascontiguousarray(images, np.uint8)
    payloads = [encode_example({
        "image": images[i].tobytes(),
        "shape": np.asarray(images[i].shape, np.int64),
        "label": np.asarray([int(labels[i])], np.int64),
    }) for i in range(len(images))]
    write_tfrecords(path, payloads)
