"""TensorBoard event-file writer, written from scratch.

A copy of bigdl_tpu/visualization/tensorboard.py (`struct` and numpy
only; reference: visualization/tensorboard/{FileWriter,EventWriter,
RecordWriter}.scala). The reference hand-writes TFRecord framing with
masked CRC32C and Event protos; so does this, with hand-encoded
protobuf varints for the small Event/Summary subset written here
(scalars and histograms). No tensorflow dependency.

TFRecord frame:  [len u64le][masked_crc32c(len) u32le][data][masked_crc32c(data) u32le]
Event proto:     1: wall_time (double), 2: step (int64), 5: summary (Summary)
Summary.Value:   1: tag (string), 2: simple_value (float), 5: histo (HistogramProto)
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Sequence

import numpy as np

# ----------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf enc
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, value_msg)
    return (_double_field(1, wall_time) + _int64_field(2, step)
            + _bytes_field(5, summary))


def _histogram_proto(values: np.ndarray) -> bytes:
    values = np.asarray(values, np.float64).ravel()
    if values.size == 0:
        values = np.zeros(1)
    # exponential bucket edges, the standard TB scheme
    edges = [0.0]
    v = 1e-12
    while v < 1e20:
        edges.append(v)
        v *= 1.1
    edges = np.asarray(sorted(set([-e for e in edges[1:]] + edges)))
    counts, _ = np.histogram(values, bins=np.concatenate([[-np.inf], edges]))
    msg = b"".join([
        _double_field(1, float(values.min())),
        _double_field(2, float(values.max())),
        _double_field(3, float(values.size)),
        _double_field(4, float(values.sum())),
        _double_field(5, float((values ** 2).sum())),
    ])
    # packed repeated double: bucket_limit field 6, bucket field 7
    packed_limits = b"".join(struct.pack("<d", e) for e in edges)
    packed_counts = b"".join(struct.pack("<d", float(c)) for c in counts)
    msg += _bytes_field(6, packed_limits) + _bytes_field(7, packed_counts)
    return msg


def _histo_event(tag: str, values: np.ndarray, step: int, wall_time: float) -> bytes:
    value_msg = _bytes_field(1, tag.encode()) + _bytes_field(5, _histogram_proto(values))
    summary = _bytes_field(1, value_msg)
    return (_double_field(1, wall_time) + _int64_field(2, step)
            + _bytes_field(5, summary))


class FileWriter:
    """Append TFRecord-framed events to an events file
    (reference: visualization/tensorboard/FileWriter.scala)."""

    def __init__(self, logdir: str, flush_secs: float = 10.0):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.bigdl-tpu"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._last_flush = time.time()
        self.flush_secs = flush_secs
        # file-version header event
        self._write_record(
            _double_field(1, time.time()) + _bytes_field(3, b"brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))
        if time.time() - self._last_flush > self.flush_secs:
            self.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(_scalar_event(tag, value, step,
                                         wall_time or time.time()))

    def add_histogram(self, tag: str, values, step: int,
                      wall_time: Optional[float] = None) -> None:
        self._write_record(_histo_event(tag, np.asarray(values), step,
                                        wall_time or time.time()))

    def flush(self) -> None:
        self._f.flush()
        self._last_flush = time.time()

    def close(self) -> None:
        self.flush()
        self._f.close()


def read_events(path: str):
    """Parse an events file back into (tag, value, step) tuples — used by
    tests to round-trip the writer (scalar events only)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break  # truncated tail (writer mid-record) — stop cleanly
            (length,) = struct.unpack("<Q", header)
            hcrc_bytes = f.read(4)
            if len(hcrc_bytes) < 4:
                break
            (hcrc,) = struct.unpack("<I", hcrc_bytes)
            assert hcrc == masked_crc32c(header), "header crc mismatch"
            data = f.read(length)
            dcrc_bytes = f.read(4)
            if len(data) < length or len(dcrc_bytes) < 4:
                break
            (dcrc,) = struct.unpack("<I", dcrc_bytes)
            assert dcrc == masked_crc32c(data), "data crc mismatch"
            out.append(_parse_event(data))
    return [e for e in out if e is not None]


def _parse_event(data: bytes):
    i, step, tag, value = 0, 0, None, None

    def read_varint():
        nonlocal i
        shift, result = 0, 0
        while True:
            b = data[i]
            i += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    while i < len(data):
        key = read_varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = read_varint()
            if field == 2:
                step = v
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln = read_varint()
            payload = data[i:i + ln]
            i += ln
            if field == 5:  # summary
                j = 0

                def rv(buf, j):
                    shift, result = 0, 0
                    while True:
                        b = buf[j]
                        j += 1
                        result |= (b & 0x7F) << shift
                        if not b & 0x80:
                            return result, j
                        shift += 7

                key2, j = rv(payload, j)
                if key2 >> 3 == 1 and (key2 & 7) == 2:
                    ln2, j = rv(payload, j)
                    vmsg = payload[j:j + ln2]
                    k = 0
                    while k < len(vmsg):
                        key3, k = rv(vmsg, k)
                        f3, w3 = key3 >> 3, key3 & 7
                        if f3 == 1 and w3 == 2:
                            ln3, k = rv(vmsg, k)
                            tag = vmsg[k:k + ln3].decode()
                            k += ln3
                        elif f3 == 2 and w3 == 5:
                            (value,) = struct.unpack("<f", vmsg[k:k + 4])
                            k += 4
                        elif w3 == 2:
                            ln3, k = rv(vmsg, k)
                            k += ln3
                        elif w3 == 0:
                            _, k = rv(vmsg, k)
                        elif w3 == 5:
                            k += 4
                        else:
                            k += 8
    if tag is None:
        return None
    return (tag, value, step)
