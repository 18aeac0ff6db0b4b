"""The port's protobuf codec (bigdl_tpu_torch/utils/protowire.py) and its
two schemas (utils/caffe/bigdl_caffe_pb2.py, utils/tf/bigdl_tf_pb2.py)
against `google.protobuf` and the JAX package's protoc modules.

- the schema tables equal the JAX modules' descriptors: every message,
  field number, type, label, default, packing, oneof and enum value;
- seeded messages of both schemas (maps and the oneof included), built
  the same way in both libraries, cross over both ways: the port's bytes
  parse in `google.protobuf` to an equal message and the reverse; the
  Caffe schema's bytes are equal byte for byte (it has no maps, whose
  entry order protobuf leaves open);
- the text format both ways, and the prototxt features a .prototxt may
  use (`<>`, optional `:`, comments, quotes, lists, enums by number,
  `1e-05`, `inf`, signs), each against `text_format.Merge` of the same
  text; an unknown field name is an error in both;
- unknown fields of every wire type are skipped; packed and unpacked
  encodings of a repeated field both read; a packed float field of
  4M values goes through whole (numpy), bit for bit.
"""

import struct
import time

import numpy as np
import pytest
from google.protobuf import descriptor as gdesc
from google.protobuf import text_format

from bigdl_tpu.utils.caffe import bigdl_caffe_pb2 as gcaffe
from bigdl_tpu.utils.tf import bigdl_tf_pb2 as gtf
from bigdl_tpu_torch.utils import protowire
from bigdl_tpu_torch.utils.caffe import bigdl_caffe_pb2 as pcaffe
from bigdl_tpu_torch.utils.tf import bigdl_tf_pb2 as ptf

SCHEMAS = {"caffe": (gcaffe, pcaffe), "tf": (gtf, ptf)}
_GTYPE = {getattr(gdesc.FieldDescriptor, k): k[5:].lower()
          for k in dir(gdesc.FieldDescriptor) if k.startswith("TYPE_")}


def _messages(gmod):
    """{relative name: descriptor} of every message but map entries."""
    pkg = gmod.DESCRIPTOR.package
    out = {}

    def walk(d):
        if d.GetOptions().map_entry:
            return
        out[d.full_name[len(pkg) + 1:]] = d
        for n in d.nested_types:
            walk(n)

    for d in gmod.DESCRIPTOR.message_types_by_name.values():
        walk(d)
    return out


def _enums(gmod):
    pkg = gmod.DESCRIPTOR.package
    out = {e.full_name[len(pkg) + 1:]: e
           for e in gmod.DESCRIPTOR.enum_types_by_name.values()}
    for d in _messages(gmod).values():
        for e in d.enum_types:
            out[e.full_name[len(pkg) + 1:]] = e
    return out


def _port_class(pmod, name):
    cls = getattr(pmod, name.split(".")[0])
    for part in name.split(".")[1:]:
        cls = getattr(cls, part)
    return cls


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_schema_tables_equal_the_descriptors(schema):
    gmod, pmod = SCHEMAS[schema]
    pkg = gmod.DESCRIPTOR.package
    gmsgs = _messages(gmod)
    assert set(gmsgs) == set(pmod.MESSAGES)
    assert pmod.PACKAGE == pkg
    for name, gd in gmsgs.items():
        cls = _port_class(pmod, name)
        assert cls.DESCRIPTOR_NAME == gd.full_name
        assert set(cls._fields) == set(gd.fields_by_name), name
        for gf in gd.fields:
            f = cls._fields[gf.name]
            where = f"{name}.{gf.name}"
            assert f.number == gf.number, where
            if gf.type == gf.TYPE_MESSAGE and \
                    gf.message_type.GetOptions().map_entry:
                k = gf.message_type.fields_by_name["key"]
                v = gf.message_type.fields_by_name["value"]
                assert f.type == "map" and f.key_type == _GTYPE[k.type]
                assert f.type_name == v.message_type.full_name[len(pkg) + 1:]
                continue
            assert f.type == _GTYPE[gf.type], where
            assert f.repeated == gf.is_repeated, where
            assert f.packed == gf.is_packed, where
            assert (f.oneof is None) == (gf.containing_oneof is None), where
            if gf.containing_oneof is not None:
                assert f.oneof == gf.containing_oneof.name
            if gf.type == gf.TYPE_MESSAGE:
                assert f.cls.DESCRIPTOR_NAME == gf.message_type.full_name
            if gf.type == gf.TYPE_ENUM:
                assert f.enum.full_name == gf.enum_type.full_name
            if not gf.is_repeated and gf.type != gf.TYPE_MESSAGE:
                assert f.has_default == gf.has_default_value, where
                assert f.default == gf.default_value, where
                assert type(f.default) is type(gf.default_value), where
    genums = _enums(gmod)
    assert set(genums) == set(pmod.ENUMS)
    for name, ge in genums.items():
        assert pmod.ENUMS[name] == {v.name: v.number for v in ge.values}
        if "." in name:
            outer = _port_class(pmod, name.rsplit(".", 1)[0])
            et = getattr(outer, name.rsplit(".", 1)[1])
            assert all(getattr(outer, v.name) == v.number
                       for v in ge.values)
        else:
            et = getattr(pmod, name)
            assert all(getattr(pmod, v.name) == getattr(gmod, v.name)
                       for v in ge.values)
        assert et.items() == [(v.name, v.number) for v in ge.values]


# ------------------------------------------------------------ seeded messages

_INTS = {"int32": (-2 ** 31, 2 ** 31), "int64": (-2 ** 63, 2 ** 63),
         "uint32": (0, 2 ** 32)}


def _value(rng, f):
    t = f.type
    if t in _INTS:
        lo, hi = _INTS[t]
        return int(rng.choice([0, 1, -1 if lo else 2, lo, hi - 1,
                               int(rng.integers(lo // 2, hi // 2))]))
    if t == "float":
        return float(np.float32(rng.choice(
            [0.0, -0.0, 1e-5, 0.75, float(rng.standard_normal()) * 1e3,
             np.inf, 3.4e38])))
    if t == "double":
        return float(rng.choice([0.0, 1e-300, -2.5,
                                 float(rng.standard_normal())]))
    if t == "bool":
        return bool(rng.integers(2))
    if t == "string":
        return "".join(rng.choice(list("ab\"'\\ \n\t#{}:é漢"),
                                  int(rng.integers(0, 8))))
    if t == "bytes":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 8)))
                     .astype(np.uint8))
    if t == "enum":
        return int(rng.choice(list(f.enum.values.values())))
    raise AssertionError(t)


def _fill(rng, pmsg, gmsg, depth=0):
    """Set the same seeded fields on the port's and google's message."""
    cls = type(pmsg)
    chosen_oneof = {k: rng.choice(list(v) + [None])
                    for k, v in cls._oneofs.items()}
    for f in cls._ordered:
        if f.oneof is not None:
            if chosen_oneof[f.oneof] != f.name:
                continue
        elif rng.random() < 0.4:
            continue
        if f.type == "map":
            if depth >= 2:
                continue
            for _ in range(int(rng.integers(0, 3))):
                key = _value(rng, protowire.Field("k", 1, f.key_type))
                _fill(rng, getattr(pmsg, f.name)[key],
                      getattr(gmsg, f.name)[key], depth + 1)
        elif f.type == "message" and f.repeated:
            if depth >= 3:
                continue
            for _ in range(int(rng.integers(0, 3))):
                _fill(rng, getattr(pmsg, f.name).add(),
                      getattr(gmsg, f.name).add(), depth + 1)
        elif f.type == "message":
            if depth >= 3:
                continue
            getattr(pmsg, f.name).SetInParent()
            getattr(gmsg, f.name).SetInParent()
            _fill(rng, getattr(pmsg, f.name), getattr(gmsg, f.name),
                  depth + 1)
        elif f.repeated:
            vals = [_value(rng, f) for _ in range(int(rng.integers(0, 5)))]
            getattr(pmsg, f.name).extend(vals)
            getattr(gmsg, f.name).extend(vals)
        else:
            v = _value(rng, f)
            setattr(pmsg, f.name, v)
            setattr(gmsg, f.name, v)


TOP = {"caffe": ("NetParameter", "LayerParameter", "V1LayerParameter",
                 "BlobProto"),
       "tf": ("GraphDef", "NodeDef", "AttrValue", "TensorProto")}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("seed", range(6))
def test_seeded_messages_cross_both_ways(schema, seed):
    gmod, pmod = SCHEMAS[schema]
    rng = np.random.default_rng(seed)
    for name in TOP[schema]:
        pmsg, gmsg = getattr(pmod, name)(), getattr(gmod, name)()
        _fill(rng, pmsg, gmsg)
        pbytes, gbytes = pmsg.SerializeToString(), gmsg.SerializeToString()
        back = getattr(gmod, name)()
        back.ParseFromString(pbytes)
        assert back == gmsg, name
        mine = getattr(pmod, name)()
        mine.ParseFromString(gbytes)
        assert mine == pmsg, name
        if schema == "caffe":
            assert pbytes == gbytes, name
            assert mine.SerializeToString() == pbytes
        # the text format, both ways
        gtext = getattr(gmod, name)()
        text_format.Merge(protowire.to_text(pmsg), gtext)
        assert gtext == gmsg, name
        ptext = protowire.merge_text(text_format.MessageToString(gmsg),
                                     getattr(pmod, name)())
        assert ptext == pmsg, name


def test_oneof_and_map_semantics():
    n = ptf.NodeDef()
    a = n.attr["x"]
    assert "x" in n.attr and a.WhichOneof("value") is None
    _ = a.list                          # read, never written: not present
    assert a.WhichOneof("value") is None
    a.i = 3
    a.list.i.extend([1, 2])             # writes list, clears i
    assert a.WhichOneof("value") == "list" and a.i == 0
    a.b = False                         # a default value, but set
    assert a.WhichOneof("value") == "b"
    g = gtf.NodeDef()
    g.ParseFromString(n.SerializeToString())
    assert g.attr["x"].WhichOneof("value") == "b"
    # proto3 scalars: no presence, and zero is not written
    t = ptf.TensorProto()
    t.version_number = 0
    assert t.SerializeToString() == b""
    with pytest.raises(ValueError):
        t.HasField("version_number")
    # proto2: presence, defaults, set-to-default is written
    c = pcaffe.ConvolutionParameter()
    assert c.bias_term is True and not c.HasField("bias_term")
    c.bias_term = True
    assert c.HasField("bias_term") and c.SerializeToString() == b"\x10\x01"
    layer = pcaffe.LayerParameter()
    assert layer.pooling_param.pool == pcaffe.PoolingParameter.MAX
    assert not layer.HasField("pooling_param")
    layer.pooling_param.kernel_size = 2
    assert layer.HasField("pooling_param")


PROTOTXT = """
# a prototxt in the forms Caffe's model zoo writes
name: 'net\\'s' input: "data"
input_dim: 1 input_dim: -3   # signed
input_shape < dim: [1, 3, 224, 0x10] >
layer {
  top: "conv1" bottom: "data" name: "conv1" type: "Conv" "olution"
  convolution_param: { num_output: 64 kernel_size: [3] pad: 1
                       weight_filler { type: "xavier" std: 1e-05 } }
  include { phase: 1 }
  loss_weight: [inf, -inf, 2.5e+1, 1, -0.5f];
  blobs { data: [1.0, -2, 3e-3] shape { dim: 3 } }
}
layer { name: "pool" type: "Pooling"
        pooling_param { pool: AVE round_mode: FLOOR global_pooling: true }
        exclude: { phase: TRAIN } }
layers { type: CONVOLUTION name: "v1" }
"""


def test_prototxt_features_match_text_format():
    want = gcaffe.NetParameter()
    text_format.Merge(PROTOTXT, want)
    got = protowire.merge_text(PROTOTXT, pcaffe.NetParameter())
    back = gcaffe.NetParameter()
    back.ParseFromString(got.SerializeToString())
    assert back == want
    assert got.name == "net's" and list(got.input_dim) == [1, -3]
    assert got.layer[0].type == "Convolution"
    assert got.layer[0].convolution_param.weight_filler.std == \
        float(np.float32(1e-5))


@pytest.mark.parametrize("text, what", [
    ("nmae: 'x'", "no field named"),
    ("layer { bottomm: 'x' }", "no field named"),
    ("layer { name 'x' }", "expected ':'"),
    ("layer { pooling_param { pool: MEAN } }", "enum"),
    ("input_dim: 1.5", "integer"),
    ("layer { name: 'x' ", "before the end"),
])
def test_bad_text_is_refused_by_both(text, what):
    with pytest.raises(protowire.ParseError, match=what):
        protowire.merge_text(text, pcaffe.NetParameter())
    with pytest.raises(text_format.ParseError):
        text_format.Merge(text, gcaffe.NetParameter())


def _key(number, wire):
    return protowire._varint((number << 3) | wire)


def test_unknown_fields_are_skipped():
    g = gcaffe.NetParameter(name="n")
    g.layer.add(name="a", type="ReLU").bottom.append("x")
    base = g.SerializeToString()
    junk = (_key(900, 0) + protowire._varint(2 ** 63)
            + _key(901, 1) + struct.pack("<d", 1.5)
            + _key(902, 2) + protowire._varint(3) + b"abc"
            + _key(903, 5) + struct.pack("<f", 2.5)
            + _key(904, 3) + _key(1, 0) + b"\x05" + _key(904, 4))
    p = pcaffe.NetParameter()
    p.ParseFromString(junk + base + junk)
    assert p.SerializeToString() == base
    # also inside a nested message
    layer = _key(1, 2) + protowire._varint(1) + b"a" + junk
    p.ParseFromString(_key(100, 2) + protowire._varint(len(layer)) + layer)
    assert p.layer[0].name == "a"


def test_packed_and_unpacked_are_both_read():
    dims = [3, 224, 2 ** 40, 0]
    unpacked = b"".join(_key(1, 0) + protowire._varint(d) for d in dims)
    p = pcaffe.BlobShape()
    p.ParseFromString(unpacked)       # `dim` is packed in the schema
    assert list(p.dim) == dims
    g = gcaffe.BlobShape()
    g.ParseFromString(unpacked)
    assert list(g.dim) == dims
    assert p.SerializeToString() == g.SerializeToString()
    body = b"".join(protowire._varint(d) for d in (3, 5, 300))
    packed = _key(4, 2) + protowire._varint(len(body)) + body
    c = pcaffe.ConvolutionParameter()
    c.ParseFromString(packed + _key(4, 0) + b"\x07")  # unpacked in schema
    assert list(c.kernel_size) == [3, 5, 300, 7]
    gc = gcaffe.ConvolutionParameter()
    gc.ParseFromString(packed + _key(4, 0) + b"\x07")
    assert c.SerializeToString() == gc.SerializeToString()
    # negative int32s: ten-byte varints both ways
    t = ptf.TensorProto()
    t.int_val.extend([-1, 2 ** 31 - 1, -2 ** 31])
    gt = gtf.TensorProto()
    gt.int_val.extend([-1, 2 ** 31 - 1, -2 ** 31])
    assert t.SerializeToString() == gt.SerializeToString()
    t2 = ptf.TensorProto()
    t2.ParseFromString(gt.SerializeToString())
    assert list(t2.int_val) == [-1, 2 ** 31 - 1, -2 ** 31]


def test_large_packed_floats_go_through_whole():
    rng = np.random.default_rng(0)
    data = rng.standard_normal(4_000_000).astype(np.float32)
    data[::1000] = np.nan
    net = pcaffe.NetParameter()
    blob = net.layer.add(name="fc").blobs.add()
    blob.shape.dim.extend([4000, 1000])
    t0 = time.perf_counter()
    blob.data.extend(data)
    raw = net.SerializeToString()
    back = pcaffe.NetParameter()
    back.ParseFromString(raw)
    arr = np.asarray(back.layer[0].blobs[0].data)
    took = time.perf_counter() - t0
    assert arr.dtype == np.float32 and arr.shape == data.shape
    assert arr.tobytes() == data.tobytes()
    assert took < 5.0, f"{took:.2f} s for 16 MB: not whole-array"
    g = gcaffe.NetParameter()
    g.ParseFromString(raw)
    assert np.asarray(g.layer[0].blobs[0].data, np.float32).tobytes() \
        == data.tobytes()
