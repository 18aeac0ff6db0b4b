"""The schema of bigdl_tf.proto (proto3), as tables for the port's
protobuf codec (utils/protowire.py).

Port of bigdl_tpu/utils/tf/bigdl_tf_pb2.py, which is protoc output over
`google.protobuf`; these tables are transcribed from its serialized
descriptor (bigdl_tpu/utils/tf/bigdl_tf_pb2.py:16) — the wire-compatible
subset of TensorFlow's GraphDef family (graph, node_def, attr_value,
tensor, tensor_shape and types .proto; field numbers from upstream, so
frozen .pb files written by TensorFlow parse here and the reverse):
`TensorShapeProto.Dim`, `TensorProto`, `NameAttrList` (a map),
`AttrValue` (the oneof `value`, `ListValue`), `NodeDef` (the map
`attr`), `VersionDef`, `GraphDef` and the `DataType` enum
(tests/test_torch_protowire.py holds them against the descriptor).

    from bigdl_tpu_torch.utils.tf import bigdl_tf_pb2 as pb
    n = pb.GraphDef().node.add(); n.attr["T"].type = pb.DT_FLOAT
"""

from bigdl_tpu_torch.utils.protowire import REPEATED, Field as F, build

PACKAGE, SYNTAX = "bigdl_tf", "proto3"

ENUMS = {
    "DataType": {
        "DT_INVALID": 0, "DT_FLOAT": 1, "DT_DOUBLE": 2, "DT_INT32": 3,
        "DT_UINT8": 4, "DT_INT16": 5, "DT_INT8": 6, "DT_STRING": 7,
        "DT_COMPLEX64": 8, "DT_INT64": 9, "DT_BOOL": 10, "DT_QINT8": 11,
        "DT_QUINT8": 12, "DT_QINT32": 13, "DT_BFLOAT16": 14, "DT_QINT16": 15,
        "DT_QUINT16": 16, "DT_UINT16": 17, "DT_COMPLEX128": 18, "DT_HALF": 19,
        "DT_RESOURCE": 20, "DT_VARIANT": 21, "DT_UINT32": 22, "DT_UINT64": 23
    },
}

MESSAGES = {
    "TensorShapeProto.Dim": [
        F("size", 1, "int64"),
        F("name", 2, "string"),
    ],
    "TensorShapeProto": [
        F("dim", 2, "message", REPEATED, type_name="TensorShapeProto.Dim"),
        F("unknown_rank", 3, "bool"),
    ],
    "TensorProto": [
        F("dtype", 1, "enum", type_name="DataType"),
        F("tensor_shape", 2, "message", type_name="TensorShapeProto"),
        F("version_number", 3, "int32"),
        F("tensor_content", 4, "bytes"),
        F("float_val", 5, "float", REPEATED, packed=True),
        F("double_val", 6, "double", REPEATED, packed=True),
        F("int_val", 7, "int32", REPEATED, packed=True),
        F("string_val", 8, "bytes", REPEATED),
        F("int64_val", 10, "int64", REPEATED, packed=True),
        F("bool_val", 11, "bool", REPEATED, packed=True),
        F("half_val", 13, "int32", REPEATED, packed=True),
    ],
    "NameAttrList": [
        F("name", 1, "string"),
        F("attr", 2, "map", key_type="string", type_name="AttrValue"),
    ],
    "AttrValue.ListValue": [
        F("s", 2, "bytes", REPEATED),
        F("i", 3, "int64", REPEATED, packed=True),
        F("f", 4, "float", REPEATED, packed=True),
        F("b", 5, "bool", REPEATED, packed=True),
        F("type", 6, "enum", REPEATED, type_name="DataType", packed=True),
        F("shape", 7, "message", REPEATED, type_name="TensorShapeProto"),
        F("tensor", 8, "message", REPEATED, type_name="TensorProto"),
    ],
    "AttrValue": [
        F("list", 1, "message", type_name="AttrValue.ListValue",
          oneof="value"),
        F("s", 2, "bytes", oneof="value"),
        F("i", 3, "int64", oneof="value"),
        F("f", 4, "float", oneof="value"),
        F("b", 5, "bool", oneof="value"),
        F("type", 6, "enum", type_name="DataType", oneof="value"),
        F("shape", 7, "message", type_name="TensorShapeProto", oneof="value"),
        F("tensor", 8, "message", type_name="TensorProto", oneof="value"),
        F("placeholder", 9, "string", oneof="value"),
        F("func", 10, "message", type_name="NameAttrList", oneof="value"),
    ],
    "NodeDef": [
        F("name", 1, "string"),
        F("op", 2, "string"),
        F("input", 3, "string", REPEATED),
        F("device", 4, "string"),
        F("attr", 5, "map", key_type="string", type_name="AttrValue"),
    ],
    "VersionDef": [
        F("producer", 1, "int32"),
        F("min_consumer", 2, "int32"),
        F("bad_consumers", 3, "int32", REPEATED, packed=True),
    ],
    "GraphDef": [
        F("node", 1, "message", REPEATED, type_name="NodeDef"),
        F("versions", 4, "message", type_name="VersionDef"),
    ],
}


globals().update(build(PACKAGE, SYNTAX, ENUMS, MESSAGES))
__all__ = [n for n in list(ENUMS) + list(MESSAGES) if "." not in n] + [
    v for n, e in ENUMS.items() if "." not in n for v in e]
