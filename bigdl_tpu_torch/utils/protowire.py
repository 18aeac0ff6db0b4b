"""A schema-driven protocol-buffer codec: binary wire format and text
format, in pure Python over numpy.

Port-only: the JAX package reads and writes its Caffe and TensorFlow
protos through `google.protobuf` (protoc output,
bigdl_tpu/utils/caffe/bigdl_caffe_pb2.py and
bigdl_tpu/utils/tf/bigdl_tf_pb2.py), which the port does not depend on.
A schema is a set of Python tables (`Field` lists per message, value
maps per enum; utils/caffe/bigdl_caffe_pb2.py, utils/tf/bigdl_tf_pb2.py)
from which `build` makes message classes with the surface the loaders
use:

    net = pb.NetParameter()
    layer = net.layer.add()              # repeated message
    layer.bottom.append("data")          # repeated scalar
    layer.convolution_param.num_output = 3   # marks the parent present
    layer.HasField("convolution_param")  # -> True
    n.attr["T"].type = pb.DT_FLOAT       # map<string, message>, oneof
    data = net.SerializeToString(); net.ParseFromString(data)
    text = to_text(net); merge_text(text, net)

Binary: varint, fixed32/64 and length-delimited fields; repeated
scalars written packed where the schema says so and read packed or
unpacked; unknown fields skipped; fields written in field-number order,
as `google.protobuf` writes them. Repeated numeric fields live in numpy
arrays, and packed ones are read (`np.frombuffer`, a view into the
parsed buffer) and written (`tobytes`) whole, never element by element:
a VGG-16 caffemodel is ~553 MB of packed floats. Semantics follow
protobuf: proto2 fields have presence and defaults; proto3 scalars are
written only when they differ from zero; setting a oneof member clears
the others; a singular message read but never written is not present.

Text format (Caffe's .prototxt): fields in any order, `:` optional
before `{`, `<>` delimiters, enums by name or number, single- or
double-quoted strings (adjacent strings concatenate), `#` comments,
`[a, b]` lists, `inf`/`nan` and signed numbers; an unknown field name
raises `ParseError`, as `text_format.Merge` does.
"""

from __future__ import annotations

import operator
import re
import struct
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Field", "OPTIONAL", "REPEATED", "REQUIRED", "EnumType",
           "Message", "ParseError", "build", "to_text", "merge_text"]

OPTIONAL, REQUIRED, REPEATED = "optional", "required", "repeated"

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5

# scalar type -> (wire type, numpy dtype of a repeated field, zero value)
# (the scalar types the Caffe and TF schemas use)
_SCALARS = {
    "double": (_I64, np.dtype("<f8"), 0.0),
    "float": (_I32, np.dtype("<f4"), 0.0),
    "int64": (_VARINT, np.dtype(np.int64), 0),
    "int32": (_VARINT, np.dtype(np.int32), 0),
    "bool": (_VARINT, np.dtype(np.bool_), False),
    "uint32": (_VARINT, np.dtype(np.uint32), 0),
    "enum": (_VARINT, np.dtype(np.int32), 0),
    "string": (_LEN, None, ""),
    "bytes": (_LEN, None, b""),
}
_INT_RANGE = {"int32": (-2 ** 31, 2 ** 31), "enum": (-2 ** 31, 2 ** 31),
              "uint32": (0, 2 ** 32), "int64": (-2 ** 63, 2 ** 63)}
_FIXED = {"float": "<f", "double": "<d"}


class ParseError(ValueError):
    """Malformed binary or text input, or a field the schema lacks."""


class Field:
    """One field of a message schema. `type` is a scalar type name
    ("int32", "float", "string", ...), "enum" or "message" (with
    `type_name`, the name of the enum or message), or "map" (with
    `key_type` and the message values' `type_name`). `default` is the
    proto2 default (an enum's by name); `oneof` names the oneof the
    field belongs to."""

    __slots__ = ("name", "number", "type", "label", "default", "packed",
                 "type_name", "oneof", "key_type", "has_default", "cls",
                 "enum", "wire", "dtype")

    def __init__(self, name: str, number: int, type: str,
                 label: str = OPTIONAL, default: Any = None,
                 packed: bool = False, type_name: Optional[str] = None,
                 oneof: Optional[str] = None, key_type: Optional[str] = None):
        self.name, self.number, self.type, self.label = name, number, type, \
            label
        self.default, self.packed, self.type_name = default, packed, type_name
        self.oneof, self.key_type = oneof, key_type
        self.has_default = default is not None
        self.cls = None      # message class (message, map of messages)
        self.enum = None     # EnumType (enum fields)
        self.wire = None
        self.dtype = None

    @property
    def repeated(self) -> bool:
        return self.label == REPEATED

    def __repr__(self):
        return f"Field({self.name!r}, {self.number}, {self.type!r})"


class EnumType:
    """An enum of a schema: `Value(name)`, `items()`, and each value as
    an attribute (`Phase.TEST`)."""

    def __init__(self, full_name: str, values: Dict[str, int]):
        self.full_name = full_name
        self.closed = True      # proto2: unknown values are refused
        self.values = dict(values)
        self._names = {}
        for k, v in self.values.items():
            self._names.setdefault(v, k)
        for k, v in self.values.items():
            setattr(self, k, v)

    def Value(self, name: str) -> int:
        try:
            return self.values[name]
        except KeyError:
            raise ValueError(f"enum {self.full_name} has no value "
                             f"named {name!r}") from None

    def items(self):
        return list(self.values.items())

    def __repr__(self):
        return f"EnumType({self.full_name!r})"


# ------------------------------------------------------------ value checks


def _coerce(f_type: str, enum: Optional[EnumType], value: Any) -> Any:
    """A Python value for a scalar of type `f_type`, as protobuf accepts
    it on assignment (floats are rounded to float32 for `float`)."""
    if f_type in ("float", "double"):
        if isinstance(value, (str, bytes)) or value is None:
            raise TypeError(f"{value!r} has type {type(value).__name__}, "
                            f"but expected one of: int, float")
        v = float(value)
        if f_type == "float":
            with np.errstate(over="ignore"):
                v = float(np.float32(v))
        return v
    if f_type == "bool":
        if isinstance(value, (str, bytes, float)) or value is None:
            raise TypeError(f"{value!r} has type {type(value).__name__}, "
                            f"but expected one of: bool, int")
        return bool(value)
    if f_type == "string":
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{value!r} has type {type(value).__name__}, "
                            f"but expected one of: bytes, str")
        return value
    if f_type == "bytes":
        if isinstance(value, str):
            return value.encode("utf-8")
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"{value!r} has type {type(value).__name__}, "
                            f"but expected one of: bytes")
        return bytes(value)
    try:
        v = operator.index(value)
    except TypeError:
        raise TypeError(f"{value!r} has type {type(value).__name__}, but "
                        f"expected one of: int") from None
    lo, hi = _INT_RANGE[f_type]
    if not lo <= v < hi:
        raise ValueError(f"value out of range: {v}")
    if f_type == "enum" and enum is not None and enum.closed \
            and v not in enum._names:
        raise ValueError(f"unknown enum value {v} for {enum.full_name}")
    return v


def _zero(f: Field) -> Any:
    return _SCALARS[f.type][2]


# ------------------------------------------------------------ containers


class RepeatedNumbers:
    """A repeated numeric (or enum, or bool) field over a numpy array.
    Indexing and iteration give Python scalars; `np.asarray(field)`
    gives the array itself, without a copy."""

    __slots__ = ("_owner", "_field", "_arr")

    def __init__(self, owner: "Message", field: Field):
        self._owner, self._field = owner, field
        self._arr = np.zeros(0, field.dtype)

    def _set(self, arr: np.ndarray) -> None:
        self._arr = arr
        self._owner._modified()

    def _check(self, values: np.ndarray, source: Any) -> np.ndarray:
        t = self._field.type
        if t in ("float", "double"):
            return values.astype(self._field.dtype, copy=False)
        if values.dtype.kind == "f" or values.dtype == object:
            return np.asarray([_coerce(t, self._field.enum, v)
                               for v in source], self._field.dtype)
        if t != "bool" and values.size:
            lo, hi = _INT_RANGE[t]
            if int(values.min()) < lo or int(values.max()) >= hi:
                raise ValueError(f"value out of range in {source!r}")
        if t == "enum" and self._field.enum is not None \
                and self._field.enum.closed:
            bad = set(np.unique(values).tolist()) - set(
                self._field.enum._names)
            if bad:
                raise ValueError(f"unknown enum values {sorted(bad)} for "
                                 f"{self._field.enum.full_name}")
        return values.astype(self._field.dtype, copy=False)

    def append(self, value: Any) -> None:
        v = _coerce(self._field.type, self._field.enum, value)
        self._set(np.concatenate([self._arr,
                                  np.asarray([v], self._field.dtype)]))

    def extend(self, values: Iterable[Any]) -> None:
        if isinstance(values, np.ndarray):
            arr = values.reshape(-1)
        else:
            values = list(values)
            if any(isinstance(v, (str, bytes)) for v in values):
                raise TypeError(f"{values!r} holds non-numbers")
            arr = np.asarray(values) if values else \
                np.zeros(0, self._field.dtype)
        arr = self._check(arr, values)
        self._set(arr.copy() if not len(self._arr) else
                  np.concatenate([self._arr, arr]))

    def __len__(self) -> int:
        return len(self._arr)

    def __iter__(self):
        return iter(self._arr.tolist())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._arr[i].tolist()
        return self._arr[i].item()

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedNumbers):
            other = other._arr
        try:
            return len(self) == len(other) and bool(
                np.array_equal(self._arr, np.asarray(other)))
        except TypeError:
            return False

    def __array__(self, dtype=None, copy=None):
        if dtype is None:
            return self._arr
        return self._arr.astype(dtype, copy=bool(copy))

    def __repr__(self):
        return repr(self._arr.tolist())


class RepeatedValues(list):
    """A repeated string or bytes field: a list whose mutators check
    each value's type and mark the owning message present."""

    def __init__(self, owner: "Message", field: Field):
        super().__init__()
        self._owner, self._field = owner, field

    def _c(self, v):
        return _coerce(self._field.type, None, v)

    def append(self, value) -> None:
        super().append(self._c(value))
        self._owner._modified()

    def extend(self, values) -> None:
        super().extend([self._c(v) for v in values])
        self._owner._modified()

    def __setitem__(self, i, value) -> None:
        if isinstance(i, slice):
            super().__setitem__(i, [self._c(v) for v in value])
        else:
            super().__setitem__(i, self._c(value))
        self._owner._modified()

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._owner._modified()


class RepeatedMessages(list):
    """A repeated message field: `add(**fields)` appends a new element
    and returns it."""

    def __init__(self, owner: "Message", field: Field):
        super().__init__()
        self._owner, self._field = owner, field

    def add(self, **kwargs) -> "Message":
        m = self._field.cls(**kwargs)
        super().append(m)
        self._owner._modified()
        return m

    def append(self, msg: "Message") -> None:
        m = self._field.cls()
        m.MergeFrom(msg)
        super().append(m)
        self._owner._modified()

    def extend(self, msgs) -> None:
        for m in msgs:
            self.append(m)

    def __setitem__(self, i, value) -> None:
        raise TypeError("a repeated message field takes add() or append()")

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._owner._modified()


class MessageMap(dict):
    """A map field of message values: reading a missing key inserts a
    new value, as protobuf's message maps do."""

    def __init__(self, owner: "Message", field: Field):
        super().__init__()
        self._owner, self._field = owner, field

    def _key(self, k):
        return _coerce(self._field.key_type, None, k)

    def __getitem__(self, k):
        k = self._key(k)
        if k not in self:
            super().__setitem__(k, self._field.cls())
            self._owner._modified()
        return super().__getitem__(k)

    def __setitem__(self, k, v) -> None:
        raise ValueError("a map of messages takes m[key].field = ...")

    def __contains__(self, k) -> bool:
        return dict.__contains__(self, k)

    def get(self, k, default=None):
        return dict.get(self, k, default)

    def __delitem__(self, k) -> None:
        super().__delitem__(k)
        self._owner._modified()


# ------------------------------------------------------------ message base


class Message:
    """Base of the generated message classes (one per schema message;
    see `build`)."""

    __slots__ = ("_values", "_present", "_parent")
    DESCRIPTOR_NAME = ""
    _fields: Dict[str, Field] = {}
    _by_number: Dict[int, Field] = {}
    _ordered: Tuple[Field, ...] = ()
    _oneofs: Dict[str, Tuple[str, ...]] = {}
    _proto3 = False

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for k, v in kwargs.items():
            f = self._field(k)
            if f.type == "map":
                for mk, mv in v.items():
                    getattr(self, k)[mk].MergeFrom(mv)
            elif f.repeated:
                getattr(self, k).extend(v)
            elif f.type == "message":
                getattr(self, k).MergeFrom(v)
                self._mark(k)
            else:
                setattr(self, k, v)

    @classmethod
    def _field(cls, name: str) -> Field:
        try:
            return cls._fields[name]
        except KeyError:
            raise ValueError(f'Protocol message {cls.DESCRIPTOR_NAME} has '
                             f'no "{name}" field.') from None

    # ---- presence ----------------------------------------------------
    def _modified(self) -> None:
        parent = self._parent
        if parent is not None:
            parent[0]._mark(parent[1])

    def _mark(self, name: str) -> None:
        if name not in self._present:
            f = self._fields[name]
            if f.oneof is not None:
                for other in self._oneofs[f.oneof]:
                    if other != name and other in self._present:
                        self._present.discard(other)
                        self._values.pop(other, None)
            self._present.add(name)
        self._modified()

    def SetInParent(self) -> None:
        """Mark this (possibly empty) sub-message present in its parent."""
        self._modified()

    def HasField(self, name: str) -> bool:
        if name in self._oneofs:
            return any(m in self._present for m in self._oneofs[name])
        f = self._field(name)
        if f.repeated or f.type == "map":
            raise ValueError(f"Protocol message has no singular "
                             f'"{name}" field.')
        if self._proto3 and f.type != "message" and f.oneof is None:
            raise ValueError(f"Can't test non-optional, non-submessage "
                             f'field "{self.DESCRIPTOR_NAME}.{name}" '
                             f"for presence in proto3.")
        return name in self._present

    def WhichOneof(self, oneof: str) -> Optional[str]:
        if oneof not in self._oneofs:
            raise ValueError(f'Protocol message has no oneof "{oneof}" '
                             f"field.")
        for m in self._oneofs[oneof]:
            if m in self._present:
                return m
        return None

    def ClearField(self, name: str) -> None:
        if name in self._oneofs:
            for m in self._oneofs[name]:
                self.ClearField(m)
            return
        self._field(name)
        self._present.discard(name)
        self._values.pop(name, None)

    def Clear(self) -> None:
        self._values.clear()
        self._present.clear()

    def ListFields(self) -> List[Tuple[Field, Any]]:
        """(field, value) of every field that would be written, in
        field-number order."""
        out = []
        for f in self._ordered:
            v = self._values.get(f.name)
            if f.repeated or f.type == "map":
                if v is not None and len(v):
                    out.append((f, v))
            elif f.name in self._present:
                if not (self._proto3 and f.oneof is None
                        and f.type != "message" and v == _zero(f)):
                    out.append((f, v))
        return out

    # ---- copies and equality -------------------------------------------
    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"MergeFrom expects a {type(self).__name__}, "
                            f"got {type(other).__name__}")
        for f, v in other.ListFields():
            if f.type == "map":
                mine = getattr(self, f.name)
                for k, mv in v.items():
                    dict.pop(mine, k, None)
                    mine[k].MergeFrom(mv)
            elif f.repeated:
                if f.type == "message":
                    getattr(self, f.name).extend(v)
                elif f.dtype is not None:
                    getattr(self, f.name).extend(np.asarray(v))
                else:
                    getattr(self, f.name).extend(v)
            elif f.type == "message":
                getattr(self, f.name).MergeFrom(v)
                self._mark(f.name)
            else:
                self._values[f.name] = v
                self._mark(f.name)

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        a, b = self.ListFields(), other.ListFields()
        if [f.name for f, _ in a] != [f.name for f, _ in b]:
            return False
        for (f, x), (_, y) in zip(a, b):
            if f.type == "map":
                if dict(x) != dict(y):
                    return False
            elif f.repeated and f.dtype is not None:
                if not np.array_equal(np.asarray(x), np.asarray(y)):
                    return False
            elif f.repeated:
                if list(x) != list(y):
                    return False
            elif x != y:
                return False
        return True

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None

    def __repr__(self):
        return to_text(self)

    def __str__(self):
        return to_text(self)

    # ---- binary --------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out: List[Any] = []
        _encode(self, out)
        return b"".join(out)

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    def MergeFromString(self, data) -> int:
        buf = data if isinstance(data, bytes) else bytes(data)
        mv = memoryview(buf)
        _decode(self, buf, mv, 0, len(buf))
        self._modified()
        return len(buf)


def _property(f: Field):
    name = f.name

    if f.type == "map":
        def get(self):
            v = self._values.get(name)
            if v is None:
                v = self._values[name] = MessageMap(self, f)
            return v
    elif f.repeated:
        kind = RepeatedMessages if f.type == "message" else \
            RepeatedNumbers if f.dtype is not None else RepeatedValues

        def get(self):
            v = self._values.get(name)
            if v is None:
                v = self._values[name] = kind(self, f)
            return v
    elif f.type == "message":
        def get(self):
            v = self._values.get(name)
            if v is None:
                v = f.cls()
                object.__setattr__(v, "_parent", (self, name))
                self._values[name] = v
            return v
    else:
        def get(self):
            if name in self._present:
                return self._values[name]
            return f.default

    def set_(self, value):
        if f.repeated or f.type in ("message", "map"):
            raise AttributeError(
                f'Assignment not allowed to field "{name}" in protocol '
                f"message object (a {'repeated' if f.repeated else 'message'}"
                f" field)")
        self._values[name] = _coerce(f.type, f.enum, value)
        self._mark(name)

    return property(get, set_)


# ------------------------------------------------------------ schema


def build(package: str, syntax: str, enums: Dict[str, Dict[str, int]],
          messages: Dict[str, Sequence[Field]]) -> Dict[str, Any]:
    """Message classes and enums of one schema file. `enums` and
    `messages` are keyed by name, a nested type as "Outer.Inner". The
    result maps each top-level message and enum to its class or
    EnumType, and each top-level enum value to its number (as protoc's
    Python modules do); a nested type is an attribute of its outer
    class, and a nested enum's values are attributes of it too."""
    proto3 = syntax == "proto3"
    enum_types = {n: EnumType(f"{package}.{n}", v) for n, v in enums.items()}
    for et in enum_types.values():
        et.closed = not proto3
    classes: Dict[str, type] = {}
    for name in messages:
        classes[name] = type(name.split(".")[-1], (Message,), {
            "__slots__": (), "DESCRIPTOR_NAME": f"{package}.{name}",
            "_proto3": proto3, "__qualname__": name,
            "__module__": f"{package}_pb"})

    def resolve(owner: str, type_name: str, table: Dict[str, Any]):
        # protobuf's scoping: innermost enclosing scope first
        scope = owner.split(".")
        for i in range(len(scope), -1, -1):
            cand = ".".join(scope[:i] + [type_name])
            if cand in table:
                return table[cand]
        raise KeyError(f"{owner}: unknown type {type_name!r}")

    for name, fields in messages.items():
        cls = classes[name]
        by_name, oneofs = {}, {}
        for f in fields:
            if f.type in ("message", "map"):
                f.cls = resolve(name, f.type_name, classes)
            if f.type == "enum":
                f.enum = resolve(name, f.type_name, enum_types)
            if f.type not in ("message", "map"):
                f.wire, f.dtype = _SCALARS[f.type][:2]
            if f.default is None and not f.repeated and f.type not in (
                    "message", "map"):
                f.default = (f.enum.values[next(iter(f.enum.values))]
                             if f.enum is not None and not proto3
                             else _SCALARS[f.type][2])
            elif isinstance(f.default, str) and f.enum is not None:
                f.default = f.enum.Value(f.default)
            elif f.default is not None:
                f.default = _coerce(f.type, None, f.default)
            if f.oneof is not None:
                oneofs.setdefault(f.oneof, []).append(f.name)
            by_name[f.name] = f
            setattr(cls, f.name, _property(f))
        cls._fields = by_name
        cls._by_number = {f.number: f for f in fields}
        cls._ordered = tuple(sorted(fields, key=lambda f: f.number))
        cls._oneofs = {k: tuple(v) for k, v in oneofs.items()}
    out: Dict[str, Any] = {}
    for name, et in enum_types.items():
        if "." in name:
            outer, inner = name.rsplit(".", 1)
            setattr(classes[outer], inner, et)
            for k, v in et.values.items():
                setattr(classes[outer], k, v)
        else:
            out[name] = et
            out.update(et.values)
    for name, cls in classes.items():
        if "." in name:
            outer, inner = name.rsplit(".", 1)
            setattr(classes[outer], inner, cls)
        else:
            out[name] = cls
    return out


# ------------------------------------------------------------ wire encode


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _tag(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _varints(arr: np.ndarray) -> bytes:
    """Packed varints of an integer array, all at once (negatives as
    their 64-bit two's complement, ten bytes)."""
    if arr.size == 0:
        return b""
    v = arr.astype(np.int64).view(np.uint64) if arr.dtype.kind != "u" \
        else arr.astype(np.uint64)
    if bool((v < 0x80).all()):
        return v.astype(np.uint8).tobytes()
    groups = np.stack([(v >> np.uint64(7 * k)) & np.uint64(0x7F)
                       for k in range(10)], axis=1).astype(np.uint8)
    nbytes = np.ones(v.shape, np.int64)
    for k in range(1, 10):
        nbytes += (v >> np.uint64(7 * k)) > 0
    keep = np.arange(10)[None, :] < nbytes[:, None]
    cont = np.arange(10)[None, :] < (nbytes - 1)[:, None]
    groups = groups | (cont.astype(np.uint8) << 7)
    return groups[keep].tobytes()


def _scalar_bytes(f_type: str, v: Any) -> bytes:
    if f_type in ("int32", "int64", "uint32", "enum"):
        return _varint(int(v))
    if f_type == "bool":
        return b"\x01" if v else b"\x00"
    if f_type in _FIXED:
        return struct.pack(_FIXED[f_type], v)
    if f_type == "string":
        b = v.encode("utf-8")
        return _varint(len(b)) + b
    b = bytes(v)
    return _varint(len(b)) + b


def _packed(f_type: str, arr: np.ndarray):
    """The payload of a packed field: a buffer over the array's bytes
    for floats and doubles (no element-by-element work)."""
    if f_type in _FIXED:
        a = np.ascontiguousarray(arr, dtype=_SCALARS[f_type][1])
        return memoryview(a).cast("B"), a.nbytes
    b = arr.astype(np.uint8).tobytes() if f_type == "bool" \
        else _varints(arr)
    return b, len(b)


def _encode(msg: Message, out: List[Any]) -> int:
    """Append `msg`'s encoding to `out` as a list of chunks; returns its
    length in bytes."""
    n = 0
    for f, v in msg.ListFields():
        if f.type == "map":
            for k, mv in dict.items(v):
                key = _tag(1, _SCALARS[f.key_type][0]) + _scalar_bytes(
                    f.key_type, k)
                inner: List[Any] = []
                m = _encode(mv, inner)
                value = _tag(2, _LEN) + _varint(m)
                size = len(key) + len(value) + m
                head = _tag(f.number, _LEN) + _varint(size)
                out.extend([head, key, value])
                out.extend(inner)
                n += len(head) + size
        elif f.repeated and f.type == "message":
            for child in v:
                inner = []
                m = _encode(child, inner)
                head = _tag(f.number, _LEN) + _varint(m)
                out.append(head)
                out.extend(inner)
                n += len(head) + m
        elif f.repeated and f.dtype is not None:
            arr = np.asarray(v)
            if f.packed:
                payload, m = _packed(f.type, arr)
                head = _tag(f.number, _LEN) + _varint(m)
                out.append(head)
                out.append(payload)
                n += len(head) + m
            else:
                tag = _tag(f.number, f.wire)
                for x in arr.tolist():
                    b = tag + _scalar_bytes(f.type, x)
                    out.append(b)
                    n += len(b)
        elif f.repeated:
            tag = _tag(f.number, _LEN)
            for x in v:
                b = tag + _scalar_bytes(f.type, x)
                out.append(b)
                n += len(b)
        elif f.type == "message":
            inner = []
            m = _encode(v, inner)
            head = _tag(f.number, _LEN) + _varint(m)
            out.append(head)
            out.extend(inner)
            n += len(head) + m
        else:
            b = _tag(f.number, f.wire) + _scalar_bytes(f.type, v)
            out.append(b)
            n += len(b)
    return n


# ------------------------------------------------------------ wire decode


def _read_varint(mv: memoryview, pos: int, end: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while True:
        if pos >= end:
            raise ParseError("truncated varint")
        b = mv[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise ParseError("varint too long")


def _skip(mv: memoryview, pos: int, end: int, wire: int, number: int) -> int:
    if wire == _VARINT:
        return _read_varint(mv, pos, end)[1]
    if wire == _I64:
        pos += 8
    elif wire == _I32:
        pos += 4
    elif wire == _LEN:
        n, pos = _read_varint(mv, pos, end)
        pos += n
    elif wire == _SGROUP:
        while True:
            key, pos = _read_varint(mv, pos, end)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise ParseError("mismatched end-group tag")
                return pos
            pos = _skip(mv, pos, end, key & 7, key >> 3)
    else:
        raise ParseError(f"bad wire type {wire}")
    if pos > end:
        raise ParseError("truncated field")
    return pos


def _from_varint(f_type: str, v: int) -> Any:
    if f_type in ("int32", "enum"):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    if f_type == "int64":
        v &= 0xFFFFFFFFFFFFFFFF
        return v - (1 << 64) if v >= 1 << 63 else v
    if f_type == "uint32":
        return v & 0xFFFFFFFF
    if f_type == "bool":
        return v != 0
    raise ParseError(f"{f_type} read as a varint")


def _read_scalar(f: Field, buf, mv, pos: int, end: int, wire: int):
    if wire != f.wire:
        raise ParseError(f"field {f.name}: wire type {wire}, expected "
                         f"{f.wire}")
    if wire == _VARINT:
        v, pos = _read_varint(mv, pos, end)
        return _from_varint(f.type, v), pos
    if wire in (_I32, _I64):
        size = 4 if wire == _I32 else 8
        if pos + size > end:
            raise ParseError("truncated fixed-width field")
        return struct.unpack_from(_FIXED[f.type], buf, pos)[0], pos + size
    n, pos = _read_varint(mv, pos, end)
    if pos + n > end:
        raise ParseError("truncated length-delimited field")
    raw = bytes(mv[pos:pos + n])
    if f.type == "string":
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise ParseError(f"field {f.name}: invalid UTF-8") from e
    return raw, pos + n


def _unpack_varints(raw: np.ndarray) -> np.ndarray:
    """Decode a packed run of varints (uint8 array) to uint64, all at
    once."""
    if raw.size == 0:
        return np.zeros(0, np.uint64)
    if bool((raw < 0x80).all()):
        return raw.astype(np.uint64)
    ends = raw < 0x80
    if not ends[-1]:
        raise ParseError("truncated packed varint")
    elem = np.concatenate([[0], np.cumsum(ends)[:-1]])
    start = np.flatnonzero(np.concatenate([[True], ends[:-1]]))
    pos_in = np.arange(raw.size) - start[elem]
    if int(pos_in.max()) >= 10:
        raise ParseError("varint too long")
    parts = (raw & 0x7F).astype(np.uint64) << (7 * pos_in).astype(np.uint64)
    out = np.zeros(int(ends.sum()), np.uint64)
    np.bitwise_or.at(out, elem, parts)
    return out


def _read_packed(f: Field, buf, pos: int, n: int) -> np.ndarray:
    if f.type in _FIXED:
        size = f.dtype.itemsize
        if n % size:
            raise ParseError(f"field {f.name}: packed length {n} is not a "
                             f"multiple of {size}")
        return np.frombuffer(buf, f.dtype, n // size, pos)
    u = _unpack_varints(np.frombuffer(buf, np.uint8, n, pos))
    if f.type == "bool":
        return u != 0
    if f.type in ("int32", "enum"):
        return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    if f.type == "uint32":
        return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return u.view(np.int64)


def _decode(msg: Message, buf, mv: memoryview, pos: int, end: int) -> None:
    cls = type(msg)
    pending: Dict[str, List[Any]] = {}
    values, present = msg._values, msg._present
    while pos < end:
        key, pos = _read_varint(mv, pos, end)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise ParseError("field number 0")
        f = cls._by_number.get(number)
        if f is None:
            pos = _skip(mv, pos, end, wire, number)
            continue
        if f.type in ("message", "map"):
            if wire != _LEN:
                raise ParseError(f"field {f.name}: wire type {wire}")
            n, pos = _read_varint(mv, pos, end)
            if pos + n > end:
                raise ParseError(f"field {f.name}: truncated message")
            if f.type == "map":
                _decode_entry(getattr(msg, f.name), f, buf, mv, pos, pos + n)
            elif f.repeated:
                child = f.cls()
                _decode(child, buf, mv, pos, pos + n)
                list.append(getattr(msg, f.name), child)
            else:
                child = getattr(msg, f.name)
                _decode(child, buf, mv, pos, pos + n)
                msg._mark(f.name) if f.oneof is not None else \
                    present.add(f.name)
            pos += n
        elif f.repeated and f.dtype is not None:
            if wire == _LEN:
                n, pos = _read_varint(mv, pos, end)
                if pos + n > end:
                    raise ParseError(f"field {f.name}: truncated packed")
                pending.setdefault(f.name, []).append(
                    _read_packed(f, buf, pos, n))
                pos += n
            else:
                v, pos = _read_scalar(f, buf, mv, pos, end, wire)
                pending.setdefault(f.name, []).append(
                    np.asarray([v], f.dtype))
        elif f.repeated:
            v, pos = _read_scalar(f, buf, mv, pos, end, wire)
            list.append(getattr(msg, f.name), v)
        else:
            v, pos = _read_scalar(f, buf, mv, pos, end, wire)
            values[f.name] = v
            if f.oneof is not None:
                msg._mark(f.name)
            else:
                present.add(f.name)
    if pos != end:
        raise ParseError("message overruns its length")
    for name, chunks in pending.items():
        field = getattr(msg, name)
        parts = ([field._arr] if len(field._arr) else []) + chunks
        field._arr = parts[0] if len(parts) == 1 else np.concatenate(parts)


def _decode_entry(target: MessageMap, f: Field, buf, mv, pos, end) -> None:
    key = _SCALARS[f.key_type][2]
    value = f.cls()
    kfield = Field("key", 1, f.key_type)
    kfield.wire, kfield.dtype = _SCALARS[f.key_type][:2]
    while pos < end:
        k, pos = _read_varint(mv, pos, end)
        number, wire = k >> 3, k & 7
        if number == 1:
            key, pos = _read_scalar(kfield, buf, mv, pos, end, wire)
        elif number == 2 and wire == _LEN:
            n, pos = _read_varint(mv, pos, end)
            value = f.cls()
            _decode(value, buf, mv, pos, pos + n)
            pos += n
        else:
            pos = _skip(mv, pos, end, wire, number)
    dict.__setitem__(target, key, value)


# ------------------------------------------------------------ text format


def _escape(raw: bytes) -> str:
    out = []
    for b in raw:
        c = chr(b)
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif c == "'":
            out.append("\\'")
        elif 32 <= b < 127:
            out.append(c)
        else:
            out.append("\\%03o" % b)
    return "".join(out)


def _text_value(f_type: str, enum: Optional[EnumType], v: Any) -> str:
    if f_type == "bool":
        return "true" if v else "false"
    if f_type in ("float", "double"):
        if np.isnan(v):
            return "nan"
        if np.isinf(v):
            return "inf" if v > 0 else "-inf"
        s = str(np.float32(v)) if f_type == "float" else repr(float(v))
        return s
    if f_type == "string":
        return '"' + _escape(v.encode("utf-8")) + '"'
    if f_type == "bytes":
        return '"' + _escape(v) + '"'
    if f_type == "enum" and enum is not None and v in enum._names:
        return enum._names[v]
    return str(int(v))


def _print(msg: Message, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    for f, v in msg.ListFields():
        if f.type == "map":
            for k, mv in dict.items(v):
                lines.append(f"{pad}{f.name} {{")
                lines.append(f"{pad}  key: "
                             f"{_text_value(f.key_type, None, k)}")
                lines.append(f"{pad}  value {{")
                _print(mv, indent + 4, lines)
                lines.append(f"{pad}  }}")
                lines.append(f"{pad}}}")
        elif f.type == "message":
            for child in (v if f.repeated else [v]):
                lines.append(f"{pad}{f.name} {{")
                _print(child, indent + 2, lines)
                lines.append(f"{pad}}}")
        else:
            for x in (v if f.repeated else [v]):
                lines.append(f"{pad}{f.name}: "
                             f"{_text_value(f.type, f.enum, x)}")


def to_text(msg: Message) -> str:
    """The protobuf text format of `msg` (one field a line, nested
    messages indented by two), as `text_format.MessageToString` writes
    it."""
    lines: List[str] = []
    _print(msg, 0, lines)
    return "".join(line + "\n" for line in lines)


_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<num>[-+]?(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)
            [fF]?(?![\w.]))
  | (?P<id>[A-Za-z_][\w.]*)
  | (?P<sym>[-+{}<>:\[\],;])
""", re.VERBOSE)

_ESCAPES = {"n": 10, "t": 9, "r": 13, '"': 34, "'": 39, "\\": 92, "a": 7,
            "b": 8, "f": 12, "v": 11, "?": 63}


def _unescape(body: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        i += 1
        c = body[i]
        if c in _ESCAPES:
            out.append(_ESCAPES[c])
            i += 1
        elif c in "01234567":
            j = i
            while j < len(body) and j < i + 3 and body[j] in "01234567":
                j += 1
            out.append(int(body[i:j], 8) & 0xFF)
            i = j
        elif c in "xX":
            j = i + 1
            while j < len(body) and j < i + 3 and \
                    body[j] in "0123456789abcdefABCDEF":
                j += 1
            out.append(int(body[i + 1:j], 16))
            i = j
        else:
            raise ParseError(f"bad escape \\{c}")
    return bytes(out)


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[Tuple[str, str, int]] = []
        pos, line = 0, 1
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None:
                raise ParseError(f"{line}: unexpected {text[pos:pos + 10]!r}")
            kind = m.lastgroup
            if kind != "ws":
                self.toks.append((kind, m.group(kind), line))
            line += m.group(0).count("\n")
            pos = m.end()
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str, int]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str, int]:
        if self.i >= len(self.toks):
            raise ParseError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, sym: str) -> bool:
        t = self.peek()
        if t is not None and t[0] == "sym" and t[1] == sym:
            self.i += 1
            return True
        return False

    def expect(self, sym: str) -> None:
        t = self.next()
        if t[0] != "sym" or t[1] != sym:
            raise ParseError(f"{t[2]}: expected {sym!r}, got {t[1]!r}")


_FLOAT_WORDS = {"inf": float("inf"), "infinity": float("inf"),
                "nan": float("nan")}


def _parse_scalar(toks: _Tokens, f_type: str, enum: Optional[EnumType],
                  where: str) -> Any:
    kind, tok, line = toks.next()
    sign = 1
    if kind == "sym" and tok in "-+":
        sign = -1 if tok == "-" else 1
        kind, tok, line = toks.next()
        if kind not in ("num", "id"):
            raise ParseError(f"{line}: {where}: a number after the sign")
    if f_type in ("string", "bytes"):
        if kind != "str":
            raise ParseError(f"{line}: {where}: expected a string, got "
                             f"{tok!r}")
        raw = _unescape(tok[1:-1])
        while toks.peek() is not None and toks.peek()[0] == "str":
            raw += _unescape(toks.next()[1][1:-1])
        if f_type == "bytes":
            return raw
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ParseError(f"{line}: {where}: invalid UTF-8") from e
    if f_type == "bool":
        if kind == "id" and tok in ("true", "True", "t"):
            return True
        if kind == "id" and tok in ("false", "False", "f"):
            return False
        if kind == "num" and tok in ("0", "1"):
            return tok == "1"
        raise ParseError(f"{line}: {where}: expected a bool, got {tok!r}")
    if f_type in ("float", "double"):
        if kind == "id" and tok.lower() in _FLOAT_WORDS:
            return _coerce(f_type, None, sign * _FLOAT_WORDS[tok.lower()])
        if kind != "num":
            raise ParseError(f"{line}: {where}: expected a number, got "
                             f"{tok!r}")
        hexa = tok.lower().lstrip("+-").startswith("0x")
        v = float(int(tok, 16)) if hexa else float(tok.rstrip("fF"))
        return _coerce(f_type, None, sign * v)
    if f_type == "enum":
        if kind == "id":
            if sign < 0 or enum is None or tok not in enum.values:
                raise ParseError(f"{line}: {where}: enum has no value "
                                 f"named {tok!r}")
            return enum.values[tok]
    low = tok.lower().lstrip("+-")
    if kind != "num" or not low.startswith("0x") and (
            re.search(r"[.e]", low) or low.endswith("f")):
        raise ParseError(f"{line}: {where}: expected an integer, got "
                         f"{tok!r}")
    v = sign * (int(tok, 8) if re.fullmatch(r"[-+]?0\d+", tok)
                else int(tok, 0))
    try:
        return _coerce(f_type, enum, v)
    except (TypeError, ValueError) as e:
        raise ParseError(f"{line}: {where}: {e}") from None


def _parse_fields(toks: _Tokens, msg: Message, close: Optional[str]) -> None:
    while True:
        t = toks.peek()
        if t is None:
            if close is not None:
                raise ParseError(f"expected {close!r} before the end")
            return
        if t[0] == "sym" and t[1] == close:
            toks.next()
            return
        kind, name, line = toks.next()
        if kind != "id":
            raise ParseError(f"{line}: expected a field name, got {name!r}")
        f = type(msg)._fields.get(name)
        if f is None:
            raise ParseError(f'{line}: Message type '
                             f'"{msg.DESCRIPTOR_NAME}" has no field named '
                             f'"{name}".')
        where = f"{msg.DESCRIPTOR_NAME}.{name}"
        if f.type in ("message", "map"):
            toks.accept(":")
            if toks.accept("["):
                if not toks.accept("]"):
                    while True:
                        _parse_message_value(toks, msg, f, where)
                        if toks.accept("]"):
                            break
                        toks.expect(",")
            else:
                _parse_message_value(toks, msg, f, where)
        else:
            toks.expect(":")
            if toks.accept("["):
                if not f.repeated:
                    raise ParseError(f"{line}: {where} is not repeated")
                vals = []
                if not toks.accept("]"):
                    while True:
                        vals.append(_parse_scalar(toks, f.type, f.enum,
                                                  where))
                        if toks.accept("]"):
                            break
                        toks.expect(",")
                getattr(msg, name).extend(vals)
            else:
                v = _parse_scalar(toks, f.type, f.enum, where)
                if f.repeated:
                    getattr(msg, name).append(v)
                else:
                    setattr(msg, name, v)
        toks.accept(",") or toks.accept(";")


def _parse_message_value(toks: _Tokens, msg: Message, f: Field,
                         where: str) -> None:
    if toks.accept("{"):
        close = "}"
    elif toks.accept("<"):
        close = ">"
    else:
        t = toks.peek()
        raise ParseError(f"{t[2] if t else 'end'}: {where}: expected '{{' "
                         f"or '<'")
    if f.type == "map":
        entry = _MapEntry(f)
        _parse_fields(toks, entry, close)
        target = getattr(msg, f.name)
        dict.pop(target, entry.key, None)
        target[entry.key].MergeFrom(entry.value)
    elif f.repeated:
        _parse_fields(toks, getattr(msg, f.name).add(), close)
    else:
        child = getattr(msg, f.name)
        _parse_fields(toks, child, close)
        msg._mark(f.name)


def _MapEntry(f: Field) -> Message:
    """A throwaway message class for one map entry's text."""
    key = Field("key", 1, f.key_type)
    key.wire, key.dtype = _SCALARS[f.key_type][:2]
    key.default = _SCALARS[f.key_type][2]
    value = Field("value", 2, "message")
    value.cls = f.cls
    cls = type("Entry", (Message,), {"__slots__": (),
                                     "DESCRIPTOR_NAME": f"{f.name}.Entry"})
    for fld in (key, value):
        setattr(cls, fld.name, _property(fld))
    cls._fields = {"key": key, "value": value}
    cls._by_number = {1: key, 2: value}
    cls._ordered = (key, value)
    cls._oneofs = {}
    return cls()


def merge_text(text: str, msg: Message) -> Message:
    """Merge protobuf text format into `msg` (`text_format.Merge`: a
    singular field given twice keeps the last value) and return it."""
    _parse_fields(_Tokens(text), msg, None)
    msg._modified()
    return msg
