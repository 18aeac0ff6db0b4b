"""Torch7 `.t7` wire format: load/save of tensors, tables and modules.

Ports bigdl_tpu/utils/torch_file.py (reference: utils/TorchFile.scala,
`load` and `save`): a copy of its pure-Python reader and writer, mapped
onto the port's modules. The format (little-endian, as produced by
`torch.save` in Torch7's binary mode):

    object  := int32 type-tag, payload
    NUMBER  := float64
    STRING  := int32 len, bytes
    BOOLEAN := int32 0/1
    TABLE   := int32 heap-index, int32 n, n x (key obj, value obj)
    TORCH   := int32 heap-index, STRING version ("V 1"), STRING class,
               class payload
    tensor payload  := int32 ndim, int64[ndim] size, int64[ndim] stride,
                       int64 storage-offset (1-based), storage object
    storage payload := int64 n, n x element

Heap-indexed objects (tables, torch objects) appear once; later
occurrences serialize as a bare index — the reader memoizes, the writer
assigns sequential indices. Tensors come back as numpy arrays; the
writer takes numpy arrays and torch tensors.

Module mapping (Torch layouts → the port's, which are the JAX
package's, NHWC/HWIO — the transposes of utils/torch_interop.py):
Linear (out,in)→(in,out); SpatialConvolution OIHW→HWIO; batch norm's
running statistics into module state. Lua-Torch classes covered:
Sequential, Linear, SpatialConvolution, SpatialMaxPooling,
SpatialAveragePooling, SpatialBatchNormalization / BatchNormalization,
ReLU, Tanh, Sigmoid, LogSoftMax, SoftMax, Dropout, View, Reshape,
Identity. A loaded module's variables land on `device` (None: the
card).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

T_NIL, T_NUMBER, T_STRING, T_TABLE, T_TORCH, T_BOOLEAN = 0, 1, 2, 3, 4, 5
T_FUNCTION, T_LEGACY_RECUR_FUNCTION, T_RECUR_FUNCTION = 6, 7, 8

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64, "torch.FloatTensor": np.float32,
    "torch.LongTensor": np.int64, "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16, "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
}
_STORAGE_DTYPES = {k.replace("Tensor", "Storage"): v
                   for k, v in _TENSOR_DTYPES.items()}
_NP_TO_TORCH = {np.dtype(np.float32): "Float", np.dtype(np.float64): "Double",
                np.dtype(np.int64): "Long", np.dtype(np.int32): "Int",
                np.dtype(np.int16): "Short", np.dtype(np.uint8): "Byte",
                np.dtype(np.int8): "Char"}


class TorchObject:
    """A non-tensor `torch.class` instance: class name + field table."""

    def __init__(self, torch_class: str, fields: Dict):
        self.torch_class = torch_class
        self.fields = fields

    def __repr__(self):
        return f"TorchObject({self.torch_class})"


# ------------------------------------------------------------------ reader

class _Reader:
    def __init__(self, f):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _unpack(self, fmt, size):
        raw = self.f.read(size)
        if len(raw) != size:
            raise ValueError("truncated .t7 stream")
        return struct.unpack(fmt, raw)[0]

    def read_int(self) -> int:
        return self._unpack("<i", 4)

    def read_long(self) -> int:
        return self._unpack("<q", 8)

    def read_double(self) -> float:
        return self._unpack("<d", 8)

    def read_string(self) -> str:
        n = self.read_int()
        raw = self.f.read(n)
        # Lua strings are byte strings: binary payloads are legal.
        # surrogateescape maps undecodable bytes to lone surrogates
        # that write_string encodes back to the exact original bytes —
        # load/save round-trips are lossless and valid UTF-8 is
        # unaffected (the writer mirrors this; see write_string).
        return raw.decode("utf-8", errors="surrogateescape")

    def read_object(self) -> Any:
        tag = self.read_int()
        if tag == T_NIL:
            return None
        if tag == T_NUMBER:
            v = self.read_double()
            return int(v) if v.is_integer() else v
        if tag == T_STRING:
            return self.read_string()
        if tag == T_BOOLEAN:
            return bool(self.read_int())
        if tag == T_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            table: Dict = {}
            self.memo[idx] = table
            n = self.read_int()
            for _ in range(n):
                k = self.read_object()
                table[k] = self.read_object()
            return table
        if tag == T_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            version = self.read_string()
            cls = self.read_string() if version.startswith("V ") else version
            if cls in _TENSOR_DTYPES:
                out = self._read_tensor(np.dtype(_TENSOR_DTYPES[cls]))
            elif cls in _STORAGE_DTYPES:
                out = self._read_storage(np.dtype(_STORAGE_DTYPES[cls]))
            else:
                # generic torch.class: payload is its field table
                placeholder = TorchObject(cls, {})
                self.memo[idx] = placeholder
                payload = self.read_object()
                placeholder.fields = payload if isinstance(payload, dict) \
                    else {"value": payload}
                return placeholder
            self.memo[idx] = out
            return out
        if tag in (T_FUNCTION, T_RECUR_FUNCTION, T_LEGACY_RECUR_FUNCTION):
            raise ValueError("function objects in .t7 are not supported")
        raise ValueError(f"unknown .t7 type tag {tag}")

    def _read_storage(self, dtype) -> np.ndarray:
        n = self.read_long()
        raw = self.f.read(n * dtype.itemsize)
        if len(raw) != n * dtype.itemsize:
            raise ValueError("truncated .t7 stream in storage data")
        return np.frombuffer(raw, dtype=dtype).copy()

    def _read_tensor(self, dtype) -> np.ndarray:
        ndim = self.read_int()
        sizes = [self.read_long() for _ in range(ndim)]
        strides = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1
        storage = self.read_object()
        if ndim == 0 or storage is None or any(s == 0 for s in sizes):
            return np.zeros(sizes, dtype)
        # bounds-check before as_strided: a malformed file must raise,
        # not read out-of-bounds memory
        last = offset + sum((sz - 1) * st for sz, st in zip(sizes, strides))
        if offset < 0 or min(strides) < 0 or last >= storage.shape[0]:
            raise ValueError(
                f".t7 tensor (shape {sizes}, strides {strides}, offset "
                f"{offset}) exceeds its storage of {storage.shape[0]} "
                "elements")
        view = np.lib.stride_tricks.as_strided(
            storage[offset:], shape=sizes,
            strides=[s * dtype.itemsize for s in strides])
        return np.ascontiguousarray(view)


# ------------------------------------------------------------------ writer

class _Writer:
    def __init__(self, f):
        self.f = f
        self.memo: Dict[int, int] = {}  # id(obj) -> heap index
        self.next_idx = 1

    def write_int(self, v: int):
        self.f.write(struct.pack("<i", v))

    def write_long(self, v: int):
        self.f.write(struct.pack("<q", v))

    def write_double(self, v: float):
        self.f.write(struct.pack("<d", v))

    def write_string(self, s):
        # bytes pass through; str encodes utf-8 with surrogateescape so
        # strings produced by read_string's binary fallback restore
        # their exact original bytes (see read_string)
        raw = s if isinstance(s, bytes) else s.encode(
            "utf-8", errors="surrogateescape")
        self.write_int(len(raw))
        self.f.write(raw)

    def _heap(self, obj) -> Optional[int]:
        """Existing heap index (meaning: write a bare reference), or
        None after registering the object."""
        if id(obj) in self.memo:
            return self.memo[id(obj)]
        self.memo[id(obj)] = self.next_idx
        self.next_idx += 1
        return None

    def write_object(self, obj: Any):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        if obj is None:
            self.write_int(T_NIL)
        elif isinstance(obj, bool):
            self.write_int(T_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(T_NUMBER)
            self.write_double(float(obj))
        elif isinstance(obj, (str, bytes)):
            self.write_int(T_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            if obj.ndim == 0:
                # Torch7 has no 0-d tensors (ndim=0 means empty); a
                # scalar's natural wire form is a Lua number
                self.write_int(T_NUMBER)
                self.write_double(float(obj))
            else:
                self._write_tensor(obj)
        elif isinstance(obj, (list, tuple)):
            self.write_object({i + 1: v for i, v in enumerate(obj)})
        elif isinstance(obj, dict):
            self.write_int(T_TABLE)
            ref = self._heap(obj)
            if ref is not None:
                self.write_int(ref)
                return
            self.write_int(self.memo[id(obj)])
            self.write_int(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, TorchObject):
            self.write_int(T_TORCH)
            ref = self._heap(obj)
            if ref is not None:
                self.write_int(ref)
                return
            self.write_int(self.memo[id(obj)])
            self.write_string("V 1")
            self.write_string(obj.torch_class)
            self.write_object(obj.fields)
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__} to .t7")

    def _write_tensor(self, obj: np.ndarray):
        kind = _NP_TO_TORCH.get(obj.dtype)
        if kind is None:
            raise TypeError(f"no torch tensor type for dtype {obj.dtype}")
        self.write_int(T_TORCH)
        ref = self._heap(obj)
        if ref is not None:
            self.write_int(ref)
            return
        arr = np.ascontiguousarray(obj)
        self.write_int(self.memo[id(obj)])
        self.write_string("V 1")
        self.write_string(f"torch.{kind}Tensor")
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        # contiguous element strides
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self.write_long(s)
        self.write_long(1)  # storage offset, 1-based
        self.write_int(T_TORCH)
        self.write_int(self.next_idx)
        self.next_idx += 1
        self.write_string("V 1")
        self.write_string(f"torch.{kind}Storage")
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


# ----------------------------------------------------- torch-nn -> modules

def _lua_list(table: Dict) -> List:
    """A Lua array-style table ({1: a, 2: b, ...}) as a Python list."""
    out = []
    i = 1
    while i in table:
        out.append(table[i])
        i += 1
    return out


def _to_module(obj: TorchObject, dev: torch.device):
    """Map a Lua-Torch nn object onto (module, variables) on `dev`."""
    from bigdl_tpu_torch import nn

    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(np.asarray(
            a, np.float32))).to(dev)

    cls = obj.torch_class.split(".")[-1]
    f = obj.fields

    if cls == "Sequential":
        children = [_to_module(m, dev)
                    for m in _lua_list(f.get("modules", {}))]
        seq = nn.Sequential(*[m for m, _ in children])
        variables = {"params": {}, "state": {}}
        for (child, cv), key in zip(children, seq._keys):
            variables["params"][key] = cv["params"]
            variables["state"][key] = cv["state"]
        return seq, variables
    if cls == "Linear":
        w = np.asarray(f["weight"], np.float32)             # (out, in)
        m = nn.Linear(w.shape[1], w.shape[0], with_bias="bias" in f)
        p = {"weight": f32(w.T)}
        if "bias" in f:
            p["bias"] = f32(np.ravel(f["bias"]))
        return m, {"params": p, "state": {}}
    if cls == "SpatialConvolution":
        n_in, n_out = int(f["nInputPlane"]), int(f["nOutputPlane"])
        kw, kh = int(f["kW"]), int(f["kH"])
        w = np.asarray(f["weight"], np.float32).reshape(n_out, n_in, kh, kw)
        m = nn.SpatialConvolution(
            n_in, n_out, kernel_w=kw, kernel_h=kh,
            stride_w=int(f.get("dW", 1)), stride_h=int(f.get("dH", 1)),
            pad_w=int(f.get("padW", 0)), pad_h=int(f.get("padH", 0)),
            with_bias="bias" in f)
        p = {"weight": f32(w.transpose(2, 3, 1, 0))}       # OIHW -> HWIO
        if "bias" in f:
            p["bias"] = f32(np.ravel(f["bias"]))
        return m, {"params": p, "state": {}}
    if cls in ("SpatialBatchNormalization", "BatchNormalization"):
        mean, var = f32(f["running_mean"]), f32(f["running_var"])
        affine = "weight" in f
        ctor = (nn.SpatialBatchNormalization
                if cls == "SpatialBatchNormalization"
                else nn.BatchNormalization)
        m = ctor(mean.shape[0], eps=float(f.get("eps", 1e-5)),
                 momentum=float(f.get("momentum", 0.1)), affine=affine)
        p = {"weight": f32(f["weight"]), "bias": f32(f["bias"])} \
            if affine else {}
        return m, {"params": p,
                   "state": {"running_mean": mean, "running_var": var}}
    if cls in ("SpatialMaxPooling", "SpatialAveragePooling"):
        ctor = nn.SpatialMaxPooling if cls == "SpatialMaxPooling" \
            else nn.SpatialAveragePooling
        m = ctor(int(f["kW"]), int(f["kH"]), int(f.get("dW", f["kW"])),
                 int(f.get("dH", f["kH"])), int(f.get("padW", 0)),
                 int(f.get("padH", 0)))
        return m, {"params": {}, "state": {}}
    if cls == "Dropout":
        return nn.Dropout(float(f.get("p", 0.5))), {"params": {}, "state": {}}
    if cls in ("View", "Reshape"):
        size = f.get("size")
        dims = [int(d) for d in np.ravel(_lua_list(size)
                                         if isinstance(size, dict) else size)]
        return nn.Reshape(dims), {"params": {}, "state": {}}
    simple = {"ReLU": nn.ReLU, "Tanh": nn.Tanh, "Sigmoid": nn.Sigmoid,
              "LogSoftMax": nn.LogSoftMax, "SoftMax": nn.SoftMax,
              "Identity": nn.Identity}
    if cls in simple:
        return simple[cls](), {"params": {}, "state": {}}
    raise ValueError(f"unsupported Lua-Torch class in .t7: {obj.torch_class}")


# ----------------------------------------------------- modules -> torch-nn

def _host(t) -> np.ndarray:
    """A variable leaf as a host numpy array (a copy off its device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def _from_module(module, variables) -> TorchObject:
    p = variables.get("params", {})
    s = variables.get("state", {})
    t = type(module).__name__

    if t == "Sequential":
        mods = []
        for key, child in zip(module._keys, module.modules_):
            mods.append(_from_module(
                child, {"params": p.get(key, {}), "state": s.get(key, {})}))
        return TorchObject("nn.Sequential",
                           {"modules": {i + 1: m for i, m in enumerate(mods)},
                            "train": False})
    if t == "Linear":
        w = _host(p["weight"]).T.copy()            # (in,out) -> (out,in)
        fields = {"weight": w, "gradWeight": np.zeros_like(w)}
        if "bias" in p:
            b = _host(p["bias"])
            fields.update(bias=b, gradBias=np.zeros_like(b))
        return TorchObject("nn.Linear", fields)
    if t == "SpatialConvolution":
        if isinstance(module.pad_w, (tuple, list)) or \
                isinstance(module.pad_h, (tuple, list)):
            raise ValueError(
                "Torch7 SpatialConvolution has no asymmetric padding; "
                f"cannot export pad_w={module.pad_w}, "
                f"pad_h={module.pad_h} to .t7")
        w = _host(p["weight"]).transpose(3, 2, 0, 1).copy()  # HWIO->OIHW
        fields = {
            "nInputPlane": module.n_input_plane,
            "nOutputPlane": module.n_output_plane,
            "kW": module.kernel_w, "kH": module.kernel_h,
            "dW": module.stride_w, "dH": module.stride_h,
            "padW": module.pad_w, "padH": module.pad_h,
            "weight": w, "gradWeight": np.zeros_like(w),
        }
        if "bias" in p:
            b = _host(p["bias"])
            fields.update(bias=b, gradBias=np.zeros_like(b))
        return TorchObject("nn.SpatialConvolution", fields)
    if t in ("SpatialBatchNormalization", "BatchNormalization"):
        fields = {
            "running_mean": _host(s["running_mean"]),
            "running_var": _host(s["running_var"]),
            "eps": module.eps, "momentum": module.momentum,
            "affine": bool(p),
        }
        if p:
            fields.update(weight=_host(p["weight"]),
                          bias=_host(p["bias"]))
        return TorchObject(f"nn.{t}", fields)
    if t in ("SpatialMaxPooling", "SpatialAveragePooling"):
        return TorchObject(f"nn.{t}", {
            "kW": module.kernel_w, "kH": module.kernel_h,
            "dW": module.stride_w, "dH": module.stride_h,
            "padW": module.pad_w, "padH": module.pad_h})
    if t == "Dropout":
        return TorchObject("nn.Dropout", {"p": module.p})
    if t == "Reshape":
        return TorchObject("nn.Reshape",
                           {"size": [int(d) for d in module.size]})
    simple = {"ReLU": "nn.ReLU", "Tanh": "nn.Tanh", "Sigmoid": "nn.Sigmoid",
              "LogSoftMax": "nn.LogSoftMax", "SoftMax": "nn.SoftMax",
              "Identity": "nn.Identity"}
    if t in simple:
        return TorchObject(simple[t], {})
    raise ValueError(f"cannot export module {t} to .t7")


# ----------------------------------------------------------------- surface

def load_t7(path: str, to_module: bool = True, device: DeviceLike = None):
    """Load a `.t7` file (reference: utils/TorchFile.scala#load).

    Tensors come back as numpy arrays, Lua tables as dicts. A Lua-Torch
    nn object (with `to_module=True`, the default) is mapped onto the
    port's modules: returns `(module, variables)`, the variables on
    `device` (None: the card).
    """
    with open(path, "rb") as f:
        obj = _Reader(f).read_object()
    if to_module and isinstance(obj, TorchObject) \
            and obj.torch_class.startswith("nn."):
        return _to_module(obj, resolve_device(device))
    return obj


def save_t7(path: str, obj: Any, variables: Optional[Dict] = None):
    """Save to `.t7` (reference: utils/TorchFile.scala#save): numpy
    arrays and torch tensors as torch tensors, dicts/lists as tables,
    and a Module (+ its `variables`, defaulting to the built ones) as
    the matching Lua-Torch nn object tree."""
    from bigdl_tpu_torch.nn.module import Module

    if isinstance(obj, Module):
        if variables is None:
            variables = obj.variables
        obj = _from_module(obj, variables)
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)
