"""TensorFlow GraphDef export.

Ports bigdl_tpu/utils/tf/saver.py (reference: utils/tf/
TensorflowSaver.scala — walk the module graph, emit one or more TF nodes
per module, write a frozen GraphDef that TensorFlow, or either
package's loader, can read). Weights are already NHWC/HWIO so they
serialize with no transposition; the variables may live on any device.
The GraphDef is written by the port's own codec (utils/protowire.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.interop import linearize
from bigdl_tpu_torch.utils.tf import bigdl_tf_pb2 as pb

__all__ = ["TensorflowSaver", "save"]


def _np(x) -> np.ndarray:
    """A host array of a variable leaf (a tensor on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _set_shape(shape_proto, dims):
    for d in dims:
        shape_proto.dim.add().size = int(d)


class TensorflowSaver:
    """Export (module, variables) → frozen GraphDef .pb."""

    def __init__(self, module: Module, variables: Dict[str, Any],
                 input_shape: Sequence[int], input_name: str = "input"):
        self.module = module
        self.variables = variables
        self.input_shape = tuple(int(d) for d in input_shape)  # NHWC
        self.input_name = input_name
        self._names: Dict[str, int] = {}

    def _fresh(self, base: str) -> str:
        base = base.replace("/", "_")
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    # ---- node emission helpers ----------------------------------------

    def _node(self, gd, op: str, name: str, inputs: Sequence[str],
              dtype: int = pb.DT_FLOAT) -> Any:
        n = gd.node.add()
        n.name = self._fresh(name)
        n.op = op
        n.input.extend(inputs)
        n.attr["T"].type = dtype
        return n

    def _const(self, gd, name: str, arr: np.ndarray) -> str:
        arr = _np(arr)
        if arr.dtype in (np.float64,):
            arr = arr.astype(np.float32)
        n = gd.node.add()
        n.name = self._fresh(name)
        n.op = "Const"
        dt = {np.dtype(np.float32): pb.DT_FLOAT,
              np.dtype(np.int32): pb.DT_INT32,
              np.dtype(np.int64): pb.DT_INT64}[arr.dtype]
        n.attr["dtype"].type = dt
        t = n.attr["value"].tensor
        t.dtype = dt
        _set_shape(t.tensor_shape, arr.shape)
        t.tensor_content = np.ascontiguousarray(arr).tobytes()
        return n.name

    # ---- per-module emitters ------------------------------------------

    def build_graph(self) -> Any:
        gd = pb.GraphDef()
        gd.versions.producer = 27
        ph = gd.node.add()
        ph.name = self._fresh(self.input_name)
        ph.op = "Placeholder"
        ph.attr["dtype"].type = pb.DT_FLOAT
        # batch dim exported as unknown (-1) so any batch size feeds
        _set_shape(ph.attr["shape"].shape, (-1,) + self.input_shape[1:])

        entries, out_ids = linearize(self.module, self.variables)
        ref_of = {-1: ph.name}
        for i, (mod, v, in_ids) in enumerate(entries):
            ins = [ref_of[j] for j in in_ids]
            ref_of[i] = self._emit(gd, mod, v, ins)
        # mark outputs with a stable Identity node
        for k, oid in enumerate(out_ids):
            self._node(gd, "Identity", f"output_{k}" if k else "output",
                       [ref_of[oid]])
        return gd

    def save(self, path: str) -> None:
        gd = self.build_graph()
        with open(path, "wb") as f:
            f.write(gd.SerializeToString())

    def _emit(self, gd, mod: Module, v: Dict[str, Any],
              ins: List[str]) -> str:
        p = v.get("params", {})
        s = v.get("state", {})
        name = mod.name or type(mod).__name__

        if isinstance(mod, nn.SpatialConvolution):
            w = self._const(gd, f"{name}_w", p["weight"])
            same = mod.pad_w == -1
            if not same and (mod.pad_w or mod.pad_h):
                pads = self._const(gd, f"{name}_pads", np.asarray(
                    [[0, 0], [mod.pad_h, mod.pad_h],
                     [mod.pad_w, mod.pad_w], [0, 0]], np.int32))
                pad_n = self._node(gd, "Pad", f"{name}_pad", [ins[0], pads])
                pad_n.attr["Tpaddings"].type = pb.DT_INT32
                src = pad_n.name
            else:
                src = ins[0]
            conv = self._node(gd, "Conv2D", name, [src, w])
            conv.attr["strides"].list.i.extend(
                [1, mod.stride_h, mod.stride_w, 1])
            conv.attr["padding"].s = b"SAME" if same else b"VALID"
            conv.attr["data_format"].s = b"NHWC"
            if isinstance(mod, nn.SpatialDilatedConvolution):
                conv.attr["dilations"].list.i.extend(
                    [1, mod.dilation_h, mod.dilation_w, 1])
            out = conv.name
            if mod.with_bias:
                b = self._const(gd, f"{name}_b", p["bias"])
                out = self._node(gd, "BiasAdd", f"{name}_biasadd",
                                 [out, b]).name
            return out

        if isinstance(mod, nn.Linear):
            w = self._const(gd, f"{name}_w", p["weight"])
            mm = self._node(gd, "MatMul", name, [ins[0], w])
            mm.attr["transpose_a"].b = False
            mm.attr["transpose_b"].b = False
            out = mm.name
            if mod.with_bias:
                b = self._const(gd, f"{name}_b", p["bias"])
                out = self._node(gd, "BiasAdd", f"{name}_biasadd",
                                 [out, b]).name
            return out

        if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
            op = "MaxPool" if isinstance(mod, nn.SpatialMaxPooling) \
                else "AvgPool"
            n = self._node(gd, op, name, [ins[0]])
            n.attr["ksize"].list.i.extend([1, mod.kernel_h, mod.kernel_w, 1])
            n.attr["strides"].list.i.extend(
                [1, mod.stride_h, mod.stride_w, 1])
            n.attr["padding"].s = b"SAME" if mod.pad_w == -1 else b"VALID"
            n.attr["data_format"].s = b"NHWC"
            if mod.pad_w not in (-1, 0) or mod.pad_h not in (-1, 0):
                raise NotImplementedError(
                    "TF export of explicitly-padded pooling")
            return n.name

        if isinstance(mod, (nn.BatchNormalization,
                            nn.SpatialBatchNormalization)):
            scale = p["weight"] if "weight" in p else \
                np.ones(mod.n_output, np.float32)
            offset = p["bias"] if "bias" in p else \
                np.zeros(mod.n_output, np.float32)
            n = self._node(gd, "FusedBatchNorm", name, [
                ins[0],
                self._const(gd, f"{name}_scale", scale),
                self._const(gd, f"{name}_offset", offset),
                self._const(gd, f"{name}_mean",
                            s["running_mean"]),
                self._const(gd, f"{name}_var",
                            s["running_var"]),
            ])
            n.attr["epsilon"].f = mod.eps
            n.attr["is_training"].b = False
            n.attr["data_format"].s = b"NHWC"
            return n.name

        simple = {nn.ReLU: "Relu", nn.ReLU6: "Relu6", nn.Tanh: "Tanh",
                  nn.Sigmoid: "Sigmoid", nn.ELU: "Elu",
                  nn.SoftPlus: "Softplus", nn.SoftSign: "Softsign",
                  nn.SoftMax: "Softmax", nn.LogSoftMax: "LogSoftmax",
                  nn.Abs: "Abs", nn.Exp: "Exp", nn.Log: "Log",
                  nn.Sqrt: "Sqrt", nn.Square: "Square"}
        for cls, op in simple.items():
            if type(mod) is cls:
                return self._node(gd, op, name, [ins[0]]).name
        if isinstance(mod, nn.LeakyReLU):
            n = self._node(gd, "LeakyRelu", name, [ins[0]])
            n.attr["alpha"].f = mod.negval
            return n.name
        if isinstance(mod, (nn.Dropout, nn.Identity)):
            # inference export: dropout is identity (reference does the same)
            return self._node(gd, "Identity", name, [ins[0]]).name

        if isinstance(mod, nn.Reshape):
            dims = list(mod.size)
            if mod.batch_mode is not False:
                dims = [-1] + dims
            shape = self._const(gd, f"{name}_shape",
                                np.asarray(dims, np.int32))
            n = self._node(gd, "Reshape", name, [ins[0], shape])
            n.attr["Tshape"].type = pb.DT_INT32
            return n.name

        if isinstance(mod, nn.JoinTable):
            axis = self._const(gd, f"{name}_axis",
                               np.asarray(mod.dimension - 1, np.int32))
            n = self._node(gd, "ConcatV2", name, list(ins) + [axis])
            n.attr["N"].i = len(ins)
            n.attr["Tidx"].type = pb.DT_INT32
            return n.name
        if isinstance(mod, nn.CAddTable):
            if len(ins) == 2:
                return self._node(gd, "AddV2", name, ins).name
            n = self._node(gd, "AddN", name, ins)
            n.attr["N"].i = len(ins)
            return n.name
        if isinstance(mod, nn.CMulTable):
            return self._node(gd, "Mul", name, ins).name
        if isinstance(mod, nn.CSubTable):
            return self._node(gd, "Sub", name, ins).name
        if isinstance(mod, nn.CMaxTable):
            return self._node(gd, "Maximum", name, ins).name
        if isinstance(mod, nn.CAdd):
            b = self._const(gd, f"{name}_b", p["bias"])
            if len(mod.size) == 1:
                return self._node(gd, "BiasAdd", name, [ins[0], b]).name
            return self._node(gd, "AddV2", name, [ins[0], b]).name

        if isinstance(mod, nn.SpatialCrossMapLRN):
            n = self._node(gd, "LRN", name, [ins[0]])
            n.attr["depth_radius"].i = (mod.size - 1) // 2
            n.attr["alpha"].f = mod.alpha / mod.size
            n.attr["beta"].f = mod.beta
            n.attr["bias"].f = mod.k
            return n.name

        raise NotImplementedError(
            f"TF export of {type(mod).__name__} ({name})")


def save(module: Module, variables: Dict[str, Any], path: str,
         input_shape: Sequence[int], input_name: str = "input") -> None:
    """Convenience: TensorflowSaver(...).save(path)."""
    TensorflowSaver(module, variables, input_shape, input_name).save(path)
