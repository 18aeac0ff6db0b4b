"""TensorFlow frozen-graph interop: load a GraphDef into a port Graph,
per-op converters, numpy const evaluation.

Ports bigdl_tpu/utils/tf/loader.py (reference: utils/tf/
TensorflowLoader.scala — frozen GraphDef → module graph via per-op
converters under utils/tf/loaders/; TensorflowSaver.scala's mirror is
saver.py). The reference also ships a mini TF training session
(utils/tf/BigDLSessionImpl.scala); here importing a frozen graph yields
a native trainable model directly — every converted layer's parameters
are ordinary tensors of the variable tree, so `Optimizer` fine-tunes
them like any other model.

TF frozen graphs are already NHWC/HWIO — the port's layouts — so
conv/linear weights load with no transposition. The GraphDef is parsed
by the port's own codec (utils/protowire.py, schema in
bigdl_tf_pb2.py); neither TensorFlow nor `google.protobuf` is imported.
The graph's keys are the JAX loader's. Variables land on `device`
(None: the card).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device
from bigdl_tpu_torch.utils.interop import graph_variables
from bigdl_tpu_torch.utils.tf import bigdl_tf_pb2 as pb

__all__ = ["TensorflowLoader", "load"]

_NP_DTYPES = {
    pb.DT_FLOAT: np.float32,
    pb.DT_DOUBLE: np.float64,
    pb.DT_INT32: np.int32,
    pb.DT_INT64: np.int64,
    pb.DT_BOOL: np.bool_,
    pb.DT_UINT8: np.uint8,
    pb.DT_INT8: np.int8,
    pb.DT_INT16: np.int16,
    pb.DT_BFLOAT16: np.float32,  # widened on read
}

_VAL_FIELDS = {
    pb.DT_FLOAT: "float_val",
    pb.DT_DOUBLE: "double_val",
    pb.DT_INT32: "int_val",
    pb.DT_INT64: "int64_val",
    pb.DT_BOOL: "bool_val",
}

_PASSTHROUGH_OPS = {"Identity", "StopGradient", "CheckNumerics",
                    "PreventGradient", "Snapshot"}

_ACTIVATIONS = {
    "Relu": nn.ReLU, "Relu6": nn.ReLU6, "Tanh": nn.Tanh,
    "Sigmoid": nn.Sigmoid, "Elu": nn.ELU, "Softplus": nn.SoftPlus,
    "Softsign": nn.SoftSign, "Softmax": nn.SoftMax,
    "LogSoftmax": nn.LogSoftMax, "Abs": nn.Abs, "Exp": nn.Exp,
    "Log": nn.Log, "Sqrt": nn.Sqrt, "Square": nn.Square,
}

_BINARY_OPS = {
    "Add": nn.CAddTable, "AddV2": nn.CAddTable, "Sub": nn.CSubTable,
    "Mul": nn.CMulTable, "RealDiv": nn.CDivTable,
    "Maximum": nn.CMaxTable, "Minimum": nn.CMinTable,
}

# constant folding: frozen keras graphs decompose BatchNorm into
# rsqrt(var+eps)*gamma / beta-mean*... chains whose inner nodes are
# pure-const arithmetic — fold them at load so only the data-path
# Mul/Add (affine scale/bias, below) needs a module
_FOLDABLE = {
    "Add": np.add, "AddV2": np.add, "Sub": np.subtract,
    "Mul": np.multiply, "RealDiv": np.divide,
    "Maximum": np.maximum, "Minimum": np.minimum,
    "Rsqrt": lambda a: 1.0 / np.sqrt(a), "Sqrt": np.sqrt,
    "Square": np.square, "Neg": np.negative, "Exp": np.exp,
    "Log": np.log, "Abs": np.abs,
    "Reshape": lambda a, s: np.reshape(a, [int(x) for x in s]),
}


def _tensor_to_np(t) -> np.ndarray:
    dtype = _NP_DTYPES.get(t.dtype)
    if dtype is None:
        raise NotImplementedError(f"TF dtype {t.dtype}")
    shape = tuple(int(d.size) for d in t.tensor_shape.dim)
    if t.tensor_content:
        if t.dtype == pb.DT_BFLOAT16:
            raw = np.frombuffer(t.tensor_content, np.uint16).astype(np.uint32)
            return (raw << 16).view(np.float32).reshape(shape).copy()
        return np.frombuffer(t.tensor_content, dtype).reshape(shape).copy()
    field = _VAL_FIELDS.get(t.dtype)
    if field is None:
        raise NotImplementedError(f"TF dtype {t.dtype} without content")
    vals = np.asarray(getattr(t, field), dtype)
    if vals.size == 0:
        return np.zeros(shape, dtype)
    n = int(np.prod(shape)) if shape else 1
    if vals.size == 1 and n > 1:  # splat encoding
        vals = np.full(n, vals[0], dtype)
    return vals.reshape(shape)


def _require_nhwc(tf_node) -> None:
    """Converters assume NHWC (the framework's native layout). NCHW
    frozen graphs (GPU-trained) would import with silently wrong
    results — refuse instead."""
    fmt = tf_node.attr["data_format"].s if "data_format" in tf_node.attr \
        else b""
    if fmt not in (b"", b"NHWC"):
        raise NotImplementedError(
            f"{tf_node.name}: data_format={fmt.decode()!r} — only NHWC "
            "frozen graphs are supported (transpose the graph to NHWC "
            "before freezing)")


def _norm(ref: str) -> Optional[str]:
    """'name:0' → 'name'; '^name' (control dep) → None."""
    if ref.startswith("^"):
        return None
    return ref.split(":")[0]


class TensorflowLoader:
    """Load a frozen TF GraphDef (.pb) → (Graph, variables).

    `inputs`/`outputs` name the boundary nodes, as in the reference's
    TensorflowLoader.load(graphFile, inputs, outputs); both default to
    being inferred (Placeholders / unconsumed nodes).
    """

    def __init__(self, graph_path: str,
                 inputs: Optional[Sequence[str]] = None,
                 outputs: Optional[Sequence[str]] = None,
                 device: DeviceLike = None):
        self.graph_path = graph_path
        self.inputs = list(inputs) if inputs else None
        self.outputs = list(outputs) if outputs else None
        self.device = device

    # ---- graph assembly -----------------------------------------------

    def load(self) -> Tuple[Graph, Dict[str, Any]]:
        dev = resolve_device(self.device)
        graph_def = pb.GraphDef()
        with open(self.graph_path, "rb") as f:
            graph_def.ParseFromString(f.read())

        nodes = {n.name: n for n in graph_def.node}
        consts: Dict[str, np.ndarray] = {}
        mod_node: Dict[str, Node] = {}
        node_vars: Dict[int, Dict[str, Any]] = {}
        input_nodes: List[Node] = []
        input_names = []

        def const_of(name: str) -> Optional[np.ndarray]:
            """Resolve `name` to a numpy constant, through passthrough ops."""
            if name in consts:
                return consts[name]
            n = nodes.get(name)
            while n is not None and n.op in _PASSTHROUGH_OPS:
                nxt = _norm(n.input[0])
                if nxt in consts:
                    return consts[nxt]
                n = nodes.get(nxt)
            return None

        def wire(module: Module, parents: List[Node], name: str,
                 variables: Optional[Dict[str, Any]] = None) -> Node:
            module.set_name(name.replace("/", "_"))
            node = Node.wire(module, parents)
            if variables is not None:
                node_vars[id(node)] = variables
            return node

        order = self._topo_order(nodes)
        for tf_node in order:
            name, op = tf_node.name, tf_node.op
            ins = [i for i in (_norm(r) for r in tf_node.input)
                   if i is not None]
            if op == "Const":
                consts[name] = _tensor_to_np(tf_node.attr["value"].tensor)
                continue
            if op in ("NoOp",):
                continue
            if op == "Placeholder" or op == "PlaceholderV2":
                if self.inputs is not None and name not in self.inputs:
                    continue
                node = Input()
                mod_node[name] = node
                input_nodes.append(node)
                input_names.append(name)
                continue
            if op in _PASSTHROUGH_OPS:
                if ins and ins[0] in mod_node:
                    mod_node[name] = mod_node[ins[0]]
                continue
            if op in _FOLDABLE and ins and not any(i in mod_node
                                                   for i in ins):
                vals = [const_of(i) for i in ins]
                if all(v is not None for v in vals):
                    consts[name] = np.asarray(_FOLDABLE[op](*vals))
                    continue
            if op == "Squeeze" and ins and ins[0] not in mod_node:
                val = const_of(ins[0])
                if val is not None:
                    dims = tuple(int(d) for d in
                                 tf_node.attr["squeeze_dims"].list.i)
                    consts[name] = np.squeeze(val, dims or None)
                    continue
            handled = self._convert(tf_node, op, ins, consts, const_of,
                                    mod_node, wire)
            if handled is not None:
                mod_node[name] = handled

        outputs = self.outputs
        if outputs is None:
            consumed = set()
            for n in graph_def.node:
                consumed.update(i for i in (_norm(r) for r in n.input) if i)
            outputs = [n.name for n in graph_def.node
                       if n.name not in consumed and n.name in mod_node
                       and mod_node[n.name] not in input_nodes]
        out_nodes, seen = [], set()
        for o in outputs:
            node = mod_node.get(_norm(o))
            if node is None:
                raise ValueError(f"output {o!r} not found/convertible")
            if id(node) not in seen:
                seen.add(id(node))
                out_nodes.append(node)
        if not out_nodes:
            raise ValueError("TF graph has no convertible output nodes")

        if self.inputs is not None:
            order_map = {n: i for i, n in enumerate(self.inputs)}
            pairs = sorted(zip(input_names, input_nodes),
                           key=lambda p: order_map.get(p[0], 1 << 30))
            input_nodes = [p[1] for p in pairs]

        graph = Graph(input_nodes, out_nodes)
        return graph, graph_variables(graph, node_vars, dev)

    @staticmethod
    def _topo_order(nodes: Dict[str, Any]) -> List[Any]:
        seen: Dict[str, int] = {}
        out: List[Any] = []

        def visit(name: str):
            state = seen.get(name)
            if state == 2:
                return
            if state == 1:
                raise ValueError(f"cycle at TF node {name!r}")
            seen[name] = 1
            n = nodes.get(name)
            if n is not None:
                for r in n.input:
                    nr = _norm(r)
                    if nr is not None and nr in nodes:
                        visit(nr)
                out.append(n)
            seen[name] = 2

        for name in nodes:
            visit(name)
        return out

    # ---- per-op converters --------------------------------------------

    def _convert(self, tf_node, op, ins, consts, const_of, mod_node, wire
                 ) -> Optional[Node]:
        attr = tf_node.attr
        name = tf_node.name

        def parent(i=0) -> Node:
            p = mod_node.get(ins[i])
            if p is None:
                raise NotImplementedError(
                    f"node {name!r} ({op}): input {ins[i]!r} is not a "
                    f"converted module (unsupported producer)")
            return p

        if op in _ACTIVATIONS:
            return wire(_ACTIVATIONS[op](), [parent()], name)
        if op == "LeakyRelu":
            alpha = attr["alpha"].f if "alpha" in attr else 0.2
            return wire(nn.LeakyReLU(alpha), [parent()], name)
        if op == "Neg":
            return wire(nn.Power(1.0, -1.0, 0.0), [parent()], name)
        if op == "Rsqrt":
            return wire(nn.Power(-0.5, 1.0, 0.0), [parent()], name)

        if op == "Conv2D":
            return self._conv2d(tf_node, ins, const_of, parent, wire)
        if op == "DepthwiseConv2dNative":
            return self._depthwise(tf_node, ins, const_of, parent, wire)
        if op == "MatMul":
            w = const_of(ins[1])
            if w is None:
                x, y = parent(0), parent(1)
                return wire(nn.MM(trans_a=attr["transpose_a"].b,
                                  trans_b=attr["transpose_b"].b),
                            [x, y], name)
            if attr["transpose_a"].b:
                raise NotImplementedError(
                    f"{name}: MatMul with transpose_a on the const-weight "
                    "path is not supported (would silently transpose the "
                    "activations)")
            if attr["transpose_b"].b:
                w = w.T
            lin = nn.Linear(w.shape[0], w.shape[1], with_bias=False)
            return wire(lin, [parent()], name,
                        {"params": {"weight": w.astype(np.float32)},
                         "state": {}})
        if op == "BiasAdd":
            _require_nhwc(tf_node)
            b = const_of(ins[1])
            if b is None:
                return wire(nn.CAddTable(), [parent(0), parent(1)], name)
            cadd = nn.CAdd(tuple(b.shape))
            return wire(cadd, [parent()], name,
                        {"params": {"bias": b.astype(np.float32)},
                         "state": {}})
        if op in _BINARY_OPS:
            rhs = const_of(ins[1]) if len(ins) > 1 else None
            lhs = const_of(ins[0])
            if rhs is not None and rhs.size == 1:
                c = float(rhs.reshape(()))
                scale, shift = {"Mul": (c, 0.0), "RealDiv": (1.0 / c, 0.0),
                                "Add": (1.0, c), "AddV2": (1.0, c),
                                "Sub": (1.0, -c)}.get(op, (None, None))
                if scale is not None:
                    return wire(nn.Power(1.0, scale, shift), [parent(0)],
                                name)
            if lhs is not None and lhs.size == 1 and op in ("Add", "AddV2",
                                                            "Mul"):
                c = float(lhs.reshape(()))
                scale, shift = (c, 0.0) if op == "Mul" else (1.0, c)
                return wire(nn.Power(1.0, scale, shift), [parent(1)], name)
            # data (×|+) const VECTOR — the data-path half of a frozen
            # decomposed BatchNorm: an affine CMul/CAdd with the folded
            # constant as its (trainable, fine-tunable) weight
            cv, pi = (rhs, 0) if rhs is not None else (lhs, 1)
            if cv is not None and (pi == 0 or op in ("Add", "AddV2",
                                                     "Mul")):
                w = cv.astype(np.float32)
                if op == "Mul":
                    return wire(nn.CMul(w.shape), [parent(pi)], name,
                                {"params": {"weight": w}, "state": {}})
                if op == "RealDiv":
                    return wire(nn.CMul(w.shape), [parent(pi)], name,
                                {"params": {"weight": 1.0 / w},
                                 "state": {}})
                if op in ("Add", "AddV2"):
                    return wire(nn.CAdd(w.shape), [parent(pi)], name,
                                {"params": {"bias": w}, "state": {}})
                if op == "Sub":  # data - const
                    return wire(nn.CAdd(w.shape), [parent(pi)], name,
                                {"params": {"bias": -w}, "state": {}})
            return wire(_BINARY_OPS[op](), [parent(0), parent(1)], name)

        if op in ("MaxPool", "AvgPool"):
            _require_nhwc(tf_node)
            ks = [int(i) for i in attr["ksize"].list.i]
            st = [int(i) for i in attr["strides"].list.i]
            same = attr["padding"].s == b"SAME"
            pad = -1 if same else 0
            if op == "MaxPool":
                m = nn.SpatialMaxPooling(ks[2], ks[1], st[2], st[1],
                                         pad_w=pad, pad_h=pad)
            else:
                # TF AvgPool never counts padded cells
                m = nn.SpatialAveragePooling(ks[2], ks[1], st[2], st[1],
                                             pad_w=pad, pad_h=pad,
                                             count_include_pad=False)
            return wire(m, [parent()], name)

        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            _require_nhwc(tf_node)
            scale = const_of(ins[1])
            offset = const_of(ins[2])
            mean = const_of(ins[3])
            var = const_of(ins[4])
            if any(a is None for a in (scale, offset, mean, var)):
                raise NotImplementedError(
                    f"{name}: FusedBatchNorm with non-const params "
                    "(training-mode graph?) — freeze the graph first")
            eps = attr["epsilon"].f if "epsilon" in attr else 1e-3
            bn = nn.SpatialBatchNormalization(int(scale.shape[0]), eps=eps)
            v = {"params": {"weight": scale.astype(np.float32),
                            "bias": offset.astype(np.float32)},
                 "state": {"running_mean": mean.astype(np.float32),
                           "running_var": var.astype(np.float32)}}
            return wire(bn, [parent()], name, v)

        if op == "Reshape":
            shape = const_of(ins[1])
            if shape is None:
                shape = self._flatten_shape_idiom(ins[1])
            if shape is None:
                raise NotImplementedError(
                    f"{name}: Reshape with dynamic shape")
            dims = [int(d) for d in np.asarray(shape).ravel()]
            if len(dims) >= 1 and (dims[0] == -1 or dims[0] > 0):
                # leading dim is the batch in frozen inference graphs
                return wire(nn.Reshape(dims[1:] if len(dims) > 1 else [-1],
                                       batch_mode=True), [parent()], name)
            return wire(nn.Reshape(dims, batch_mode=False), [parent()],
                        name)
        if op == "Squeeze":
            dims = [int(i) for i in attr["squeeze_dims"].list.i]
            if not dims:
                m = nn.Squeeze()
            elif len(dims) == 1:
                m = nn.Squeeze(dims[0] + 1)
            else:
                m = nn.Sequential()
                for d in sorted(dims, reverse=True):  # descending: safe
                    m.add(nn.Squeeze(d + 1))
            return wire(m, [parent()], name)
        if op == "ExpandDims":
            ax = const_of(ins[1])
            if ax is None:
                raise NotImplementedError(f"{name}: dynamic ExpandDims")
            return wire(nn.Unsqueeze(int(ax) + 1), [parent()], name)

        if op in ("ConcatV2", "Concat"):
            if op == "ConcatV2":
                axis = const_of(ins[-1])
                data_ins = ins[:-1]
            else:  # legacy: axis first
                axis = const_of(ins[0])
                data_ins = ins[1:]
            if axis is None:
                raise NotImplementedError(f"{name}: dynamic concat axis")
            parents = [mod_node[i] for i in data_ins]
            return wire(nn.JoinTable(dimension=int(axis) + 1),
                        parents, name)

        if op == "Mean":
            axes = const_of(ins[1])
            if axes is None:
                raise NotImplementedError(f"{name}: dynamic Mean axes")
            keep = attr["keep_dims"].b if "keep_dims" in attr else False
            axes = sorted(int(a) for a in np.asarray(axes).ravel())
            seq = nn.Sequential()
            for a in reversed(axes):  # descending: safe when squeezing
                seq.add(nn.Mean(dimension=a + 1, squeeze=not keep))
            return wire(seq, [parent()], name)

        if op == "Pad":
            pads = const_of(ins[1])
            if pads is None:
                raise NotImplementedError(f"{name}: dynamic Pad")
            pads = np.asarray(pads)
            if pads.shape[0] == 4 and not pads[0].any() and not \
                    pads[3].any():
                (t, b), (l, r) = pads[1], pads[2]
                return wire(nn.SpatialZeroPadding(int(l), int(r), int(t),
                                                  int(b)), [parent()], name)
            raise NotImplementedError(f"{name}: non-spatial Pad")

        if op == "LRN":
            r = int(attr["depth_radius"].i) if "depth_radius" in attr else 5
            alpha = attr["alpha"].f if "alpha" in attr else 1.0
            beta = attr["beta"].f if "beta" in attr else 0.5
            bias = attr["bias"].f if "bias" in attr else 1.0
            size = 2 * r + 1
            # TF alpha is per-element; ours (like caffe/torch) is summed
            return wire(nn.SpatialCrossMapLRN(size, alpha * size, beta,
                                              bias), [parent()], name)

        if op in ("Pack", "Shape", "StridedSlice", "Fill"):
            return None  # shape-arithmetic scaffolding; consumed elsewhere

        raise NotImplementedError(f"TF op {op!r} (node {name!r})")

    def _conv2d(self, tf_node, ins, const_of, parent, wire):
        attr = tf_node.attr
        _require_nhwc(tf_node)
        w = const_of(ins[1])  # HWIO — native layout, no transpose
        if w is None:
            raise NotImplementedError(f"{tf_node.name}: non-const filter")
        st = [int(i) for i in attr["strides"].list.i]
        same = attr["padding"].s == b"SAME"
        dil = [int(i) for i in attr["dilations"].list.i] or [1, 1, 1, 1]
        kh, kw, n_in, n_out = w.shape
        pad = -1 if same else 0
        if dil[1] == 1 and dil[2] == 1:
            m = nn.SpatialConvolution(n_in, n_out, kw, kh, st[2], st[1],
                                      pad, pad, with_bias=False)
        else:
            m = nn.SpatialDilatedConvolution(
                n_in, n_out, kw, kh, st[2], st[1], pad, pad,
                dilation_w=dil[2], dilation_h=dil[1], with_bias=False)
        return wire(m, [parent()], tf_node.name,
                    {"params": {"weight": w.astype(np.float32)},
                     "state": {}})

    def _depthwise(self, tf_node, ins, const_of, parent, wire):
        attr = tf_node.attr
        _require_nhwc(tf_node)
        w = const_of(ins[1])  # (H, W, C, mult)
        if w is None:
            raise NotImplementedError(f"{tf_node.name}: non-const filter")
        st = [int(i) for i in attr["strides"].list.i]
        same = attr["padding"].s == b"SAME"
        kh, kw, c, mult = w.shape
        pad = -1 if same else 0
        m = nn.SpatialConvolution(c, c * mult, kw, kh, st[2], st[1],
                                  pad, pad, n_group=c, with_bias=False)
        # grouped-conv weight (H, W, I/g=1, O=C*mult): channel c's
        # multipliers occupy O slots [c*mult, (c+1)*mult) — exactly the
        # C-major flatten of TF's trailing (C, mult) dims
        wg = np.ascontiguousarray(w.reshape(kh, kw, 1, c * mult))
        return wire(m, [parent()], tf_node.name,
                    {"params": {"weight": wg.astype(np.float32)},
                     "state": {}})

    def _flatten_shape_idiom(self, shape_ref: str) -> Optional[list]:
        # The Shape→StridedSlice→Pack flatten idiom needs runtime shapes;
        # frozen inference graphs almost always have const shapes instead.
        return None


def load(graph_path: str, inputs: Optional[Sequence[str]] = None,
         outputs: Optional[Sequence[str]] = None, device: DeviceLike = None
         ) -> Tuple[Graph, Dict[str, Any]]:
    """Convenience: TensorflowLoader(...).load()."""
    return TensorflowLoader(graph_path, inputs, outputs, device).load()
