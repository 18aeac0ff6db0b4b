"""Caffe model interop: load prototxt/caffemodel into the port, and
persist the port's models back out as Caffe nets.

Ports bigdl_tpu/utils/caffe/loader.py (reference: utils/caffe/
CaffeLoader.scala — prototxt + caffemodel → Graph, weight copy by layer
name, V1/V2 layer support; CaffePersister.scala — module graph →
NetParameter; Converter.scala / LayerConverter.scala — the per-type
converters). The messages are read and written by the port's own codec
(utils/protowire.py, schema in bigdl_caffe_pb2.py), never by
`google.protobuf`.

Caffe is NCHW/OIHW; the port's layout is the JAX package's, NHWC/HWIO.
The loader transposes weights at conversion time and builds a model
that consumes NHWC input (`input_layout="NCHW"` prepends a transpose
and feeds original Caffe-layout tensors). Caffe's implicit flatten
before InnerProduct orders features (C, H, W); the loader emits an
explicit NHWC→NCHW transpose + reshape so the imported fully-connected
weights apply verbatim. The graph's keys are the JAX loader's, so
`models/convert.variables_from_jax` maps one package's tree onto the
other's. Variables land on `device` (None: the card); layers without
blobs get the port's seeded init (seed 0), not the JAX package's
draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.caffe import bigdl_caffe_pb2 as pb
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device
from bigdl_tpu_torch.utils.interop import graph_variables, linearize
from bigdl_tpu_torch.utils.protowire import merge_text, to_text
from bigdl_tpu_torch.utils.table import T

__all__ = ["CaffeLoader", "CaffePersister", "load", "persist"]

# caffe axis (NCHW) → 1-based dimension over our NHWC tensors
_NCHW_TO_NHWC_DIM = {0: 1, 1: 4, 2: 2, 3: 3}


def _np(x, perm: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """A host array of a variable leaf (a tensor on any device), its
    axes permuted by `perm` — on the tensor's device, before the copy,
    so that a card does the transposes Caffe's layouts need."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if perm is not None:
            x = x.permute(perm).contiguous()
        return x.cpu().numpy()
    x = np.asarray(x)
    return x if perm is None else x.transpose(perm)


def _blob_shape(blob) -> Tuple[int, ...]:
    if blob.HasField("shape"):
        return tuple(int(d) for d in blob.shape.dim)
    legacy = (blob.num, blob.channels, blob.height, blob.width)
    return tuple(int(d) for d in legacy if d)


def _blob_array(blob) -> np.ndarray:
    arr = np.asarray(blob.data, dtype=np.float32)
    shape = _blob_shape(blob)
    return arr.reshape(shape) if shape else arr


def _fill_blob(blob, arr) -> None:
    arr = np.asarray(_np(arr), np.float32)
    blob.shape.dim.extend(arr.shape)
    blob.data.extend(arr.ravel())


def _sym_pad(mod) -> Tuple[int, int]:
    """Caffe's proto has only symmetric uint32 pad_h/pad_w. Tuple
    (low, high) padding (e.g. a space-to-depth stem) must fail loudly
    here, not as an opaque type error at field assignment."""
    if isinstance(mod.pad_h, tuple) or isinstance(mod.pad_w, tuple):
        raise ValueError(
            "Caffe has no asymmetric padding: layer %r has pad_h=%r, "
            "pad_w=%r; re-export with symmetric integer padding"
            % (mod.name, mod.pad_h, mod.pad_w))
    return mod.pad_h, mod.pad_w


def _with_last(seq: Module, last_vars: Dict[str, Any]) -> Dict[str, Any]:
    """`seq`'s variables with its last child's given and the others'
    (parameter-free: the flatten idiom) from their own init."""
    params = {k: m.init_params()
              for k, m in zip(seq._keys[:-1], seq.modules_[:-1])}
    params[seq._keys[-1]] = last_vars["params"]
    return {"params": params, "state": seq.init_state()}


class _Layer:
    """Generation-neutral view of a LayerParameter / V1LayerParameter."""

    def __init__(self, name, type_, bottoms, tops, blobs, proto):
        self.name = name
        self.type = type_
        self.bottoms = list(bottoms)
        self.tops = list(tops)
        self.blobs = list(blobs)
        self.proto = proto  # parameter access (field names shared V1/V2)


_V1_TYPE_NAMES = {
    pb.V1LayerParameter.CONCAT: "Concat",
    pb.V1LayerParameter.CONVOLUTION: "Convolution",
    pb.V1LayerParameter.DATA: "Data",
    pb.V1LayerParameter.DROPOUT: "Dropout",
    pb.V1LayerParameter.ELTWISE: "Eltwise",
    pb.V1LayerParameter.FLATTEN: "Flatten",
    pb.V1LayerParameter.INNER_PRODUCT: "InnerProduct",
    pb.V1LayerParameter.LRN: "LRN",
    pb.V1LayerParameter.POOLING: "Pooling",
    pb.V1LayerParameter.POWER: "Power",
    pb.V1LayerParameter.RELU: "ReLU",
    pb.V1LayerParameter.SIGMOID: "Sigmoid",
    pb.V1LayerParameter.SOFTMAX: "Softmax",
    pb.V1LayerParameter.SOFTMAX_LOSS: "SoftmaxWithLoss",
    pb.V1LayerParameter.SPLIT: "Split",
    pb.V1LayerParameter.TANH: "TanH",
}

_DATA_TYPES = {"Data", "ImageData", "HDF5Data", "MemoryData", "DummyData",
               "Input"}
_SKIP_TYPES = {"Accuracy", "Silence"}


def _iter_layers(net) -> List[_Layer]:
    out = []
    for l in net.layer:
        out.append(_Layer(l.name, l.type, l.bottom, l.top, l.blobs, l))
    for l in net.layers:  # V1
        tname = _V1_TYPE_NAMES.get(l.type)
        if tname is None:
            raise NotImplementedError(
                f"V1 caffe layer type {l.type} ({l.name}) unsupported")
        out.append(_Layer(l.name, tname, l.bottom, l.top, l.blobs, l))
    return out


def _test_phase(layer: _Layer) -> bool:
    for rule in layer.proto.include:
        if rule.HasField("phase") and rule.phase != pb.TEST:
            return False
    for rule in layer.proto.exclude:
        if rule.HasField("phase") and rule.phase == pb.TEST:
            return False
    return True


def _meta(tree: Any) -> Any:
    """Shape-only (meta-device) copies of a tree of arrays/tensors."""
    return tree_map(lambda a: torch.empty(tuple(np.shape(a)),
                                          device="meta"), tree)


class CaffeLoader:
    """Load (prototxt, caffemodel) → (Graph, variables).

    The prototxt defines the architecture; the caffemodel supplies weights
    matched **by layer name** exactly as the reference's
    CaffeLoader.copyParameters does — unmatched layers keep their fresh
    initialization (a warning is collected in ``self.unmatched``).
    """

    def __init__(self, def_path: Optional[str] = None,
                 model_path: Optional[str] = None,
                 input_layout: str = "NHWC", device: DeviceLike = None):
        if def_path is None and model_path is None:
            raise ValueError("need a prototxt and/or caffemodel path")
        self.def_path = def_path
        self.model_path = model_path
        self.input_layout = input_layout
        self.device = device
        self.unmatched: List[str] = []

    # ---- parsing -------------------------------------------------------

    def _read(self) -> Tuple[Any, Dict[str, List[Any]]]:
        weights: Dict[str, List[Any]] = {}
        binary = None
        if self.model_path:
            binary = pb.NetParameter()
            with open(self.model_path, "rb") as f:
                binary.ParseFromString(f.read())
            for l in _iter_layers(binary):
                if l.blobs:
                    weights[l.name] = l.blobs
        if self.def_path:
            net = pb.NetParameter()
            with open(self.def_path, "r") as f:
                merge_text(f.read(), net)
        else:
            net = binary
        return net, weights

    # ---- layer converters ---------------------------------------------

    def _convert(self, layer: _Layer, blobs: List[Any], rank: int,
                 in_shape: Optional[Sequence[int]] = None,
                 ) -> Tuple[Module, Optional[Dict[str, Any]], int]:
        """→ (module, variables | None for stateless, output_rank).

        `in_shape` is the bottom blob's NHWC shape when known — needed to
        fresh-initialize Convolution/InnerProduct layers that have no
        weights in the caffemodel (reference: CaffeLoader.copyParameters
        matches by name; unmatched layers keep their init).
        """
        t, p = layer.type, layer.proto
        if t == "Convolution":
            return self._conv(p, blobs, in_shape) + (4,)
        if t == "Deconvolution":
            return self._deconv(p, blobs, in_shape) + (4,)
        if t == "InnerProduct":
            return self._inner_product(p, blobs, rank, in_shape) + (2,)
        if t == "Pooling":
            return self._pooling(p.pooling_param), None, 4
        if t in ("ReLU", "ReLU6"):
            slope = getattr(p, "relu_param", None)
            if slope is not None and slope.negative_slope:
                return nn.LeakyReLU(slope.negative_slope), None, rank
            return nn.ReLU(), None, rank
        if t == "TanH":
            return nn.Tanh(), None, rank
        if t == "Sigmoid":
            return nn.Sigmoid(), None, rank
        if t in ("Softmax", "SoftmaxWithLoss", "SigmoidCrossEntropyLoss",
                 "EuclideanLoss", "HingeLoss"):
            # loss layers degrade to their prediction op (label bottoms are
            # dropped by the caller); plain Euclidean/Hinge pass through
            if t in ("EuclideanLoss", "HingeLoss"):
                return nn.Identity(), None, rank
            if t == "SigmoidCrossEntropyLoss":
                return nn.Sigmoid(), None, rank
            return nn.SoftMax(), None, rank
        if t == "LRN":
            lp = p.lrn_param
            if lp.norm_region != pb.LRNParameter.ACROSS_CHANNELS:
                raise NotImplementedError("WITHIN_CHANNEL LRN")
            return (nn.SpatialCrossMapLRN(int(lp.local_size), lp.alpha,
                                          lp.beta, lp.k), None, 4)
        if t == "Dropout":
            return nn.Dropout(p.dropout_param.dropout_ratio), None, rank
        if t == "Power":
            pp = p.power_param
            return nn.Power(pp.power, pp.scale, pp.shift), None, rank
        if t == "Flatten":
            return self._flatten(), None, 2
        if t == "Reshape":
            dims = tuple(int(d) for d in p.reshape_param.shape.dim)
            if dims in ((0, -1), (-1,)):
                return self._flatten(), None, 2
            raise NotImplementedError(f"Reshape{dims} (only flatten forms)")
        if t == "Concat":
            axis = p.concat_param.axis if p.concat_param.HasField("axis") \
                else p.concat_param.concat_dim
            if axis < 0:  # caffe allows negative axes, counted from the end
                axis += rank
            dim = _NCHW_TO_NHWC_DIM[axis] if rank == 4 else axis + 1
            return nn.JoinTable(dimension=dim, n_input_dims=rank), None, rank
        if t == "Eltwise":
            ep = p.eltwise_param
            coeff = list(ep.coeff)
            if ep.operation == pb.EltwiseParameter.PROD:
                return nn.CMulTable(), None, rank
            if ep.operation == pb.EltwiseParameter.MAX:
                return nn.CMaxTable(), None, rank
            if coeff and coeff == [1.0, -1.0]:
                return nn.CSubTable(), None, rank
            if coeff and any(c != 1.0 for c in coeff):
                raise NotImplementedError(f"Eltwise SUM coeff={coeff}")
            return nn.CAddTable(), None, rank
        if t == "BatchNorm":
            return self._batch_norm(p, blobs) + (4 if rank == 4 else rank,)
        if t == "Scale":
            return self._scale(p, blobs) + (rank,)
        raise NotImplementedError(f"caffe layer type {t!r} ({layer.name})")

    @staticmethod
    def _flatten() -> Module:
        # NHWC → NCHW then flatten: keeps Caffe's (C,H,W) feature order so
        # imported InnerProduct weights apply verbatim.
        seq = nn.Sequential()
        seq.add(nn.Transpose(((2, 4), (3, 4))))  # NHWC → NCHW
        seq.add(nn.Reshape((-1,), batch_mode=True))
        return seq

    @staticmethod
    def _conv_geometry(cp):
        kh = int(cp.kernel_h or (cp.kernel_size[0] if cp.kernel_size else 1))
        kw = int(cp.kernel_w or (cp.kernel_size[-1] if cp.kernel_size else 1))
        sh = int(cp.stride_h or (cp.stride[0] if cp.stride else 1))
        sw = int(cp.stride_w or (cp.stride[-1] if cp.stride else 1))
        ph = int(cp.pad_h or (cp.pad[0] if cp.pad else 0))
        pw = int(cp.pad_w or (cp.pad[-1] if cp.pad else 0))
        # dilation is a repeated field with the same per-axis [0]/[-1]
        # convention as kernel_size/stride/pad (h first, then w)
        dil_h = int(cp.dilation[0]) if cp.dilation else 1
        dil_w = int(cp.dilation[-1]) if cp.dilation else 1
        return kh, kw, sh, sw, ph, pw, dil_h, dil_w

    def _conv(self, p, blobs, in_shape=None):
        cp = p.convolution_param
        kh, kw, sh, sw, ph, pw, dil_h, dil_w = self._conv_geometry(cp)
        dil = max(dil_h, dil_w)
        n_out = int(cp.num_output)
        group = int(cp.group)
        if not blobs:
            # unmatched layer: fresh init, channels from the bottom shape
            if in_shape is None or len(in_shape) != 4:
                raise ValueError(
                    "Convolution without weights needs a known input shape "
                    "(declare input_shape in the prototxt)")
            n_in = int(in_shape[-1])
        else:
            w = _blob_array(blobs[0])  # (O, I/g, kH, kW)
            n_in = int(w.shape[1]) * group
        if dil > 1:
            m = nn.SpatialDilatedConvolution(
                n_in, n_out, kw, kh, sw, sh, pw, ph,
                dilation_w=dil_w, dilation_h=dil_h,
                n_group=group, with_bias=cp.bias_term)
        else:
            m = nn.SpatialConvolution(
                n_in, n_out, kw, kh, sw, sh, pw, ph, n_group=group,
                with_bias=cp.bias_term)
        if not blobs:
            return m, None
        params = {"weight": w.transpose(2, 3, 1, 0)}  # OIHW → HWIO
        if cp.bias_term:
            params["bias"] = _blob_array(blobs[1]).reshape(-1)
        return m, {"params": params, "state": {}}

    def _deconv(self, p, blobs, in_shape=None):
        """Caffe Deconvolution → SpatialFullConvolution (transposed
        conv). Blob layout is (I, O/g, kH, kW) — input channels FIRST,
        the transpose of Convolution's (O, I/g, kH, kW). Grouped and
        dilated variants map onto the module's n_group/dilation."""
        cp = p.convolution_param
        kh, kw, sh, sw, ph, pw, dil_h, dil_w = self._conv_geometry(cp)
        group = int(cp.group) if cp.group else 1
        n_out = int(cp.num_output)
        if not blobs:
            if in_shape is None or len(in_shape) != 4:
                raise ValueError(
                    "Deconvolution without weights needs a known input "
                    "shape (declare input_shape in the prototxt)")
            m = nn.SpatialFullConvolution(
                int(in_shape[-1]), n_out, kw, kh, sw, sh, pw, ph,
                with_bias=cp.bias_term, n_group=group,
                dilation_w=dil_w, dilation_h=dil_h)
            return m, None
        w = _blob_array(blobs[0])  # (I, O/g, kH, kW)
        n_in = int(w.shape[0])
        m = nn.SpatialFullConvolution(
            n_in, n_out, kw, kh, sw, sh, pw, ph,
            with_bias=cp.bias_term, n_group=group,
            dilation_w=dil_w, dilation_h=dil_h)
        if group == 1:
            wn = w.transpose(2, 3, 1, 0)          # IOHW → HWOI
        else:
            # per-group (I/g, O/g, kH, kW) slices stack along the module
            # weight's O axis: (kH, kW, O_total, I/g)
            ig = n_in // group
            wn = np.concatenate(
                [w[g * ig:(g + 1) * ig].transpose(2, 3, 1, 0)
                 for g in range(group)], axis=2)
        params = {"weight": wn}
        if cp.bias_term:
            params["bias"] = _blob_array(blobs[1]).reshape(-1)
        return m, {"params": params, "state": {}}

    def _inner_product(self, p, blobs, rank, in_shape=None):
        ip = p.inner_product_param
        n_out = int(ip.num_output)
        if not blobs:
            # unmatched layer: fresh init, fan-in from the bottom shape
            if in_shape is None:
                raise ValueError(
                    "InnerProduct without weights needs a known input shape "
                    "(declare input_shape in the prototxt)")
            n_in = 1
            for d in in_shape[1:]:
                n_in *= int(d)
            lin = nn.Linear(n_in, n_out, with_bias=ip.bias_term)
            if rank == 4:
                seq = self._flatten()
                seq.add(lin)
                return seq, None
            return lin, None
        if ip.transpose:
            # blob stored input-major (K, num_output); use as-is after
            # reshaping in that orientation (caffe InnerProduct transpose)
            w = _blob_array(blobs[0]).reshape(-1, n_out).T
        else:
            w = _blob_array(blobs[0]).reshape(n_out, -1)
        n_in = w.shape[1]
        lin = nn.Linear(n_in, n_out, with_bias=ip.bias_term)
        params = {"weight": w.T}  # (O, I) → (I, O)
        if ip.bias_term:
            params["bias"] = _blob_array(blobs[1]).reshape(-1)
        lin_vars = {"params": params, "state": {}}
        if rank == 4:
            seq = self._flatten()
            seq.add(lin)
            return seq, _with_last(seq, lin_vars)
        return lin, lin_vars

    @staticmethod
    def _pooling(pp) -> Module:
        is_max = pp.pool == pb.PoolingParameter.MAX
        if pp.global_pooling:
            red = nn.Max if is_max else nn.Mean
            seq = nn.Sequential()
            seq.add(red(dimension=2, squeeze=False))  # H
            seq.add(red(dimension=3, squeeze=False))  # W
            return seq
        kh = int(pp.kernel_h or pp.kernel_size)
        kw = int(pp.kernel_w or pp.kernel_size)
        sh = int(pp.stride_h or pp.stride)
        sw = int(pp.stride_w or pp.stride)
        ph = int(pp.pad_h or pp.pad)
        pw = int(pp.pad_w or pp.pad)
        # Caffe pooling rounds output size UP by default (ceil semantics);
        # round_mode=FLOOR (upstream caffe.proto field 13) opts out
        ceil = pp.round_mode != pb.PoolingParameter.FLOOR
        cls = nn.SpatialMaxPooling if is_max else nn.SpatialAveragePooling
        return cls(kernel_w=kw, kernel_h=kh, stride_w=sw, stride_h=sh,
                   pad_w=pw, pad_h=ph, ceil_mode=ceil)

    @staticmethod
    def _batch_norm(p, blobs):
        bp = p.batch_norm_param
        m = nn.SpatialBatchNormalization(
            n_output=int(_blob_shape(blobs[0])[0]) if blobs else 0,
            eps=bp.eps, momentum=1.0 - bp.moving_average_fraction,
            affine=False)
        if not blobs:
            return m, None
        mean = _blob_array(blobs[0]).reshape(-1)
        var = _blob_array(blobs[1]).reshape(-1)
        sf = float(_blob_array(blobs[2]).ravel()[0]) if len(blobs) > 2 else 1.0
        sf = sf if sf != 0 else 1.0
        state = {"running_mean": mean / sf, "running_var": var / sf}
        return m, {"params": {}, "state": state}

    @staticmethod
    def _scale(p, blobs):
        sp = p.scale_param
        gamma = _blob_array(blobs[0]).reshape(-1) if blobs else None
        size = (gamma.shape[0],) if gamma is not None else (1,)
        if sp.bias_term:
            seq = nn.Sequential()
            seq.add(nn.CMul(size))
            seq.add(nn.CAdd(size))
            if gamma is None:
                return seq, None
            beta = _blob_array(blobs[1]).reshape(-1)
            k0, k1 = seq._keys
            return seq, {"params": {k0: {"weight": gamma},
                                    k1: {"bias": beta}},
                         "state": {k0: {}, k1: {}}}
        m = nn.CMul(size)
        if gamma is None:
            return m, None
        return m, {"params": {"weight": gamma}, "state": {}}

    # ---- graph assembly -----------------------------------------------

    def load(self) -> Tuple[Graph, Dict[str, Any]]:
        dev = resolve_device(self.device)
        net, weights = self._read()
        blob_node: Dict[str, Node] = {}
        blob_rank: Dict[str, int] = {}
        blob_shape: Dict[str, Optional[Tuple[int, ...]]] = {}
        input_nodes: List[Node] = []
        node_vars: Dict[int, Dict[str, Any]] = {}

        def to_nhwc(shape):
            s = tuple(int(d) for d in shape)
            return (s[0], s[2], s[3], s[1]) if len(s) == 4 else s

        def add_input(name: str, shape: Optional[Sequence[int]]):
            node = Input()
            blob_node[name] = node
            blob_rank[name] = len(shape) if shape else 4
            blob_shape[name] = to_nhwc(shape) if shape else None
            input_nodes.append(node)

        # net-level inputs (input/input_shape/input_dim prototxt style)
        for i, name in enumerate(net.input):
            if i < len(net.input_shape):
                shape = tuple(net.input_shape[i].dim)
            elif net.input_dim:
                shape = tuple(net.input_dim[4 * i:4 * i + 4])
            else:
                shape = None
            add_input(name, shape)

        def out_shape(module, variables, in_shapes):
            """The module's output NHWC shape, from a pass over
            meta-device tensors (no data, no compute)."""
            if any(s is None for s in in_shapes):
                return None
            try:
                xs = [torch.empty(tuple(s), device="meta")
                      for s in in_shapes]
                args = xs if len(xs) == 1 else [T(*xs)]
                res, _ = module.apply(variables, *args, training=False)
                return tuple(res.shape)
            except Exception:
                return None

        for layer in _iter_layers(net):
            if not _test_phase(layer):
                continue
            if layer.type in _SKIP_TYPES:
                continue
            if layer.type in _DATA_TYPES:
                shape = None
                ipp = getattr(layer.proto, "input_param", None)
                if ipp is not None and ipp.shape:
                    shape = tuple(ipp.shape[0].dim)
                # Data layers expose (data, label); only data becomes input
                add_input(layer.tops[0], shape)
                for extra in layer.tops[1:]:
                    blob_node[extra] = blob_node[layer.tops[0]]
                    blob_rank[extra] = 1
                    blob_shape[extra] = None
                continue
            if layer.type == "Split":
                src = blob_node[layer.bottoms[0]]
                for top in layer.tops:
                    blob_node[top] = src
                    blob_rank[top] = blob_rank[layer.bottoms[0]]
                    blob_shape[top] = blob_shape.get(layer.bottoms[0])
                continue
            bottoms = [b for b in layer.bottoms if b in blob_node]
            if layer.type.endswith("Loss") and bottoms:
                bottoms = bottoms[:1]  # drop label/weight bottoms
            if not bottoms:
                raise ValueError(f"layer {layer.name}: unknown bottoms "
                                 f"{layer.bottoms}")
            rank = blob_rank[bottoms[0]]
            blobs = list(layer.blobs) or weights.get(layer.name, [])
            if not blobs and layer.type in ("Convolution", "InnerProduct"):
                self.unmatched.append(layer.name)
            module, variables, out_rank = self._convert(
                layer, blobs, rank, blob_shape.get(bottoms[0]))
            module.set_name(layer.name)
            parents = [blob_node[b] for b in bottoms]
            node = Node.wire(module, parents)
            if variables is not None:
                node_vars[id(node)] = variables
                shape_vars = _meta(variables)
            else:
                with torch.device("meta"):
                    shape_vars = {"params": module.init_params(
                        torch.Generator()), "state": module.init_state()}
            top = layer.tops[0] if layer.tops else layer.name
            blob_node[top] = node
            blob_rank[top] = out_rank
            blob_shape[top] = out_shape(
                module, shape_vars, [blob_shape.get(b) for b in bottoms])

        # graph outputs: blobs never consumed as bottoms of real layers
        # (skipped layers like Accuracy must not hide a terminal blob)
        consumed = set()
        for layer in _iter_layers(net):
            if _test_phase(layer) and layer.type not in _DATA_TYPES \
                    and layer.type not in _SKIP_TYPES:
                consumed.update(layer.bottoms)
        outputs = [n for b, n in blob_node.items()
                   if b not in consumed and not (n in input_nodes)]
        # dedupe, keep definition order
        seen, uniq = set(), []
        for n in outputs:
            if id(n) not in seen:
                seen.add(id(n))
                uniq.append(n)
        if not uniq:
            raise ValueError("caffe net has no output blobs")

        graph = Graph(input_nodes, uniq, name=net.name or None)
        variables = graph_variables(graph, node_vars, dev)

        if self.input_layout == "NCHW":
            seq = nn.Sequential()
            seq.add(nn.Transpose(((2, 3), (3, 4))))  # NCHW → NHWC
            seq.add(graph)
            k0, k1 = seq._keys
            variables = {"params": {k0: {}, k1: variables["params"]},
                         "state": {k0: {}, k1: variables["state"]}}
            return seq, variables
        return graph, variables


def load(def_path: Optional[str] = None, model_path: Optional[str] = None,
         input_layout: str = "NHWC", device: DeviceLike = None
         ) -> Tuple[Module, Dict[str, Any]]:
    """Convenience: CaffeLoader(...).load()
    (reference: utils/caffe/CaffeLoader.scala#CaffeLoader.loadCaffe)."""
    return CaffeLoader(def_path, model_path, input_layout, device).load()


# ---------------------------------------------------------------------------
# Persister
# ---------------------------------------------------------------------------


class CaffePersister:
    """Export a port model as (prototxt, caffemodel)
    (reference: utils/caffe/CaffePersister.scala#CaffePersister.persist).

    Supports the converter-covered layer set.  The exported net is in
    Caffe's native NCHW layout: conv/linear weights are transposed back and
    the loader's flatten idiom (Transpose+Reshape) becomes ``Flatten``.
    The variables may live on any device.
    """

    def __init__(self, module: Module, variables: Dict[str, Any],
                 input_shape: Sequence[int], name: str = "bigdl_tpu"):
        self.module = module
        self.variables = variables
        self.input_shape = tuple(int(d) for d in input_shape)  # NCHW
        self.name = name
        self._names_used: Dict[str, int] = {}

    def _fresh(self, base: str) -> str:
        n = self._names_used.get(base, 0)
        self._names_used[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    # ---- flatten sequence of (module, vars, inputs) -------------------

    def _linearize(self):
        """Yield (module, variables, input_ids) entries in topo order."""
        return linearize(self.module, self.variables)

    # ---- emission ------------------------------------------------------

    def build_net(self):
        net = pb.NetParameter()
        net.name = self.name
        net.input.append("data")
        shp = net.input_shape.add()
        shp.dim.extend(self.input_shape)

        entries, _ = self._linearize()
        blob_of = {-1: "data"}
        i = 0
        while i < len(entries):
            consumed = self._emit(net, entries, i, blob_of)
            i += consumed
        return net

    def persist(self, def_path: str, model_path: str) -> None:
        net = self.build_net()
        with open(model_path, "wb") as f:
            f.write(net.SerializeToString())
        # prototxt: architecture only (the net is ours: drop its blobs
        # in place rather than copy ~all the weights)
        for l in net.layer:
            del l.blobs[:]
        with open(def_path, "w") as f:
            f.write(to_text(net))

    def _new_layer(self, net, type_: str, name: str, bottoms: List[str]
                   ) -> Tuple[Any, str]:
        l = net.layer.add()
        l.name = self._fresh(name)
        l.type = type_
        l.bottom.extend(bottoms)
        top = l.name
        l.top.append(top)
        return l, top

    def _emit(self, net, entries, i, blob_of) -> int:
        """Emit entry i (possibly merging the flatten idiom); returns how
        many entries were consumed."""
        mod, v, in_ids = entries[i]
        bots = [blob_of[j] for j in in_ids]
        p = v.get("params", {})

        def finish(layer, top, n_entries=1):
            blob_of[i + n_entries - 1] = top
            return n_entries

        # flatten idiom: exactly Transpose((2,4),(3,4)) then Reshape((-1,))
        # (the NHWC→NCHW + flatten pair _flatten() emits) — anything else
        # keeps its own layers
        if isinstance(mod, nn.Transpose) and i + 1 < len(entries) and \
                mod.permutations == [(2, 4), (3, 4)] and \
                isinstance(entries[i + 1][0], nn.Reshape) and \
                entries[i + 1][0].size == (-1,) and \
                entries[i + 1][0].batch_mode is not False:
            l, top = self._new_layer(net, "Flatten", mod.name, bots)
            blob_of[i] = top
            return finish(l, top, 2)
        if isinstance(mod, nn.SpatialFullConvolution):
            l, top = self._new_layer(net, "Deconvolution", mod.name, bots)
            cp = l.convolution_param
            cp.num_output = mod.n_output_plane
            cp.kernel_h, cp.kernel_w = mod.kernel_h, mod.kernel_w
            cp.stride_h, cp.stride_w = mod.stride_h, mod.stride_w
            cp.pad_h, cp.pad_w = _sym_pad(mod)
            cp.bias_term = mod.with_bias
            if mod.n_group > 1:
                cp.group = mod.n_group
            if mod.dilation_h != mod.dilation_w:
                # repeated field, h first then w (loader convention)
                cp.dilation.extend([mod.dilation_h, mod.dilation_w])
            elif mod.dilation_w > 1:
                cp.dilation.append(mod.dilation_w)
            wm = _np(p["weight"])                      # (kH,kW,O_tot,I/g)
            g = mod.n_group
            og = mod.n_output_plane // g
            # inverse of the loader mapping: O-blocks → caffe I axis
            w = np.concatenate(
                [wm[:, :, j * og:(j + 1) * og, :].transpose(3, 2, 0, 1)
                 for j in range(g)], axis=0)           # (I, O/g, kH, kW)
            _fill_blob(l.blobs.add(), w)
            if mod.with_bias:
                _fill_blob(l.blobs.add(), p["bias"])
            return finish(l, top)
        if isinstance(mod, nn.SpatialConvolution):
            l, top = self._new_layer(net, "Convolution", mod.name, bots)
            cp = l.convolution_param
            cp.num_output = mod.n_output_plane
            cp.kernel_h, cp.kernel_w = mod.kernel_h, mod.kernel_w
            cp.stride_h, cp.stride_w = mod.stride_h, mod.stride_w
            cp.pad_h, cp.pad_w = _sym_pad(mod)
            cp.group = mod.n_group
            cp.bias_term = mod.with_bias
            if isinstance(mod, nn.SpatialDilatedConvolution):
                if mod.dilation_h != mod.dilation_w:
                    # repeated field, h first then w (loader convention)
                    cp.dilation.extend([mod.dilation_h, mod.dilation_w])
                else:
                    cp.dilation.append(mod.dilation_h)
            w = _np(p["weight"], (3, 2, 0, 1))  # HWIO → OIHW
            _fill_blob(l.blobs.add(), w)
            if mod.with_bias:
                _fill_blob(l.blobs.add(), p["bias"])
            return finish(l, top)
        if isinstance(mod, nn.Linear):
            l, top = self._new_layer(net, "InnerProduct", mod.name, bots)
            ip = l.inner_product_param
            ip.num_output = mod.output_size
            ip.bias_term = mod.with_bias
            _fill_blob(l.blobs.add(), _np(p["weight"], (1, 0)))
            if mod.with_bias:
                _fill_blob(l.blobs.add(), p["bias"])
            return finish(l, top)
        if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
            l, top = self._new_layer(net, "Pooling", mod.name, bots)
            pp = l.pooling_param
            pp.pool = (pb.PoolingParameter.MAX
                       if isinstance(mod, nn.SpatialMaxPooling)
                       else pb.PoolingParameter.AVE)
            pp.kernel_h, pp.kernel_w = mod.kernel_h, mod.kernel_w
            pp.stride_h, pp.stride_w = mod.stride_h, mod.stride_w
            pp.pad_h, pp.pad_w = mod.pad_h, mod.pad_w
            if not mod.ceil_mode:
                pp.round_mode = pb.PoolingParameter.FLOOR
            return finish(l, top)
        simple = {nn.ReLU: "ReLU", nn.Tanh: "TanH", nn.Sigmoid: "Sigmoid",
                  nn.SoftMax: "Softmax"}
        for cls, tname in simple.items():
            if type(mod) is cls:
                l, top = self._new_layer(net, tname, mod.name, bots)
                return finish(l, top)
        if isinstance(mod, nn.LeakyReLU):
            l, top = self._new_layer(net, "ReLU", mod.name, bots)
            l.relu_param.negative_slope = mod.negval
            return finish(l, top)
        if isinstance(mod, nn.SpatialCrossMapLRN):
            l, top = self._new_layer(net, "LRN", mod.name, bots)
            lp = l.lrn_param
            lp.local_size = mod.size
            lp.alpha, lp.beta, lp.k = mod.alpha, mod.beta, mod.k
            return finish(l, top)
        if isinstance(mod, nn.Dropout):
            l, top = self._new_layer(net, "Dropout", mod.name, bots)
            # the JAX persister reads a `mod.init_p` its Dropout lacks
            # (ROADMAP.md §C); the reference writes the ratio
            l.dropout_param.dropout_ratio = mod.p
            return finish(l, top)
        if isinstance(mod, nn.Power):
            l, top = self._new_layer(net, "Power", mod.name, bots)
            l.power_param.power = mod.power
            l.power_param.scale = mod.scale
            l.power_param.shift = mod.shift
            return finish(l, top)
        if isinstance(mod, nn.JoinTable):
            l, top = self._new_layer(net, "Concat", mod.name, bots)
            inv = {v_: k_ for k_, v_ in _NCHW_TO_NHWC_DIM.items()}
            l.concat_param.axis = inv.get(mod.dimension, mod.dimension - 1)
            return finish(l, top)
        if isinstance(mod, nn.CAddTable):
            l, top = self._new_layer(net, "Eltwise", mod.name, bots)
            l.eltwise_param.operation = pb.EltwiseParameter.SUM
            return finish(l, top)
        if isinstance(mod, nn.CMulTable):
            l, top = self._new_layer(net, "Eltwise", mod.name, bots)
            l.eltwise_param.operation = pb.EltwiseParameter.PROD
            return finish(l, top)
        if isinstance(mod, nn.CMaxTable):
            l, top = self._new_layer(net, "Eltwise", mod.name, bots)
            l.eltwise_param.operation = pb.EltwiseParameter.MAX
            return finish(l, top)
        if isinstance(mod, (nn.BatchNormalization,)):
            st = v.get("state", {})
            l, top = self._new_layer(net, "BatchNorm", mod.name, bots)
            l.batch_norm_param.eps = mod.eps
            l.batch_norm_param.use_global_stats = True
            _fill_blob(l.blobs.add(), st["running_mean"])
            _fill_blob(l.blobs.add(), st["running_var"])
            _fill_blob(l.blobs.add(), np.ones((1,), np.float32))
            if mod.affine:
                l2, top = self._new_layer(net, "Scale", mod.name + "_scale",
                                          [top])
                l2.scale_param.bias_term = True
                _fill_blob(l2.blobs.add(), p["weight"])
                _fill_blob(l2.blobs.add(), p["bias"])
            return finish(l, top)
        if isinstance(mod, nn.CMul):
            l, top = self._new_layer(net, "Scale", mod.name, bots)
            l.scale_param.bias_term = False
            _fill_blob(l.blobs.add(), _np(p["weight"]).reshape(-1))
            return finish(l, top)
        if isinstance(mod, nn.CAdd):
            # standalone bias → Scale with unit gamma
            l, top = self._new_layer(net, "Scale", mod.name, bots)
            l.scale_param.bias_term = True
            b = _np(p["bias"]).reshape(-1)
            _fill_blob(l.blobs.add(), np.ones_like(b))
            _fill_blob(l.blobs.add(), b)
            return finish(l, top)
        if isinstance(mod, nn.Identity):
            blob_of[i] = bots[0]
            return 1
        if isinstance(mod, (nn.Mean, nn.Max)) and not mod.squeeze:
            # global-pooling halves: merge pairs reducing H then W
            if i + 1 < len(entries) and type(entries[i + 1][0]) is type(mod):
                l, top = self._new_layer(net, "Pooling", mod.name, bots)
                l.pooling_param.pool = (pb.PoolingParameter.MAX
                                        if isinstance(mod, nn.Max)
                                        else pb.PoolingParameter.AVE)
                l.pooling_param.global_pooling = True
                blob_of[i] = top
                return finish(l, top, 2)
        raise NotImplementedError(
            f"caffe export: no converter for {type(mod).__name__}")


def persist(def_path: str, model_path: str, module: Module,
            variables: Dict[str, Any], input_shape: Sequence[int],
            name: str = "bigdl_tpu") -> None:
    """Convenience: CaffePersister(...).persist(...)."""
    CaffePersister(module, variables, input_shape, name).persist(
        def_path, model_path)
