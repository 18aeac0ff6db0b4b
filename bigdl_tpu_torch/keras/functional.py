"""Keras functional (graph) API — `Model(inputs, outputs)`.

Ports bigdl_tpu/keras/functional.py (reference: the nn/keras Model
class — Keras-1 functional wiring: `Input`, calling layers on tensors,
merge layers) lowering onto the static graph container `nn.Graph`, so
the functional model trains through the same path as every other
module. `Model(..., device=None)` places its variables on the card
("cpu" for the host).

    a = Input(shape=(16,))
    b = Input(shape=(16,))
    x = Dense(8, activation="relu")(a)
    y = Dense(8, activation="relu")(b)
    z = Add()([x, y])
    out = Dense(2, activation="log_softmax")(z)
    model = Model(inputs=[a, b], outputs=out)
    model.compile("adam", "nll").fit([xa, xb], labels)

Shapes exclude the batch dim, as everywhere in the keras package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.layers import KerasLayer
from bigdl_tpu_torch.keras.models import _Trainable
from bigdl_tpu_torch.nn import graph as _graph
from bigdl_tpu_torch.utils.device import DeviceLike


class KTensor:
    """A symbolic tensor: a graph node + its inferred (batchless) shape."""

    __slots__ = ("node", "shape")

    def __init__(self, node: _graph.Node, shape: Tuple[int, ...]):
        self.node = node
        self.shape = tuple(shape)

    def __repr__(self):
        return f"KTensor(shape={(None,) + self.shape})"


def Input(shape: Sequence[int], name: Optional[str] = None) -> KTensor:
    """Symbolic entry point (keras.layers.Input; reference nn/Input)."""
    return KTensor(_graph.Input(), tuple(shape))


def call_layer(layer: KerasLayer, tensor) -> KTensor:
    """`layer(tensor)` — wire a single-input layer into the graph
    (KerasLayer.__call__ delegates here).

    Calling the same layer instance again REUSES the module built on the
    first call (Keras weight-sharing contract; nn.Graph dedupes shared
    module objects into one parameter entry). The input shape must match
    the first call's."""
    if isinstance(tensor, (list, tuple)):
        raise TypeError(
            f"{type(layer).__name__} takes one tensor; wrap multiple "
            "tensors with a merge layer (Add, Concatenate, ...)")
    if not isinstance(tensor, KTensor):
        raise TypeError(f"expected a KTensor from Input()/a layer call, "
                        f"got {type(tensor).__name__}")
    cached = getattr(layer, "_fn_built", None)
    if cached is not None:
        in_shape, m, out_shape = cached
        if tensor.shape != in_shape:
            raise ValueError(
                f"{type(layer).__name__} was first called on shape "
                f"{in_shape}; weight sharing requires the same input "
                f"shape, got {tensor.shape}")
    else:
        m, out_shape = layer.build(tensor.shape)
        layer._fn_built = (tensor.shape, m, out_shape)
    if m is None:  # InputLayer-style passthrough
        return tensor
    return KTensor(_graph.Node(m, [tensor.node]), out_shape)


class _Merge(KerasLayer):
    """Base for layers combining a LIST of tensors."""

    def __call__(self, tensors: Sequence[KTensor]) -> KTensor:
        if not isinstance(tensors, (list, tuple)) or len(tensors) < 2:
            raise TypeError(
                f"{type(self).__name__} expects a list of >=2 tensors")
        shapes = [t.shape for t in tensors]
        m, out = self.build_merge(shapes)
        return KTensor(_graph.Node(self._named(m),
                                   [t.node for t in tensors]), out)

    def build_merge(self, shapes):
        raise NotImplementedError

    @staticmethod
    def _require_same(shapes, what):
        if any(s != shapes[0] for s in shapes[1:]):
            raise ValueError(f"{what} needs identical shapes, got {shapes}")
        return shapes[0]


class Add(_Merge):
    def build_merge(self, shapes):
        return nn.CAddTable(), self._require_same(shapes, "Add")


class Multiply(_Merge):
    def build_merge(self, shapes):
        return nn.CMulTable(), self._require_same(shapes, "Multiply")


class Subtract(_Merge):
    def __call__(self, tensors):
        if len(tensors) != 2:
            raise TypeError("Subtract expects exactly 2 tensors")
        return super().__call__(tensors)

    def build_merge(self, shapes):
        return nn.CSubTable(), self._require_same(shapes, "Subtract")


class Maximum(_Merge):
    def build_merge(self, shapes):
        return nn.CMaxTable(), self._require_same(shapes, "Maximum")


class Minimum(_Merge):
    def build_merge(self, shapes):
        return nn.CMinTable(), self._require_same(shapes, "Minimum")


class Average(_Merge):
    def build_merge(self, shapes):
        shape = self._require_same(shapes, "Average")
        return nn.Sequential(nn.CAddTable(),
                             nn.MulConstant(1.0 / len(shapes))), shape


class Concatenate(_Merge):
    """Join along `axis` of the batchless shape (default last)."""

    def __init__(self, axis: int = -1, name=None):
        super().__init__(name=name)
        self.axis = axis

    def build_merge(self, shapes):
        nd = len(shapes[0])
        ax = self.axis if self.axis >= 0 else nd + self.axis
        if not 0 <= ax < nd:
            raise ValueError(
                f"Concatenate axis={self.axis} out of range for "
                f"rank-{nd} inputs {shapes}")
        for s in shapes[1:]:
            if len(s) != nd or any(a != b for i, (a, b) in
                                   enumerate(zip(s, shapes[0])) if i != ax):
                raise ValueError(
                    f"Concatenate(axis={self.axis}) shape mismatch: {shapes}")
        out = list(shapes[0])
        out[ax] = sum(s[ax] for s in shapes)
        # JoinTable dimension is 1-based over the batchless rank with
        # n_input_dims telling it to skip the batch dim at runtime
        return nn.JoinTable(ax + 1, n_input_dims=nd), tuple(out)


class Dot(_Merge):
    """Batch dot product of two flat tensors → (1,)."""

    def __call__(self, tensors):
        if len(tensors) != 2:
            raise TypeError("Dot expects exactly 2 tensors")
        return super().__call__(tensors)

    def build_merge(self, shapes):
        self._require_same(shapes, "Dot")
        return nn.DotProduct(), (1,)


_MERGE_MODES = {
    "sum": Add, "mul": Multiply, "max": Maximum, "min": Minimum,
    "ave": Average, "sub": Subtract, "dot": Dot, "concat": Concatenate,
}


def merge(inputs: Sequence[KTensor], mode: str = "sum",
          concat_axis: int = -1) -> KTensor:
    """Keras-1 style functional merge (reference nn/keras Merge layer)."""
    if mode not in _MERGE_MODES:
        raise ValueError(f"unknown merge mode {mode!r} "
                         f"(have {sorted(_MERGE_MODES)})")
    cls = _MERGE_MODES[mode]
    layer = cls(axis=concat_axis) if cls is Concatenate else cls()
    return layer(list(inputs))


class Model(_Trainable):
    """Functional model over an arbitrary DAG of layer calls.

    Lowers to `nn.Graph`; `compile`/`fit`/`evaluate`/`predict` run the
    same core Optimizer/Evaluator/Predictor stack as keras.Sequential.
    Multi-input fit takes `x` as a list of per-input arrays; multi-output
    models train with a table-aware criterion (nn.ParallelCriterion).
    """

    def __init__(self, inputs: Union[KTensor, Sequence[KTensor]],
                 outputs: Union[KTensor, Sequence[KTensor]],
                 name: Optional[str] = None, device: DeviceLike = None):
        super().__init__(device)
        self.inputs: List[KTensor] = (
            [inputs] if isinstance(inputs, KTensor) else list(inputs))
        self.outputs: List[KTensor] = (
            [outputs] if isinstance(outputs, KTensor) else list(outputs))
        self._module = nn.Graph([t.node for t in self.inputs],
                                [t.node for t in self.outputs], name=name)
        self.input_shapes = [t.shape for t in self.inputs]
        self.output_shape = (self.outputs[0].shape if len(self.outputs) == 1
                             else [t.shape for t in self.outputs])

    def build(self) -> nn.Graph:
        return self._module

    @property
    def module(self) -> nn.Graph:
        return self._module

    def _wrap_x(self, x):
        """list-of-arrays (one per input) → per-sample tuples."""
        import numpy as np

        if len(self.inputs) == 1:
            return np.asarray(x), None
        xs = [np.asarray(xi) for xi in x]
        n = len(xs[0])
        if any(len(xi) != n for xi in xs):
            raise ValueError("all inputs must have the same sample count")
        return xs, n

    def _to_samples(self, x, y):
        import numpy as np

        from bigdl_tpu_torch.dataset import Sample

        if len(self.inputs) == 1:
            return super()._to_samples(x, y)
        xs, n = self._wrap_x(x)
        ys = np.asarray(y)
        return [Sample(tuple(xi[i] for xi in xs), ys[i]) for i in range(n)]

    def _predict_features(self, x):
        if len(self.inputs) == 1:
            return super()._predict_features(x)
        xs, n = self._wrap_x(x)
        return [tuple(xi[i] for xi in xs) for i in range(n)]
