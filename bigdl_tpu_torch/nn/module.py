"""Module and Criterion bases — the functional surface of the port.

Ports bigdl_tpu/nn/module.py. As in the JAX package a Module is a
description (hyper-parameters only) and its data lives in nested dicts
threaded through two functions:

    variables = module.init(generator)   # {'params': ..., 'state': ...}
    y, state  = module.apply(variables, x, training=..., rng=...)

`params` are the trainable tensors (autograd differentiates with
respect to them), `state` the non-trainable buffers. The names, shapes
and layouts of the JAX package's trees are kept, so weights carry
across unchanged (models/convert.py). JAX's PRNG keys become
`torch.Generator`s: `init`/`build` take one (default: seed 0, on the
CPU, so the weights of a seed do not depend on the device) and a
`device` for the result (None: the card, utils/device.resolve_device);
`rng` in `apply` is one, and containers derive each child's generator
with `_fold_rng`, the counterpart of `jax.random.fold_in`. Container
keys use `key_name()` (the `set_name` name, else the class name), as
in the JAX package.

The base is `torch.nn.Module` only so that a port model passes
`isinstance` checks and can carry hooks and submodules. The rest of
torch's Module surface does not apply: the parameters are not
registered as `nn.Parameter`s — they live in the variables dict —
`parameters(variables)` lists them the JAX package's way (qualified
name, tensor), and `apply(variables, ...)` is the forward, not torch's
`apply(fn)`. So torch helpers built on the inherited contract
(`zero_grad`, `clip_grad_norm_(m.parameters())`, `m.apply(init_fn)`)
do not work on a port model, and `.to()`/`.cuda()`/`.cpu()` raise
rather than return a module whose variables stayed where they were:
move the variables with `models.convert.tree_map`. `evaluate(dataset,
methods)`, `predict(dataset)` and `predict_class(dataset)` run
optim/evaluator.py over the stored variables. Called on `nn.graph.Node`s,
a module wires itself into a graph (`Linear(4, 2)(x)`, nn/graph.py).

The eager facade (reference: AbstractModule.forward, training,
evaluate): `m(x)` and `m.forward(x, rng=None)` run `apply` over the
stored variables in the module's mode and store the new state back;
`get_parameters()` is every parameter in one flat vector. The mode is
torch's own `training` attribute, which serves both packages' uses: it
is truthy in training mode (the default) as torch's bool is, and
callable — `m.training()` switches to training mode and returns the
module, as the JAX package's method does; `m.evaluate()` with no
arguments switches to eval mode and returns the module;
`is_training()` reads it. torch's `train(mode)` and `eval()` set the
same flag (on registered children too).

Constructor capture (the JAX package's `_SpecCaptured`): constructing
any Module or Criterion records `self._ctor = (type(self), args,
kwargs)`, and the post-construction mutators (`set_name`, pooling's
`ceil`, the containers' and criterions' `add`, `Recurrent.add`) append
to `self._mutations`; serialization/module_serializer.py turns both
into the architecture spec and replays them on load.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.models.convert import tree_leaves_with_path, tree_map
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

_id_counter = itertools.count()
_MASK64 = (1 << 64) - 1


class _Mode(int):
    """A module's mode as its `training` attribute reads it: 1 in
    training mode, 0 in eval mode (so `if m.training:` works as on a
    torch module), and callable: `m.training()` switches the module to
    training mode and returns it."""

    def __new__(cls, module: "Module", value: bool):
        mode = super().__new__(cls, bool(value))
        mode._module = module
        return mode

    def __call__(self) -> "Module":
        self._module.training = True
        return self._module

    def __repr__(self) -> str:
        return repr(bool(self))


def _wrap_ctor_capture(cls) -> None:
    """Wrap `cls.__init__` so that constructing an instance records
    `_ctor = (type(self), args, kwargs)` once (the outermost call: a
    subclass's super().__init__ does not overwrite it)."""
    orig = cls.__dict__.get("__init__")
    if orig is None or getattr(orig, "_spec_wrapped", False):
        return

    def __init__(self, *args, _orig=orig, **kwargs):
        first = "_ctor" not in self.__dict__
        if first:
            self.__dict__["_ctor"] = (type(self), args, kwargs)
            self.__dict__["_ctor_done"] = False
        _orig(self, *args, **kwargs)
        if first:
            self.__dict__["_ctor_done"] = True

    __init__._spec_wrapped = True
    __init__.__wrapped__ = orig
    cls.__init__ = __init__


class _SpecCaptured:
    """Mixin: capture the constructor arguments of every subclass."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _wrap_ctor_capture(cls)

    def _record_mutation(self, method: str, *args) -> None:
        if self.__dict__.get("_ctor_done", False):
            self.__dict__.setdefault("_mutations", []).append((method, args))


def _fold_rng(rng: Optional[torch.Generator], i: int
              ) -> Optional[torch.Generator]:
    """A generator derived from `rng` and `i`, on rng's device: a pure
    function of rng's seed and i (splitmix64 of the pair), as
    `jax.random.fold_in` is of the key — folding the same generator
    with the same i twice gives the same stream, and draws already
    taken from `rng` do not change it. None stays None."""
    if rng is None:
        return None
    x = (rng.initial_seed() * 0x9E3779B97F4A7C15 + i + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return torch.Generator(device=rng.device).manual_seed(x >> 1)


class Module(_SpecCaptured, torch.nn.Module):
    """Base class of the port's modules. Subclasses override
    `init_params(generator) -> dict`, `init_state() -> dict` and
    `apply(variables, *inputs, training=False, rng=None) ->
    (output, new_state)`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._explicit_name = name is not None
        self.name = name or f"{type(self).__name__}_{next(_id_counter)}"
        self._variables: Optional[Dict[str, Any]] = None

    @property
    def training(self) -> _Mode:
        return _Mode(self, self.__dict__.get("_training", True))

    @training.setter
    def training(self, mode: bool) -> None:
        # torch.nn.Module.__init__ and train(mode) set the mode here
        self.__dict__["_training"] = bool(mode)

    def is_training(self) -> bool:
        return self.__dict__.get("_training", True)

    # ---------------------------------------------------------- functional
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
        return {}

    def init_state(self) -> Dict[str, Any]:
        return {}

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
        """The full variable tree {'params': ..., 'state': ...}, drawn
        from `generator` (a CPU generator; default seed 0) and placed on
        `device` (None: the card)."""
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        return tree_map(lambda t: t.to(dev),
                        {"params": self.init_params(g),
                         "state": self.init_state()})

    def apply(self, variables: Dict[str, Any], *inputs,
              training: bool = False,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    def parameters(self, variables: Optional[Dict[str, Any]] = None
                   ) -> List[Tuple[str, torch.Tensor]]:
        """Flat (qualified-name, tensor) list of the trainable
        parameters in the JAX package's order (dict keys sorted)."""
        variables = variables if variables is not None else self._variables
        if variables is None:
            raise ValueError(f"{self.name}: call init()/build() first")
        return [(".".join(str(k) for k in path), leaf)
                for path, leaf in tree_leaves_with_path(variables["params"])]

    def get_parameters(self, variables: Optional[Dict[str, Any]] = None
                       ) -> torch.Tensor:
        """Every trainable parameter flattened into one vector, in
        `parameters()` order (reference: Module.getParameters)."""
        leaves = [t.reshape(-1) for _, t in self.parameters(variables)]
        return torch.cat(leaves) if leaves \
            else torch.zeros((0,), dtype=torch.float32)

    # --------------------------------------------------------------- eager
    def build(self, generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> "Module":
        """Materialize variables on this object (`variables`)."""
        self._variables = self.init(generator, device)
        return self

    @property
    def variables(self) -> Dict[str, Any]:
        if self._variables is None:
            self.build()
        return self._variables

    @variables.setter
    def variables(self, v: Dict[str, Any]) -> None:
        self._variables = v

    def evaluate(self, dataset=None, methods=None, batch_size: int = 32):
        """No arguments: switch the eager facade to eval mode and return
        the module. With a dataset and validation methods: {method
        name: ValidationResult} over `dataset`. Both overloads are the
        reference's AbstractModule.evaluate."""
        if dataset is None:
            self.training = False
            return self
        from bigdl_tpu_torch.optim.evaluator import Evaluator

        return Evaluator(self).test(dataset, methods, batch_size=batch_size)

    def predict(self, dataset, batch_size: int = 32) -> torch.Tensor:
        """Batch inference over a dataset: the outputs stacked along the
        batch axis (reference: AbstractModule.predict)."""
        from bigdl_tpu_torch.optim.evaluator import Predictor

        return Predictor(self, batch_size=batch_size).predict(dataset)

    def predict_class(self, dataset, batch_size: int = 32) -> torch.Tensor:
        """Argmax class ids (reference: AbstractModule.predictClass)."""
        from bigdl_tpu_torch.optim.evaluator import Predictor

        return Predictor(self, batch_size=batch_size).predict_class(dataset)

    def forward(self, *inputs, rng: Optional[torch.Generator] = None):
        """Eager forward: `apply` over the stored variables (built on
        first use, on the card unless `build(device=...)` placed them)
        in the module's mode, the new state stored back."""
        out, new_state = self.apply(self.variables, *inputs,
                                    training=self.is_training(), rng=rng)
        self._variables = {"params": self._variables["params"],
                           "state": new_state}
        return out

    def __call__(self, *args, **kwargs):
        """Graph wiring when every argument is a `Node`; otherwise
        torch's own call, which runs the eager `forward`."""
        from bigdl_tpu_torch.nn.graph import Node  # graph imports module

        if args and all(isinstance(a, Node) for a in args):
            return Node.wire(self, args)
        return super().__call__(*args, **kwargs)

    def set_name(self, name: str) -> "Module":
        self._record_mutation("set_name", name)
        self.name = name
        self._explicit_name = True
        return self

    def key_name(self) -> str:
        """The name a container keys this module's variables by: the
        explicit name if one was set, else the bare class name (never
        the auto-generated, counter-carrying `name`), so two builds of
        one architecture give the same tree keys."""
        return self.name if self._explicit_name else type(self).__name__

    def _apply(self, fn, recurse=True):
        # behind .to/.cuda/.cpu/.float/...: they would move no variable
        raise TypeError(f"{self.name}: a port module holds no tensors; "
                        "move its variables with models.convert.tree_map")

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class Criterion(_SpecCaptured):
    """Loss-function base: pure and parameter-free,
    `loss = criterion(input, target)`; its gradient is autograd's."""

    size_average: bool = True

    def forward(self, input, target) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, input, target) -> torch.Tensor:
        return self.forward(input, target)

    def __repr__(self):
        return f"{type(self).__name__}()"
