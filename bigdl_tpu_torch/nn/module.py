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
CPU, so the weights of a seed do not depend on the device) and `rng`
in `apply` is one.

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
move the variables with `models.convert.tree_map`. Not ported:
constructor capture for the
module serializer, `save_module`/`load_module`, the graph `__call__`,
`get_parameters` and the eager `forward`/`training()`/`evaluate()`/
`predict()` facade (torch's own `training` flag is left alone).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.models.convert import tree_leaves_with_path

_id_counter = itertools.count()


class Module(torch.nn.Module):
    """Base class of the port's modules. Subclasses override
    `init_params(generator) -> dict`, `init_state() -> dict` and
    `apply(variables, *inputs, training=False, rng=None) ->
    (output, new_state)`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or f"{type(self).__name__}_{next(_id_counter)}"
        self._variables: Optional[Dict[str, Any]] = None

    # ---------------------------------------------------------- functional
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Any]:
        return {}

    def init_state(self) -> Dict[str, Any]:
        return {}

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Any]:
        """The full variable tree: {'params': ..., 'state': ...}."""
        return {"params": self.init_params(generator),
                "state": self.init_state()}

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

    # --------------------------------------------------------------- eager
    def build(self, generator: Optional[torch.Generator] = None
              ) -> "Module":
        """Materialize variables on this object (`variables`)."""
        self._variables = self.init(generator)
        return self

    @property
    def variables(self) -> Dict[str, Any]:
        if self._variables is None:
            self.build()
        return self._variables

    @variables.setter
    def variables(self, v: Dict[str, Any]) -> None:
        self._variables = v

    def _apply(self, fn, recurse=True):
        # behind .to/.cuda/.cpu/.float/...: they would move no variable
        raise TypeError(f"{self.name}: a port module holds no tensors; "
                        "move its variables with models.convert.tree_map")

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class Criterion:
    """Loss-function base: pure and parameter-free,
    `loss = criterion(input, target)`; its gradient is autograd's."""

    size_average: bool = True

    def forward(self, input, target) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, input, target) -> torch.Tensor:
        return self.forward(input, target)

    def __repr__(self):
        return f"{type(self).__name__}()"
