"""Containers.

Ports bigdl_tpu/nn/container.py (reference: nn/Container.scala,
nn/Sequential.scala, nn/Concat.scala, nn/ConcatTable.scala,
nn/ParallelTable.scala, nn/MapTable.scala, nn/Bottle.scala). Every
container keys its children's variables `f"{i}_{child.key_name()}"`,
the JAX package's keys, so a JAX tree lines up leaf for leaf. Children
draw their weights from the container's generator folded with their
index (`_fold_rng`), the counterpart of `jax.random.fold_in`. The table
containers return a `utils.table.Table` of their children's outputs.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.module import Module, _fold_rng
from bigdl_tpu_torch.utils.table import Table


class Container(Module):
    """Base container (reference: nn/Container.scala#Container.modules)."""

    def __init__(self, *modules: Module, name: Optional[str] = None):
        super().__init__(name=name)
        self.modules_: List[Module] = []
        self._keys: List[str] = []
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        self._record_mutation("add", module)
        self._keys.append(f"{len(self.modules_)}_{module.key_name()}")
        self.modules_.append(module)
        return self

    def init_params(self, generator: Optional[torch.Generator] = None):
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        return {k: m.init_params(_fold_rng(g, i))
                for i, (k, m) in enumerate(zip(self._keys, self.modules_))}

    def init_state(self):
        return {k: m.init_state() for k, m in zip(self._keys, self.modules_)}

    @staticmethod
    def _child_vars(variables, key):
        return {"params": variables["params"][key],
                "state": variables["state"][key]}

    def __getitem__(self, i: int) -> Module:
        return self.modules_[i]

    def __len__(self):
        return len(self.modules_)

    def __repr__(self):
        inner = "\n  ".join(repr(m) for m in self.modules_)
        return f"{type(self).__name__}(\n  {inner}\n)"


class Sequential(Container):
    """Feed-forward chain (reference: nn/Sequential.scala). Several
    inputs arrive at the first child as one tuple."""

    def apply(self, variables, *inputs, training=False, rng=None):
        x = inputs[0] if len(inputs) == 1 else tuple(inputs)
        new_state = {}
        for i, (k, m) in enumerate(zip(self._keys, self.modules_)):
            x, s = m.apply(self._child_vars(variables, k), x,
                           training=training, rng=_fold_rng(rng, i))
            new_state[k] = s
        return x, new_state


def _table_elems(input) -> list:
    """A table input's elements, a dict's in insertion order (the JAX
    package's ParallelTable/MapTable read `input.values()`)."""
    return list(input.values()) if isinstance(input, dict) else list(input)


class ConcatTable(Container):
    """Apply every child to the same input; the output is a Table of
    their results (reference: nn/ConcatTable.scala)."""

    def apply(self, variables, input, training=False, rng=None):
        outs, new_state = Table(), {}
        for i, (k, m) in enumerate(zip(self._keys, self.modules_)):
            o, s = m.apply(self._child_vars(variables, k), input,
                           training=training, rng=_fold_rng(rng, i))
            outs.insert(o)
            new_state[k] = s
        return outs, new_state


class ParallelTable(Container):
    """The i-th child consumes the i-th element of the input table
    (reference: nn/ParallelTable.scala)."""

    def apply(self, variables, input, training=False, rng=None):
        outs, new_state = Table(), {}
        for i, (k, m, x) in enumerate(zip(self._keys, self.modules_,
                                          _table_elems(input))):
            o, s = m.apply(self._child_vars(variables, k), x,
                           training=training, rng=_fold_rng(rng, i))
            outs.insert(o)
            new_state[k] = s
        return outs, new_state


class Concat(Container):
    """Apply every child to the input and concatenate the outputs along
    `dimension` (reference: nn/Concat.scala; 1-based, batch included)."""

    def __init__(self, dimension: int, *modules: Module,
                 name: Optional[str] = None):
        super().__init__(*modules, name=name)
        self.dimension = dimension

    def apply(self, variables, input, training=False, rng=None):
        outs, new_state = [], {}
        for i, (k, m) in enumerate(zip(self._keys, self.modules_)):
            o, s = m.apply(self._child_vars(variables, k), input,
                           training=training, rng=_fold_rng(rng, i))
            outs.append(o)
            new_state[k] = s
        return torch.cat(outs, dim=self.dimension - 1), new_state


class MapTable(Container):
    """Apply the single child, its weights shared, to every element of
    the input table (reference: nn/MapTable.scala); its state threads
    through the elements in order."""

    def apply(self, variables, input, training=False, rng=None):
        k, m = self._keys[0], self.modules_[0]
        outs = Table()
        s = variables["state"][k]
        for i, x in enumerate(_table_elems(input)):
            o, s = m.apply({"params": variables["params"][k], "state": s},
                           x, training=training, rng=_fold_rng(rng, i))
            outs.insert(o)
        return outs, {k: s}


class Bottle(Container):
    """Collapse the leading dims, apply the child, restore them
    (reference: nn/Bottle.scala)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2, name: Optional[str] = None):
        super().__init__(module, name=name)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def apply(self, variables, input, training=False, rng=None):
        k, m = self._keys[0], self.modules_[0]
        split = input.ndim - self.n_input_dim + 1
        flat = input.reshape((-1,) + tuple(input.shape[split:]))
        out, s = m.apply(self._child_vars(variables, k), flat,
                         training=training, rng=rng)
        return out.reshape(tuple(input.shape[:split])
                           + tuple(out.shape[1:])), {k: s}
