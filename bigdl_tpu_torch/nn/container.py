"""Containers: `Container` and `Sequential`.

Ports those two classes of bigdl_tpu/nn/container.py (reference:
nn/Container.scala, nn/Sequential.scala). Child variables sit under
`f"{i}_{child.key_name()}"`, the JAX package's keys, so a JAX tree
lines up leaf for leaf. Children draw their weights from the
container's generator folded with their index (`_fold_rng`), the
counterpart of `jax.random.fold_in`. The table containers (Concat,
ConcatTable, ParallelTable, MapTable, Bottle) come with the slices
that use them (ROADMAP.md queue A.4).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.module import Module, _fold_rng


class Container(Module):
    """Base container (reference: nn/Container.scala#Container.modules)."""

    def __init__(self, *modules: Module, name: Optional[str] = None):
        super().__init__(name=name)
        self.modules_: List[Module] = []
        self._keys: List[str] = []
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
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
