"""Static DAG graph container.

Ports bigdl_tpu/nn/graph.py (reference: nn/Graph.scala,
nn/StaticGraph.scala, `Input()`, node wiring, topological execution
over utils/DirectedGraph.scala). Calling a port module on `Node`s
wires it (`nn.module.Module.__call__`); its backward is autograd's over
the forward::

    x = Input()
    h = Linear(784, 100)(x)
    y = LogSoftMax()(ReLU()(h))
    model = Graph(x, y)

The JAX package's keys are kept: a node's variables live under
`f"{i}_{module.key_name()}"`, `i` its position in the topological
order (Input nodes included), so a JAX Graph's tree carries across
unchanged. Nodes wired with the same module object share one entry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from bigdl_tpu_torch.nn.module import Module, _fold_rng
from bigdl_tpu_torch.utils.table import T


class Node:
    """A wiring node: a module plus its input nodes
    (reference: utils/Node.scala wrapped by nn/Graph)."""

    def __init__(self, module: Optional[Module],
                 inputs: Sequence["Node"] = ()):
        self.module = module
        self.inputs: List[Node] = list(inputs)

    @staticmethod
    def wire(module: Module, inputs: Sequence["Node"]) -> "Node":
        return Node(module, inputs)

    def __repr__(self):
        return f"Node({self.module!r}, n_in={len(self.inputs)})"


def Input() -> Node:
    """Placeholder input node (reference: nn/Input.scala)."""
    return Node(None, ())


class Graph(Module):
    """Execute a DAG of modules in topological order
    (reference: nn/StaticGraph.scala#StaticGraph.updateOutput)."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]],
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_nodes = [inputs] if isinstance(inputs, Node) \
            else list(inputs)
        self.output_nodes = [outputs] if isinstance(outputs, Node) \
            else list(outputs)
        self._order = self._topo_sort()
        # weight sharing: nodes wired with the same module object share
        # one entry, keyed at its first position
        self._keys: Dict[int, str] = {}
        seen_modules: Dict[int, str] = {}
        for i, node in enumerate(self._order):
            if node.module is None:
                continue
            key = seen_modules.setdefault(
                id(node.module), f"{i}_{node.module.key_name()}")
            self._keys[id(node)] = key

    def _topo_sort(self) -> List[Node]:
        """Post-order of an iterative depth-first walk from the outputs
        (no recursion limit on deep graphs); raises on a cycle and on an
        input that no output reaches."""
        order, seen = [], set()
        for out in self.output_nodes:
            if id(out) in seen:
                continue
            stack = [(out, iter(out.inputs))]
            path = {id(out)}
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    stack.pop()
                    path.discard(id(node))
                    if id(node) not in seen:
                        seen.add(id(node))
                        order.append(node)
                elif id(nxt) not in seen:
                    if id(nxt) in path:
                        raise ValueError("Graph contains a cycle")
                    stack.append((nxt, iter(nxt.inputs)))
                    path.add(id(nxt))
        for inp in self.input_nodes:
            if id(inp) not in seen:
                raise ValueError("Graph input is not connected to any output")
        return order

    def init_params(self, generator: Optional[torch.Generator] = None):
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        out = {}
        for i, n in enumerate(self._order):
            if n.module is None:
                continue
            key = self._keys[id(n)]
            if key not in out:  # a shared module draws once
                out[key] = n.module.init_params(_fold_rng(g, i))
        return out

    def init_state(self):
        out = {}
        for n in self._order:
            if n.module is not None:
                key = self._keys[id(n)]
                if key not in out:
                    out[key] = n.module.init_state()
        return out

    def apply(self, variables, *inputs, training=False, rng=None):
        if len(inputs) == 1 and isinstance(inputs[0], (tuple, list)):
            inputs = tuple(inputs[0])
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"Graph expects {len(self.input_nodes)} "
                             f"inputs, got {len(inputs)}")
        values: Dict[int, Any] = {id(n): x
                                  for n, x in zip(self.input_nodes, inputs)}
        new_state: Dict[str, Any] = {}
        for i, node in enumerate(self._order):
            if node.module is None:
                if id(node) not in values:
                    raise ValueError("Unbound Input node in graph")
                continue
            args = [values[id(p)] for p in node.inputs]
            if len(args) > 1:
                args = [T(*args)]
            key = self._keys[id(node)]
            # a shared module's later occurrence starts from the state
            # its earlier one left in this pass, so running statistics
            # chain instead of the last application overwriting the first
            child_vars = {"params": variables["params"][key],
                          "state": new_state.get(key,
                                                 variables["state"][key])}
            out, s = node.module.apply(child_vars, *args, training=training,
                                       rng=_fold_rng(rng, i))
            values[id(node)] = out
            new_state[key] = s
        outs = [values[id(n)] for n in self.output_nodes]
        return (outs[0] if len(outs) == 1 else T(*outs)), new_state
