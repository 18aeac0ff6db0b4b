"""Shared interop helpers: flatten a module tree into a linear op list,
and gather an imported graph's variables.

Ports bigdl_tpu/utils/interop.py (used by the Caffe and TensorFlow
persisters; reference: the per-format `Converter` hierarchies under
utils/caffe/ and utils/tf/ walk the module graph the same way). The
port's containers hold their children as `modules_`. `graph_variables`
is port-only: the JAX loaders draw `graph.init(...)` for every node and
overwrite the imported ones.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.module import Module, _fold_rng


def linearize(module: Module, variables: Dict[str, Any],
              n_inputs: int = 1) -> Tuple[List[Tuple[Module, Dict, List[int]]],
                                          List[int]]:
    """Flatten nested Sequential/Graph containers into a topo-ordered list
    of (leaf module, its variables, input entry ids). Entry id -1..-n are
    the graph inputs (-1 is the first); returns (entries, output_ids)."""
    entries: List[Tuple[Module, Dict, List[int]]] = []

    def walk(mod: Module, v: Dict[str, Any], in_ids: List[int]) -> List[int]:
        if isinstance(mod, Graph):
            id_of: Dict[int, List[int]] = {}
            if len(mod.input_nodes) == 1:
                id_of[id(mod.input_nodes[0])] = list(in_ids)
            else:
                for inp_node, gid in zip(mod.input_nodes, in_ids):
                    id_of[id(inp_node)] = [gid]
            for node in mod._order:
                if node.module is None:
                    continue
                key = mod._keys[id(node)]
                parent_ids = []
                for p in node.inputs:
                    parent_ids.extend(id_of[id(p)])
                sub_v = {"params": v["params"][key],
                         "state": v["state"][key]}
                id_of[id(node)] = walk(node.module, sub_v, parent_ids)
            outs = []
            for n in mod.output_nodes:
                outs.extend(id_of[id(n)])
            return outs
        if isinstance(mod, nn.Sequential):
            cur = in_ids
            for k, m in zip(mod._keys, mod.modules_):
                sub_v = {"params": v["params"][k],
                         "state": v["state"][k]}
                cur = walk(m, sub_v, cur)
            return cur
        eid = len(entries)
        entries.append((mod, v, list(in_ids)))
        return [eid]

    out_ids = walk(module, variables, [-(i + 1) for i in range(n_inputs)])
    return entries, out_ids


def graph_variables(graph: Graph, node_vars: Dict[int, Dict[str, Any]],
                    device: torch.device) -> Dict[str, Any]:
    """An imported graph's variables on `device`: each converted node's
    own (host arrays, keyed by `id(node)`; their state over the module's
    initial state), and for every other node the draws `graph.init`
    (seed 0) gives it — only those are drawn, so importing VGG-16 draws
    nothing."""
    g = torch.Generator().manual_seed(0)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for i, n in enumerate(graph._order):
        if n.module is None:
            continue
        key = graph._keys[id(n)]
        if key in params:
            continue
        v = node_vars.get(id(n))
        state[key] = n.module.init_state()
        if v is None:
            params[key] = n.module.init_params(_fold_rng(g, i))
        else:
            params[key] = v["params"]
            state[key].update(v["state"])

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)

    return tree_map(put, {"params": params, "state": state})
