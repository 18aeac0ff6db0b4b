"""Module (architecture + weights) serialization.

Ports bigdl_tpu/serialization/module_serializer.py (reference:
utils/serializer/ModuleSerializer.scala, ModuleLoader, ModulePersister).
The architecture spec is derived from the constructor arguments every
Module and Criterion captures (nn/module.py) plus the replayed mutators,
emitted as JSON; the weights ride the npz + manifest container of
checkpoints (serialization/checkpoint.py). `Graph` DAGs are a node
table with input indices.

The on-disk format is the JAX package's, both ways. Class refs stay
under ``bigdl_tpu.`` — a port class is written as the reference class
it ports (``bigdl_tpu_torch.nn.linear:Linear`` as
``bigdl_tpu.nn.linear:Linear``), and a ref is resolved to its
counterpart under ``bigdl_tpu_torch.``, importing nothing else; so the
JAX package loads a module the port wrote and the port loads one the
JAX package wrote. Every port class lives in the file of the class it
ports (tests/test_torch_module_serializer.py holds the whole catalog to
it), so a ref maps to its port by its module path alone. Loading
imports only classes defined in the port: a spec cannot name arbitrary
importables.

`load_module` places the weights on `device` (None: the card).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.serialization.checkpoint import load_pytree, save_pytree
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

FORMAT_VERSION = 1
_ALLOWED_PREFIX = "bigdl_tpu."     # the refs on disk
_PORT_PREFIX = "bigdl_tpu_torch."  # where they resolve here


def _class_ref(cls) -> str:
    """The reference ref a port class is written as."""
    mod = cls.__module__
    if not mod.startswith(_PORT_PREFIX):
        raise ValueError(
            f"cannot serialize {cls!r}: class lives outside bigdl_tpu_torch "
            f"({mod}) — register a bigdl_tpu_torch subclass instead")
    return f"{_ALLOWED_PREFIX}{mod[len(_PORT_PREFIX):]}:{cls.__qualname__}"


def _resolve(ref: str):
    """The port class of a reference ref."""
    mod, _, qual = ref.partition(":")
    if not (mod + ".").startswith(_ALLOWED_PREFIX):
        raise ValueError(f"refusing to import {ref!r} (outside bigdl_tpu)")
    obj = importlib.import_module(_PORT_PREFIX + mod[len(_ALLOWED_PREFIX):])
    for part in qual.split("."):
        # every step must stay on classes DEFINED in the port, so a
        # crafted spec cannot walk through a module-level import (e.g.
        # `module:os.system`) into arbitrary callables
        obj = getattr(obj, part)
        if not (isinstance(obj, type)
                and (getattr(obj, "__module__", "") + ".").startswith(
                    _PORT_PREFIX)):
            raise ValueError(
                f"refusing to resolve {ref!r}: {part!r} is not a "
                "bigdl_tpu_torch class")
    return obj


def _encode(value) -> Any:
    """One constructor argument in JSON-able form."""
    from bigdl_tpu_torch.nn.graph import Graph, Node
    from bigdl_tpu_torch.nn.module import Criterion, Module

    if isinstance(value, Graph):
        return _encode_graph(value)
    if isinstance(value, (Module, Criterion)):
        return {"__kind__": "module", **module_to_spec(value)}
    if isinstance(value, Node):
        raise ValueError("raw graph Nodes only appear inside Graph specs")
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"__kind__": "dataclass",
                "class": _class_ref(type(value)),
                "fields": {k: _encode(v) for k, v in
                           dataclasses.asdict(value).items()}}
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        return {"__kind__": "ndarray", "dtype": str(value.dtype),
                "data": value.tolist()}
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, tuple):
        return {"__kind__": "tuple", "items": [_encode(v) for v in value]}
    if isinstance(value, list):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        if all(isinstance(k, str) for k in value):
            return {"__kind__": "dict",
                    "items": {k: _encode(v) for k, v in value.items()}}
        # JSON would stringify other keys: keep them as encoded pairs
        return {"__kind__": "dict",
                "pairs": [[_encode(k), _encode(v)]
                          for k, v in value.items()]}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    # objects with captured constructors (initialization methods, ...);
    # constructor-less port objects rebuild with no arguments
    cls, args, kwargs = getattr(value, "_ctor", (type(value), (), {}))
    return {"__kind__": "object", "class": _class_ref(cls),
            "args": [_encode(a) for a in args],
            "kwargs": {k: _encode(v) for k, v in kwargs.items()}}


def _decode(value) -> Any:
    if isinstance(value, dict):
        kind = value.get("__kind__")
        if kind == "module":
            return spec_to_module(value)
        if kind == "graph":
            return _decode_graph(value)
        if kind == "dataclass":
            cls = _resolve(value["class"])
            return cls(**{k: _decode(v) for k, v in value["fields"].items()})
        if kind == "ndarray":
            return np.asarray(value["data"], dtype=value["dtype"])
        if kind == "tuple":
            return tuple(_decode(v) for v in value["items"])
        if kind == "dict":
            if "pairs" in value:
                return {_decode(k): _decode(v) for k, v in value["pairs"]}
            return {k: _decode(v) for k, v in value["items"].items()}
        if kind == "object":
            cls = _resolve(value["class"])
            return cls(*[_decode(a) for a in value["args"]],
                       **{k: _decode(v) for k, v in value["kwargs"].items()})
        raise ValueError(f"unknown spec kind {kind!r}")
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def _encode_graph(graph) -> Dict[str, Any]:
    """Graph → node table with input indices, plus each node's variable
    key (so that renames after wiring cannot move keys off the saved
    weights)."""
    order = graph._order
    index = {id(n): i for i, n in enumerate(order)}
    nodes = [{"module": None if n.module is None
              else module_to_spec(n.module),
              "inputs": [index[id(p)] for p in n.inputs]} for n in order]
    return {
        "__kind__": "graph",
        "class": _class_ref(type(graph)),
        "nodes": nodes,
        "input_nodes": [index[id(n)] for n in graph.input_nodes],
        "output_nodes": [index[id(n)] for n in graph.output_nodes],
        "name": graph.name if graph._explicit_name else None,
        "keys": [graph._keys.get(id(n)) for n in order],
    }


def _decode_graph(spec):
    from bigdl_tpu_torch.nn.graph import Node

    cls = _resolve(spec["class"])
    nodes: List[Node] = []
    for ns in spec["nodes"]:
        mod = None if ns["module"] is None else spec_to_module(ns["module"])
        nodes.append(Node(mod, [nodes[i] for i in ns["inputs"]]))
    graph = cls([nodes[i] for i in spec["input_nodes"]],
                [nodes[i] for i in spec["output_nodes"]],
                name=spec["name"])
    keys = spec.get("keys")
    if keys is not None:
        # `nodes` follows the saved spec's order, whatever the rebuilt
        # graph's topological order
        graph._keys = {id(n): k for n, k in zip(nodes, keys)
                       if k is not None}
    return graph


def module_to_spec(module) -> Dict[str, Any]:
    """The architecture of a module as a JSON-able dict."""
    from bigdl_tpu_torch.nn.graph import Graph

    if isinstance(module, Graph):
        return _encode_graph(module)
    cls, args, kwargs = getattr(module, "_ctor", (type(module), (), {}))
    spec: Dict[str, Any] = {
        "class": _class_ref(cls),
        "args": [_encode(a) for a in args],
        "kwargs": {k: _encode(v) for k, v in kwargs.items()},
    }
    muts = getattr(module, "_mutations", None)
    if muts:
        spec["mutations"] = [
            {"method": m, "args": [_encode(a) for a in a_]}
            for m, a_ in muts]
    # containers key their children when they are added; a rename after
    # the add would key them otherwise on replay, so the keys persist
    keys = getattr(module, "_keys", None)
    if isinstance(keys, list):
        spec["keys"] = list(keys)
    return spec


def spec_to_module(spec: Dict[str, Any]):
    if spec.get("__kind__") == "graph":
        return _decode_graph(spec)
    cls = _resolve(spec["class"])
    module = cls(*[_decode(a) for a in spec["args"]],
                 **{k: _decode(v) for k, v in spec["kwargs"].items()})
    for mut in spec.get("mutations", ()):
        getattr(module, mut["method"])(*[_decode(a) for a in mut["args"]])
    if "keys" in spec:
        module._keys = list(spec["keys"])
    return module


def save_module(directory: str, module, variables: Optional[Dict] = None,
                name: str = "module") -> str:
    """Persist the architecture (and, given `variables`, the weights) —
    the reference's `Module.saveModule`."""
    os.makedirs(directory, exist_ok=True)
    spec = {"format_version": FORMAT_VERSION, "spec": module_to_spec(module)}
    with open(os.path.join(directory, name + ".json"), "w") as f:
        json.dump(spec, f, indent=1)
    if variables is not None:
        save_pytree(directory, name + "_vars", variables)
    return directory


def load_module(directory: str, name: str = "module",
                with_variables: bool = True, device: DeviceLike = None):
    """Inverse of save_module — the reference's `Module.loadModule`.
    Returns (module, variables), the variables on `device` (None: the
    card); variables is None when no weights were saved."""
    with open(os.path.join(directory, name + ".json")) as f:
        payload = json.load(f)
    if payload.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError("module file written by a newer format version")
    module = spec_to_module(payload["spec"])
    variables = None
    if with_variables and os.path.exists(
            os.path.join(directory, name + "_vars.json")):
        dev = resolve_device(device)
        variables, _ = load_pytree(directory, name + "_vars")
        variables = tree_map(lambda t: t.to(dev) if isinstance(
            t, torch.Tensor) else t, variables)
    return module, variables
