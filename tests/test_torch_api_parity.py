"""Every public function, class and method of the JAX package
(bigdl_tpu/) has a counterpart in the port (bigdl_tpu_torch/) that
takes the JAX parameters, checked by reading both trees' sources with
`ast`: neither package is imported.

A JAX module `bigdl_tpu/<path>` is held to `bigdl_tpu_torch/<path>`.
Each of its public top-level names (functions, classes, assigned
names; not those it imports) must be defined in the port module or
imported there from a module of the port; each public method of a
public class (and `__init__`), on the class or a base the port module
can name, must exist on the port's class; and each named parameter of
a JAX function or method must be a parameter of its counterpart (or
the counterpart takes **kwargs). The exceptions are written out below,
each with its reason; a stale exception fails too, so the lists stay
as short as the gaps."""

from __future__ import annotations

import ast
import functools
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "bigdl_tpu", ROOT / "bigdl_tpu_torch"

# JAX modules with no port module, each with its reason
UNPORTED_MODULES = {
    "analysis/rules/donation_flow.py":
        "a lint rule on jax.jit buffer donation; the port has no jit",
    "analysis/rules/retrace_hazard.py":
        "a lint rule on jax.jit retracing; the port has no jit",
    "analysis/rules/trace_env_read.py":
        "a lint rule on environment reads under a jax trace",
    "parallel/shard_map_compat.py":
        "a shim over two spellings of jax's shard_map",
    "utils/envknobs.py":
        "import-time snapshots of the Pallas tile knobs, so that a jax "
        "trace cannot bake a later value in; the Hopper kernels have no "
        "tile knobs",
    "utils/tpu_probe.py":
        "a bounded-time probe of the TPU's PJRT backend",
}

# public JAX names with no counterpart in their port module (module,
# name or Class.method) and why
UNPORTED_NAMES = {
    **{("analysis/astutil.py", n):
       "a helper of the JAX-tracing lint rules (jit decorations, "
       "static_argnums tuples, traced parameters), which the port does "
       "not have" for n in ("walk_calls", "jit_decoration", "int_tuple",
                           "str_tuple", "param_names")},
    **{("analysis/project.py", n):
       "a helper of the donation-flow lint rule (jit donation, nested "
       "traced defs), which the port does not have"
       for n in ("is_donating_jit_call", "walk_skipping_nested_defs")},
    ("ops/flash_attention.py", "resolve_bwd_form"):
        "a TPU tile resolver: picks the fused or the split Pallas "
        "backward by a VMEM bound; one CUDA design serves both",
    ("ops/fused_rnn.py", "resolve_impl"):
        "picks the Mosaic kernel, interpret mode or lax.scan by TPU "
        "lane rules (H a multiple of 128, resident-weight cap); the "
        "port's wrapper picks the kernel by the tensor's device",
    ("ops/paged_decode.py", "resolve_tiles"):
        "a TPU tile resolver (block and head tiles of the Pallas grid)",
    ("utils/engine.py", "ensure_cpu_platform"):
        "selects JAX's CPU backend; the port names devices explicitly "
        "(utils/device.resolve_device)",
    ("utils/anomaly.py", "select_update"):
        "the jit-side tree_map(where(ok)) that discards a guarded "
        "update on the device; the port's eager step decides on the "
        "host after its one read",
    ("nn/sparse.py", "SparseTensor.tree_flatten"):
        "JAX pytree registration",
    ("nn/sparse.py", "SparseTensor.tree_unflatten"):
        "JAX pytree registration",
    ("serving/tp.py", "TPServingLM.place_pools"):
        "re-commits pool leaves to a jax.sharding placement after host "
        "surgery; the port's pools are this rank's own tensors",
    ("utils/caffe/bigdl_caffe_pb2.py", "DESCRIPTOR"):
        "the protobuf runtime's descriptor; the port's codec "
        "(utils/protowire.py) is schema-driven",
    ("utils/tf/bigdl_tf_pb2.py", "DESCRIPTOR"):
        "the protobuf runtime's descriptor; the port's codec "
        "(utils/protowire.py) is schema-driven",
}

# TPU tile knobs: Pallas grid cells that bind no Hopper design
TILE_KNOBS = {"block_q", "block_k", "bwd_block_k", "bwd_tiles",
              "block_tile", "head_tile"}

# a JAX parameter the port takes under another name, everywhere
RENAMED = {
    "rng": ("generator", "jax.random keys become torch.Generators"),
    "dropout_rng": ("dropout_generator",
                    "jax.random keys become torch.Generators"),
}

# one function's parameter the port takes under another name, or not
# at all (None), and why
RENAMED_AT = {
    ("serving/sampler.py", "sample_logits", "keys"):
        ("generators", "per-row PRNG keys become per-row torch.Generators"),
    ("parallel/mesh.py", "make_mesh", "devices"):
        ("device", "a JAX mesh spans one process's device list; the "
                   "port's spans processes of one device each"),
    ("serialization/checkpoint.py", "load_pytree", "as_jax"):
        ("as_torch", "the loaded leaves become tensors, not jax arrays"),
    ("utils/anomaly.py", "global_norm", "tree"):
        ("tensors", "a pytree's leaves become a sequence of tensors"),
    ("parallel/mesh.py", "host_to_global", "spec"):
        (None, "a jax PartitionSpec; the port splits along its `axis`"),
    ("parallel/mesh.py", "place_global", "spec"):
        (None, "a jax PartitionSpec; the port places by its `axis`"),
}

Node = ast.AST


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _module_file(dotted: str) -> Optional[Path]:
    base = ROOT.joinpath(*dotted.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _top_level(tree: ast.Module) -> Dict[str, Node]:
    """Name → the statement binding it at module level (defs inside a
    top-level `if`/`try` count)."""
    out: Dict[str, Node] = {}
    for node in tree.body:
        for sub in ([node] if not isinstance(node, (ast.If, ast.Try))
                    else ast.walk(node)):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                out.setdefault(sub.name, sub)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, sub)
            elif isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Name):
                out.setdefault(sub.target.id, sub)
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for a in sub.names:
                    out.setdefault((a.asname or a.name).split(".")[0], sub)
    return out


def _resolve(path: Optional[Path], name: str, depth: int = 0
             ) -> Optional[Tuple[Node, Path]]:
    """The definition of `name` in module `path`, following `from ...
    import` chains into the same repository."""
    if path is None or depth > 8:
        return None
    node = _top_level(_tree(path)).get(name)
    if isinstance(node, ast.ImportFrom):
        if node.level:
            pkg = path.parent
            for _ in range(node.level - 1):
                pkg = pkg.parent
            mod = ".".join(pkg.relative_to(ROOT).parts
                           + ((node.module,) if node.module else ()))
        else:
            mod = node.module or ""
        for a in node.names:
            if (a.asname or a.name) == name:
                return _resolve(_module_file(mod), a.name, depth + 1)
        return None
    return (node, path) if node is not None else None


def _methods(cls: ast.ClassDef, path: Path, depth: int = 0
             ) -> Dict[str, Node]:
    """A class's methods and class attributes, its bases' first (bases
    the module can name, followed into their modules)."""
    out: Dict[str, Node] = {}
    if depth > 8:
        return out
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else \
            base.attr if isinstance(base, ast.Attribute) else None
        found = _resolve(path, name) if name else None
        if found and isinstance(found[0], ast.ClassDef):
            out.update(_methods(found[0], found[1], depth + 1))
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _params(fn: Node) -> Tuple[List[str], bool]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
             if x.arg not in ("self", "cls")]
    return names, a.kwarg is not None


def _missing_params(rel: str, name: str, jfn: Node, tfn: Node
                    ) -> List[str]:
    """JAX parameters of `name` its counterpart does not take, the
    exceptions above aside."""
    if not isinstance(tfn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []                   # a class or callable object stands in
    jnames, _ = _params(jfn)
    tnames, tkw = _params(tfn)
    if tkw:
        return []
    missing = []
    for p in jnames:
        if p in tnames or p in TILE_KNOBS:
            continue
        if p in RENAMED and RENAMED[p][0] in tnames:
            continue
        at = RENAMED_AT.get((rel, name, p))
        if at is not None and (at[0] is None or at[0] in tnames):
            continue
        missing.append(p)
    return missing


def _jax_modules() -> List[str]:
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _gaps() -> Tuple[Dict[Tuple[str, str], str], set]:
    """(gaps, renames used): every public name or parameter of a ported
    JAX module its port module lacks, keyed (module, name)."""
    gaps: Dict[Tuple[str, str], str] = {}
    used = set()
    for rel in _jax_modules():
        tpath = PORT / rel
        if not tpath.exists():
            continue
        jpath = JAX / rel
        for name, node in _top_level(_tree(jpath)).items():
            if name.startswith("_") \
                    or isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            found = _resolve(tpath, name)
            if found is None:
                gaps[(rel, name)] = "missing"
                continue
            tnode, tfile = found
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                miss = _missing_params(rel, name, node, tnode)
                if miss:
                    gaps[(rel, name)] = f"lacks parameters {miss}"
                used |= {(rel, name, p) for p in _params(node)[0]}
            elif isinstance(node, ast.ClassDef) \
                    and isinstance(tnode, ast.ClassDef):
                tm = _methods(tnode, tfile)
                for mname, mnode in _methods(node, jpath).items():
                    if not isinstance(mnode, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)) \
                            or (mname.startswith("_")
                                and mname != "__init__"):
                        continue
                    key = (rel, f"{name}.{mname}")
                    if mname not in tm:
                        gaps[key] = "missing"
                        continue
                    miss = _missing_params(rel, f"{name}.{mname}", mnode,
                                           tm[mname])
                    if miss:
                        gaps[key] = f"lacks parameters {miss}"
    return gaps, used


def test_unported_modules_are_the_listed_ones():
    unported = {rel for rel in _jax_modules()
                if not (PORT / rel).exists()}
    assert unported == set(UNPORTED_MODULES)


def test_every_public_name_has_a_counterpart_taking_its_parameters():
    gaps, _ = _gaps()
    unexplained = {k: v for k, v in gaps.items()
                   if k not in UNPORTED_NAMES}
    assert not unexplained, "\n".join(
        f"bigdl_tpu/{m}: {n} {why}" for (m, n), why in
        sorted(unexplained.items()))


def test_exceptions_are_current_and_reasoned():
    """Every listed exception still names a gap (a closed gap leaves
    the list), and every one has its reason."""
    gaps, used = _gaps()
    assert all(gaps.get(k) == "missing" for k in UNPORTED_NAMES), \
        sorted(k for k in UNPORTED_NAMES if gaps.get(k) != "missing")
    assert all(k in used for k in RENAMED_AT), \
        sorted(k for k in RENAMED_AT if k not in used)
    for why in (*UNPORTED_MODULES.values(), *UNPORTED_NAMES.values(),
                *(r for _, r in RENAMED.values()),
                *(r for _, r in RENAMED_AT.values())):
        assert isinstance(why, str) and len(why) > 20


@pytest.mark.parametrize("rel,name,params", [
    ("models/transformer.py", "TransformerLM.init_cache",
     ["batch", "max_len", "dtype"]),
    ("models/transformer.py", "TransformerLM.prefill",
     ["variables", "tokens", "cache", "lengths"]),
    ("models/transformer.py", "TransformerLM.decode_step",
     ["variables", "tokens", "pos", "cache"]),
    ("analysis/engine.py", "lint_file", ["root", "rel_path", "rules"]),
])
def test_the_last_ported_names_take_the_jax_parameters(rel, name, params):
    """The dense-cache decode trio and `lint_file`, in the JAX order."""
    cls, _, meth = name.rpartition(".")
    found = _resolve(PORT / rel, cls or meth)
    assert found is not None
    node = _methods(*found)[meth] if cls else found[0]
    assert _params(node)[0][:len(params)] == params
