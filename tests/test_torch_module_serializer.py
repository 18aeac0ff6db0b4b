"""The port's module serializer (bigdl_tpu_torch/serialization/
module_serializer.py) over the whole layer catalog of
tests/test_serializer_catalog.py, against the JAX package's.

Each catalog entry is built twice from its own builder — once over the
JAX package's `nn`, once over the port's (the builder's `nn` and `T`
rebound) — with the same seeded weights (shapes from
`jax.eval_shape(module.init, key)`, filled from numpy, carried across
by `models/convert.variables_from_jax`) and fed the catalog's inputs:

* JAX save -> port load: the port's loaded module on the loaded weights
  against the JAX module's output, fp32 within rtol 1e-4, atol 1e-5
  (two frameworks' sums in different orders);
* port save -> JAX load: the JAX package's loaded module against the
  port's output, same tolerance;
* port save -> port load: bitwise.

Criterions go through the spec both ways (they hold no weights). The
file format is one: class refs stay under `bigdl_tpu.`; a spec naming
anything else, or walking through a module-level import, is refused.
The second half of the catalog is tests/test_torch_module_serializer_b.py
(each file under 30 s on one core)."""

import json
import types

import jax
import numpy as np
import pytest
import torch

import test_serializer_catalog as cat
from bigdl_tpu.serialization import module_serializer as jms
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import variables_from_jax
from bigdl_tpu_torch.serialization import module_serializer as tms
from bigdl_tpu_torch.utils.table import T as TT
from bigdl_tpu_torch.utils.table import Table as TTable, sort_key

KEY = jax.random.PRNGKey(3)
FWD = dict(rtol=1e-4, atol=1e-5)
NAMES = sorted(cat.CANON)
HALF = len(NAMES) // 2


def port_builder(fn):
    """The catalog builder `fn` with its `nn` and `T` the port's."""
    g = dict(fn.__globals__, nn=tnn, T=TT)
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def seeded(module, seed=0):
    """Seeded numpy leaves in the shapes and dtypes of the JAX module's
    variable tree (running variances in [0.5, 1.5), integer leaves in
    [-127, 127])."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(path[-1].key) if path else ""
        if np.issubdtype(a.dtype, np.integer):
            return rng.randint(-127, 128, a.shape).astype(a.dtype)
        if name == "running_var":
            return (0.5 + rng.rand(*a.shape)).astype(a.dtype)
        return (rng.randn(*a.shape) * 0.5).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(module.init, KEY))


def to_port(x):
    """A catalog input (jnp arrays, tuples, JAX Tables) for the port."""
    if isinstance(x, JTable):
        return TTable({k: to_port(v) for k, v in x.items()})
    if isinstance(x, (tuple, list)):
        return type(x)(to_port(v) for v in x)
    return torch.from_numpy(np.array(x))


def leaves(out):
    """The arrays of an output (tensor, tuple, list or Table), in
    order."""
    if isinstance(out, dict):
        return [a for k in sorted(out, key=sort_key)
                for a in leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for v in out for a in leaves(v)]
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    return [np.asarray(out)]


def assert_close(got, want, exact=False):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **FWD)


def module_case(tmp_path, name):
    build, inputs = cat.CANON[name]
    jm = build()
    jv = seeded(jm)
    tm = port_builder(build)()
    tv = variables_from_jax(jv, device="cpu")
    tin = to_port(inputs)
    tout, _ = tm.apply(tv, *tin, training=False)
    # JAX save -> port load
    jms.save_module(str(tmp_path / "jax"), jm, variables=jv)
    loaded, lv = tms.load_module(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is type(tm)
    jout, _ = jm.apply(jv, *inputs, training=False)
    assert_close(loaded.apply(lv, *tin, training=False)[0], jout)
    # port save -> port load (bitwise) and -> JAX load
    tms.save_module(str(tmp_path / "port"), tm, variables=tv)
    again, av = tms.load_module(str(tmp_path / "port"), device="cpu")
    assert_close(again.apply(av, *tin, training=False)[0], tout, exact=True)
    jl, jlv = jms.load_module(str(tmp_path / "port"))
    assert type(jl) is type(jm)
    assert_close(tout, jl.apply(jlv, *inputs, training=False)[0])


@pytest.mark.parametrize("name", NAMES[:HALF])
def test_module_moves_both_ways(tmp_path, name):
    module_case(tmp_path, name)


@pytest.mark.parametrize("name", sorted(cat.CANON_CRIT))
def test_criterion_spec_moves_both_ways(name):
    build, (inp, tgt) = cat.CANON_CRIT[name]
    jc = build()
    tc = port_builder(build)()
    want = float(jc(inp, tgt))
    tin, ttgt = to_port(inp), to_port(tgt)
    from_jax = tms.spec_to_module(json.loads(json.dumps(
        jms.module_to_spec(jc))))
    assert type(from_jax) is type(tc)
    np.testing.assert_allclose(float(from_jax(tin, ttgt)), want, **FWD)
    spec = json.loads(json.dumps(tms.module_to_spec(tc)))
    assert spec == json.loads(json.dumps(jms.module_to_spec(jc)))
    jl = jms.spec_to_module(spec)
    assert type(jl) is type(jc)
    np.testing.assert_allclose(float(jl(inp, tgt)), float(tc(tin, ttgt)),
                               **FWD)
    assert float(tms.spec_to_module(spec)(tin, ttgt)) \
        == float(tc(tin, ttgt))


def test_the_port_catalog_is_the_reference_catalog():
    """Every class the JAX catalog discovers has a port class of the
    same name in the same file, and the port writes the JAX ref."""
    for name, cls in cat.discover().items():
        port_mod = cls.__module__.replace("bigdl_tpu.", "bigdl_tpu_torch.",
                                          1)
        tcls = getattr(__import__(port_mod, fromlist=[name]), name)
        ref = f"{cls.__module__}:{cls.__qualname__}"   # aliases: the class
        assert tms._class_ref(tcls) == ref
        assert tms._resolve(ref) is tcls


def test_spec_outside_the_package_is_refused(tmp_path):
    with pytest.raises(ValueError, match="outside bigdl_tpu"):
        tms.spec_to_module({"class": "os:system", "args": [], "kwargs": {}})
    # bigdl_tpu_torch.nn.linear imports torch: a ref may not walk it
    with pytest.raises(ValueError, match="not a bigdl_tpu_torch class"):
        tms.spec_to_module({"class": "bigdl_tpu.nn.linear:torch.nn.Linear",
                            "args": [], "kwargs": {}})
    with pytest.raises(ValueError, match="outside bigdl_tpu_torch"):
        tms.module_to_spec(torch.nn.Linear(2, 2))
    tms.save_module(str(tmp_path), tnn.Linear(3, 2))
    spec = json.loads((tmp_path / "module.json").read_text())
    assert spec["spec"]["class"] == "bigdl_tpu.nn.linear:Linear"
    spec["format_version"] = 99
    (tmp_path / "module.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="newer format"):
        tms.load_module(str(tmp_path), device="cpu")


def test_mutations_and_keys_replay(tmp_path):
    """set_name after add, ceil and a post-hoc add replay on load, with
    the saved child keys, in both packages."""
    m = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU())
    m.add(tnn.SpatialMaxPooling(2, 2).ceil())
    m[0].set_name("fc1")
    tms.save_module(str(tmp_path), m, variables=None)
    loaded, lv = tms.load_module(str(tmp_path), device="cpu")
    assert lv is None and loaded._keys == m._keys
    assert loaded[2].ceil_mode and loaded[0].name == "fc1"
    jl, _ = jms.load_module(str(tmp_path))
    assert jl._keys == m._keys and jl.modules[2].ceil_mode
