"""The port's model-import and UDF examples (bigdl_tpu_torch/examples/
load_caffe_model.py, load_tensorflow_model.py, udf_predictor.py) against
the JAX examples, on the CPU. Each is a pure function of its weights:
the JAX example runs in this process with its output captured, the
variables it exported (or served) are recorded and carried into the
port's same steps through models/convert.variables_from_jax.

Tolerances (fp32, the same weights): the imported models' outputs
within 1e-5 absolute, the TF import's gradients within 1e-5 absolute,
the UDF's predicted classes equal; the printed lines equal.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import evaluator as jax_evaluator
from bigdl_tpu.utils import tf as jax_tf
from bigdl_tpu.utils.caffe import loader as jax_caffe
from bigdl_tpu_torch.examples import (load_caffe_model,
                                      load_tensorflow_model, udf_predictor)
from bigdl_tpu_torch.models.convert import variables_from_jax

import test_torch_examples_common as common
import test_torch_examples_ranks as ranks


def _record(monkeypatch, owner, name):
    """Record the arguments of each call of owner.name."""
    calls = []
    fn = getattr(owner, name)

    def patched(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, patched)
    return calls


def _port(variables):
    return variables_from_jax(jax.device_get(variables), device="cpu")


def test_load_caffe_model(monkeypatch, tmp_path):
    # the model file the JAX example writes is read after it
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    exported = _record(monkeypatch, jax_caffe, "persist")
    _, jax_out = common.run_jax_example("load_caffe_model", scratch=False)
    _, _, module, variables = exported[0][:4]
    jmodel, jparams = jax_caffe.load(*exported[0][:2])
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    want, _ = jmodel.apply(jparams, x, training=False)
    _, _, got = load_caffe_model.round_trip(
        load_caffe_model.build_model(), _port(variables),
        torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    _, out = ranks.run_example("load_caffe_model", ranks.no_patch())
    assert out == jax_out


def test_load_tensorflow_model(monkeypatch, tmp_path):
    # the model file the JAX example writes is read after it
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    saved = _record(monkeypatch, jax_tf, "save")
    _, jax_out = common.run_jax_example("load_tensorflow_model", scratch=False)
    _, variables, path = saved[0][:3]
    jmodel, jparams = jax_tf.load(path)
    x = jnp.asarray(np.random.RandomState(0).rand(2, 28, 28, 1),
                    jnp.float32)
    y = jnp.asarray([1, 2], jnp.int32)
    want, _ = jmodel.apply(jparams, x, training=False)

    def loss(p):
        o, _ = jmodel.apply({"params": p, "state": jparams["state"]}, x,
                            training=False)
        return jnn.ClassNLLCriterion()(o, y)

    want_grads = jax.tree_util.tree_leaves(jax.grad(loss)(
        jparams["params"]))
    _, got, grads = load_tensorflow_model.round_trip(
        load_tensorflow_model.build_model(), _port(variables),
        torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    _, out = ranks.run_example("load_tensorflow_model", ranks.no_patch())
    assert out == jax_out


def test_udf_predictor(monkeypatch):
    served = _record(monkeypatch, jax_evaluator.Predictor, "__init__")
    jax_df, jax_out = common.run_jax_example("udf_predictor")
    model = udf_predictor.build_model()
    model.variables = _port(served[0][1].variables)
    df = udf_predictor.classify_frame(model.evaluate())
    assert [int(p) for p in df["predicted"]] == \
        [int(p) for p in jax_df["predicted"]]
    df, out = ranks.run_example("udf_predictor", ranks.no_patch())
    assert len(out.splitlines()) == len(jax_out.splitlines()) == 6
    assert all(line.startswith(f"row {i}: class ")
               for i, line in enumerate(out.splitlines()))
