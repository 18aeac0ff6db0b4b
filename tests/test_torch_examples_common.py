"""Helpers for tests/test_torch_examples_*.py (no tests of its own):
run a JAX example (examples/<name>.py) in this process with its standard
output captured, record the initial weights it trains from, and read
the validation results of a JAX or port training run.

The port's examples draw their initial weights from torch generators,
the JAX package's from JAX keys; so a test carries the JAX example's
initial variables into the port example (test_torch_examples_ranks'
patches) and both then train from the same weights on the same
synthetic data.
"""

import contextlib
import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest

import test_torch_examples_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_example(name, argv=(), devices=None, scratch=True):
    """`main()` of examples/<name>.py with `argv`, on the first
    `devices` CPU devices (default: all), its temporary directories
    removed after it unless `scratch` is false: (return value,
    stdout)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    tmp = ranks.scratch_tempdir() if scratch else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, tmp, \
            contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [name, *argv])
        if devices is not None:
            every = jax.devices()
            mp.setattr(jax, "devices", lambda *a, **k: every[:devices])
            mp.setattr(jax, "device_count", lambda *a, **k: devices)
        result = mod.main()
    return result, out.getvalue()


def record_jax_inits(monkeypatch):
    """A list that gets the initial `variables` (host arrays) of every
    JAX Optimizer built from now on, in order."""
    from bigdl_tpu.optim.optimizer import Optimizer

    trees = []
    init = Optimizer.__init__

    def patched(self, model, *args, **kwargs):
        init(self, model, *args, **kwargs)
        trees.append(jax.device_get(model.variables))

    monkeypatch.setattr(Optimizer, "__init__", patched)
    return trees


def record_validations(monkeypatch, cls):
    """A list that gets {method: (value, count)} of every `_validate`
    of `cls` (a LocalOptimizer of either package) from now on."""
    seen = []
    validate = cls._validate

    def patched(self, *args):
        out = validate(self, *args)
        seen.append({k: r.result() for k, r in out.items()})
        return out

    monkeypatch.setattr(cls, "_validate", patched)
    return seen


def printed_numbers(text, prefix):
    """The numbers after `prefix` on each line that starts with it."""
    return [float(line[len(prefix):].split()[0])
            for line in text.splitlines() if line.startswith(prefix)]


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def train_both(monkeypatch, name, jax_argv=()):
    """(JAX validations, JAX stdout, port validations, port stdout,
    port result)."""
    from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocal
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

    trees = record_jax_inits(monkeypatch)
    jax_val = record_validations(monkeypatch, JaxLocal)
    _, jax_out = run_jax_example(name, jax_argv)
    port_val = record_validations(monkeypatch, LocalOptimizer)
    result, out = ranks.run_example(name, ranks.carried_optimizers(trees))
    return jax_val, jax_out, port_val, out, result


def accuracies_agree(jax_val, port_val, key="Top1Accuracy"):
    assert len(port_val) == len(jax_val) > 0
    for j, p in zip(jax_val, port_val):
        (ja, jn), (pa, pn) = j[key], p[key]
        assert pn == jn
        assert abs(pa - ja) <= 2 / jn, (jax_val, port_val)
