"""Each port example (bigdl_tpu_torch/examples/, one for each file of
the JAX repository's examples/) is there, runs as `python -m
bigdl_tpu_torch.examples.<name>`, and defaults to the CUDA card: with no
card, `main([])` raises and never falls back to the CPU."""

import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
               if f.endswith(".py"))


def test_one_port_example_for_each_jax_example():
    port = sorted(f[:-3] for f in os.listdir(
        os.path.join(REPO, "bigdl_tpu_torch", "examples"))
        if f.endswith(".py") and not f.startswith("_"))
    assert port == NAMES and len(NAMES) == 15


@pytest.mark.parametrize("name", NAMES)
def test_defaults_to_the_card(name):
    mod = importlib.import_module(f"bigdl_tpu_torch.examples.{name}")
    assert f"examples/{name}.py" in mod.__doc__
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.examples.udf_predictor",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [line.split(":")[0] for line in proc.stdout.splitlines()] == \
        [f"row {i}" for i in range(6)]
