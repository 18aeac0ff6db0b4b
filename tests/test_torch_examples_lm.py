"""The port's language_model example (the LSTM LM on K6/K7's plain
path here) against the JAX example, on the CPU: the JAX example runs in
this process with its output captured, the port example then trains
from the JAX example's initial weights (test_torch_examples_ranks'
carried_optimizers) on the same synthetic data. Tolerance: each of the
six validation losses within 1e-4 relative (they agree to 5e-6).
"""

import numpy as np

import test_torch_examples_common as common


def check_lm_validations(monkeypatch, name):
    jax_val, _, port_val, _, _ = common.train_both(monkeypatch, name)
    assert len(port_val) == 6
    got = [v["Loss"][0] for v in port_val]
    want = [v["Loss"][0] for v in jax_val]
    assert [v["Loss"][1] for v in port_val] == \
        [v["Loss"][1] for v in jax_val]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_language_model_validations(monkeypatch):
    check_lm_validations(monkeypatch, "language_model")
