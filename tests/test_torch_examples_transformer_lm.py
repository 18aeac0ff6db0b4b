"""The port's transformer_lm example against the JAX example on the
CPU, from the JAX example's initial weights (as
test_torch_examples_lm.py holds the LSTM LM): the six validation losses
within 1e-4 relative (they agree to 1.5e-5)."""

from test_torch_examples_lm import check_lm_validations


def test_transformer_lm_validations(monkeypatch):
    check_lm_validations(monkeypatch, "transformer_lm")
