"""The port's text_classification and treelstm_sentiment examples
against the JAX examples, on the CPU: each JAX example runs in this
process with its output captured, the port example then trains from
the JAX example's initial weights (test_torch_examples_ranks'
carried_optimizers) on the same synthetic data. Tolerance: each
epoch's validation accuracy within 2 rows of its validation set (fp32
training of the same weights on the same batches; a row near the
decision boundary may flip, as one of 128 did in text_classification's
seventh epoch).
"""

import pytest

import test_torch_examples_common as common


@pytest.mark.parametrize("name", ["text_classification",
                                  "treelstm_sentiment"])
def test_classifier_validations(monkeypatch, name):
    jax_val, _, port_val, out, _ = common.train_both(monkeypatch, name)
    assert len(port_val) == 8 and out == ""
    common.accuracies_agree(jax_val, port_val)
    assert port_val[-1]["Top1Accuracy"][0] >= 0.9
