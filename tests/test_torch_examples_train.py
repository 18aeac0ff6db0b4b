"""The port's lenet_local_train, transfer_learning and
recommendation_ncf examples against the JAX examples, on the CPU: each
JAX example runs in this process with its output captured, the port
example then trains from the JAX example's initial weights
(test_torch_examples_ranks' carried_optimizers) on the same synthetic
data, and the metric each one prints or validates is held to the JAX
example's. Tolerances: an accuracy within 2 rows of its validation set
(fp32 training of the same weights on the same batches); NCF's NDCG
within 1e-3.
"""

import test_torch_examples_common as common


def test_lenet_local_train(monkeypatch, tmp_path):
    jax_val, _, port_val, out, _ = common.train_both(
        monkeypatch, "lenet_local_train",
        ["--checkpoint", str(tmp_path / "jax_ckpt")])
    assert len(port_val) == 3
    common.accuracies_agree(jax_val, port_val)
    assert port_val[-1]["Top1Accuracy"][0] >= 0.9
    assert out.startswith("done; checkpoints in ")


def test_transfer_learning(monkeypatch):
    _, jax_out, _, out, _ = common.train_both(monkeypatch, "transfer_learning")
    prefix = "transfer-learning accuracy:"
    (ja,), (pa,) = (common.printed_numbers(jax_out, prefix),
                    common.printed_numbers(out, prefix))
    assert abs(pa - ja) <= 2 / 256
    assert pa >= 0.9


def test_recommendation_ncf(monkeypatch):
    _, jax_out, _, out, _ = common.train_both(monkeypatch,
                                              "recommendation_ncf")
    for key, tol in (("Top1Accuracy", 2 / 256), ("HitRatio@2", 2 / 256),
                     ("NDCG@2", 1e-3)):
        (jv,), (pv,) = (common.printed_numbers(jax_out, key + " "),
                        common.printed_numbers(out, key + " "))
        assert abs(pv - jv) <= tol, (key, pv, jv)
