"""The port's distributed_data_parallel example against the JAX
example, on the CPU: in one process at world size 1 and on 2 spawned
gloo ranks (test_torch_examples_ranks.rank_ddp), against the JAX
example on 1 and 2 CPU devices, each from the JAX example's initial
LeNet weights. Both send gradients on the bf16 wire; tolerance: the
trained parameters within 2e-3 absolute (64 SGD steps with momentum;
the wire may round a gradient element the other way where the two
frameworks' fp32 gradients differ in their last bits)."""

import numpy as np

from bigdl_tpu_torch.parallel.launch import spawn

import test_torch_examples_common as common
import test_torch_examples_ranks as ranks


def _jax_run(monkeypatch, devices):
    trees = common.record_jax_inits(monkeypatch)
    trained, out = common.run_jax_example("distributed_data_parallel",
                                          devices=devices)
    flat = np.concatenate([np.ravel(np.asarray(a, np.float32)) for _, a in
                           trained.parameters()])
    return trees, flat, out


def test_world_size_1_in_one_process(monkeypatch):
    trees, want, jax_out = _jax_run(monkeypatch, 1)
    model, out = ranks.run_example("distributed_data_parallel",
                                   ranks.carried_optimizers(trees))
    assert out == jax_out == "trained with ZeRO-1 DP over 1 devices\n"
    np.testing.assert_allclose(ranks.flat_params(model), want, rtol=0,
                               atol=2e-3)


def test_two_ranks(monkeypatch, tmp_path):
    trees, want, jax_out = _jax_run(monkeypatch, 2)
    out = spawn(ranks.rank_ddp, 2, str(tmp_path), trees, timeout=120)
    for flat, text in out:
        assert text == jax_out == "trained with ZeRO-1 DP over 2 devices\n"
        np.testing.assert_array_equal(flat, out[0][0])
    np.testing.assert_allclose(out[0][0], want, rtol=0, atol=2e-3)
