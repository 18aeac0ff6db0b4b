"""The port driver's `kill_resume` leg (bigdl_tpu_torch/scripts/
multihost_smoke.py) on 4 gloo processes: process 2 SIGKILLed once
checkpoint-3 publishes, every process restarted with --resume, every
sha256 equal to the uninterrupted run's. The uninterrupted run's digest
is held to the JAX script's 4-process x 2-device 12-step run from the
same initial weights (tolerance:
test_torch_multihost_reference.DIGEST_RTOL)."""

import numpy as np

from bigdl_tpu_torch.scripts import multihost_smoke

import test_torch_multihost_reference as ref


def test_kill_resume_leg_is_bit_identical(tmp_path, monkeypatch):
    init = ref.jax_init(tmp_path / "init.npz")
    out = multihost_smoke.leg_kill_resume(
        "cpu", 4, root=str(tmp_path), timeout=ref.LAUNCH_TIMEOUT, init=init)
    assert out["ok"], out
    assert out["bit_identical"]
    assert out["killed_process"] == 2
    assert out["latest_checkpoint_at_kill"] == out["resumed_from"]
    assert out["sha256_resumed"] == out["sha256_uninterrupted"]
    jax_digests, _ = ref.jax_run(monkeypatch, tmp_path / "jax",
                                 "kill_resume", 4, 2, end_iter=12)
    np.testing.assert_allclose(out["digest_uninterrupted"], jax_digests[0],
                               rtol=ref.DIGEST_RTOL)
