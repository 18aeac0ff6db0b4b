"""The port driver's `zero2_resume` leg (bigdl_tpu_torch/scripts/
multihost_smoke.py) on 2 gloo processes: ZeRO-2 with sharded
asynchronous saves, process 1 SIGKILLed once checkpoint-3's MANIFEST
publishes, the restart bit-identical. The first checkpoint holds one
shard unit a process. The uninterrupted run's digest is held to the JAX
script's 2-process x 4-device ZeRO-2 run from the same initial weights
(tolerance: test_torch_multihost_reference.DIGEST_RTOL)."""

import numpy as np

from bigdl_tpu_torch.scripts import multihost_smoke

import test_torch_multihost_reference as ref


def test_zero2_resume_leg_is_bit_identical(tmp_path, monkeypatch):
    init = ref.jax_init(tmp_path / "init.npz")
    out = multihost_smoke.leg_zero2_resume(
        "cpu", 2, root=str(tmp_path), timeout=ref.LAUNCH_TIMEOUT, init=init)
    assert out["ok"], out
    assert out["bit_identical"]
    assert out["killed_process"] == 1
    assert out["shard_units_in_first_ckpt"] == 2
    assert "checkpoint-3" in out["sharded_checkpoints_at_kill"]
    assert out["sha256_resumed"] == out["sha256_uninterrupted"]
    jax_digests, _ = ref.jax_run(monkeypatch, tmp_path / "jax",
                                 "kill_resume", 2, 4, end_iter=12,
                                 zero2=True)
    np.testing.assert_allclose(out["digest_uninterrupted"], jax_digests[0],
                               rtol=ref.DIGEST_RTOL)
