"""The port driver's `ckpt_corrupt` leg (bigdl_tpu_torch/scripts/
multihost_smoke.py) on 4 gloo processes: the job killed once
checkpoint-6 publishes, its model.npz truncated to half; every process
skips it, resumes from checkpoint-3 and ends bit-identical to the
uninterrupted run."""

from bigdl_tpu_torch.scripts import multihost_smoke

import test_torch_multihost_reference as ref


def test_ckpt_corrupt_leg_falls_back_and_is_bit_identical(tmp_path):
    out = multihost_smoke.leg_ckpt_corrupt(
        "cpu", 4, root=str(tmp_path), timeout=ref.LAUNCH_TIMEOUT)
    assert out["ok"], out
    assert out["corrupted"] == "checkpoint-6"
    assert out["resumed_from"] == "checkpoint-3"
    assert out["fell_back_on_every_process"]
    assert out["bit_identical"]
    assert out["sha256_resumed"] == out["sha256_uninterrupted"]
