"""The port driver's `smoke` leg (bigdl_tpu_torch/scripts/
multihost_smoke.py) on 2 gloo processes, held to the JAX script's
2-process x 4-device smoke run from the same initial weights
(tolerance: test_torch_multihost_reference.DIGEST_RTOL)."""

import numpy as np

from bigdl_tpu_torch.scripts import multihost_smoke

import test_torch_multihost_reference as ref


def test_smoke_leg_matches_the_jax_smoke_digests(tmp_path, monkeypatch):
    init = ref.jax_init(tmp_path / "init.npz")
    out = multihost_smoke.leg_smoke("cpu", 2, root=str(tmp_path),
                                    timeout=ref.LAUNCH_TIMEOUT, init=init)
    assert out["ok"], out
    assert out["return_codes"] == [0, 0]
    assert len(set(out["digests"])) == 1
    jax_digests, _ = ref.jax_run(monkeypatch, tmp_path / "jax", "smoke",
                                 2, 4)
    assert len(set(jax_digests)) == 1
    np.testing.assert_allclose(out["digests"][0], jax_digests[0],
                               rtol=ref.DIGEST_RTOL)
