"""Port re-enactments of scripts/fault_drill.py's training legs.

Each leg runs twice: as the JAX package runs it, and on the port — the
same leg code from a second copy of the drill module, its `_train`
replaced by tests/test_torch_training_drills_ranks.py's `port_train`
(the same MLP, data and calls through bigdl_tpu_torch, the JAX model's
initial weights carried in) and its `bigdl_tpu.obs` and
`bigdl_tpu.utils.faults` resolved to the port's. The leg's own gates
must pass on the port (`ok`), and the digests must be equal: the
bit-identity verdicts, the guard's statistics (its gradient-norm EMA
within 1e-5: fp32 in another order), the checkpoint each resume reads
and skips, and the structured events counted by kind.

Here: nan_skip, rollback, step_retry, data_retry, ckpt_torn and
ckpt_fallback (step_retry and data_retry drive DistriOptimizer, on the
port's one-rank mesh), one process each. The mesh legs whose shard
count is the world size are in tests/test_torch_training_drills_mesh.py.
"""

import jax
import pytest
import torch

import bigdl_tpu.obs
import test_torch_fleet_drills as fd
import test_torch_training_drills_ranks as ranks
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.utils import faults as tfaults

TOL = 1e-5
_JAX: dict = {}


def jax_weights():
    """The drill MLP's initial weights (PRNGKey(3)) as host arrays."""
    if not _JAX:
        jd = fd._drills()[0]
        _, opt, _ = jd._train("/nonexistent", end_iter=0)
        _JAX["weights"] = jax.device_get(opt.model.variables["params"])
    return _JAX["weights"]


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    bigdl_tpu.obs.reset_all()
    tobs.reset_all()
    jfaults.set_plan(None)
    tfaults.set_plan(None)


def _close(got, want, path="digest"):
    """Equal digests, floats within 1e-5 (the guard's gradient-norm EMA
    is fp32 arithmetic in another order)."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def jax_leg(tmp_path, leg):
    return fd._drills()[0].TRAINING_LEGS[leg](str(tmp_path / "jax"))


def check_training_leg(tmp_path, leg, port_digest=None, ref=None):
    ref = ref if ref is not None else jax_leg(tmp_path, leg)
    got = port_digest if port_digest is not None else ranks.run_leg(
        leg, tmp_path / "port", jax_weights())
    assert ref["ok"], ref
    assert got["ok"], got
    _close(got, ref)
    return ref


@pytest.mark.parametrize("leg", ["nan_skip", "rollback", "step_retry",
                                 "data_retry", "ckpt_torn",
                                 "ckpt_fallback"])
def test_port_training_leg_matches_the_reference(tmp_path, leg):
    check_training_leg(tmp_path, leg)
