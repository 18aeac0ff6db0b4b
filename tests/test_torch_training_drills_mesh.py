"""Port re-enactments of scripts/fault_drill.py's mesh training legs
(ZeRO-2 DistriOptimizer, sharded and asynchronous checkpoints):
nan_skip_mesh, preempt_resume, ckpt_async_torn and torn_shard, with the
harness of tests/test_torch_training_drills.py.

The JAX package runs a leg on one process over the 8 devices of its CPU
mesh; the port's script (bigdl_tpu_torch/scripts/fault_drill.py,
`run_mesh_legs`: one module fixture for the four legs) runs it on 8
gloo ranks, so each rank holds one shard, as each JAX device does.
Rank 0 writes the model units and publishes each sharded checkpoint.
The script's digest is rank 0's with the `checkpoint_save` events
counted over all ranks (each rank records the shard units it writes;
the JAX process records all 8); it must pass the leg's own gates and
equal the reference's. worldsize_resume, which needs two groups of
different sizes, is held in tests/test_torch_scripts_drill_worldsize.py.
"""

import pytest

import test_torch_training_drills as td
from bigdl_tpu_torch.scripts import fault_drill as pdrill

WORLD = pdrill.MESH_WORLD
LEGS = ("nan_skip_mesh", "preempt_resume", "ckpt_async_torn", "torn_shard")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_legs")
    pdrill.configure("cpu", train=td.jax_weights())
    try:
        return pdrill.run_mesh_legs(LEGS, str(base / "legs"))
    finally:
        pdrill.configure()


@pytest.mark.parametrize("leg", LEGS)
def test_port_mesh_leg_matches_the_reference(tmp_path, port_runs, leg):
    ref = td.jax_leg(tmp_path, leg)
    got = dict(port_runs[leg])
    if leg == "ckpt_async_torn":
        # one structural difference, held to its own count: the JAX
        # process's one writer dies after the first of its 8 shard
        # units, each of the port's 8 writers after its own, so the
        # port records WORLD - 1 more shard events. The save overlaps
        # the next steps on every rank, so the torn writer's error
        # surfaces at the next save (step 6) in both packages
        ev, want = dict(got["events"]), ref["events"]
        assert ev["checkpoint_save"] == want["checkpoint_save"] + WORLD - 1
        assert ev["train_step"] == want["train_step"]
        ev.update(checkpoint_save=want["checkpoint_save"])
        got["events"] = ev
    td.check_training_leg(tmp_path, leg, got, ref)
