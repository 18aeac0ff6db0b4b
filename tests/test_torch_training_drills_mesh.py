"""Port re-enactments of scripts/fault_drill.py's mesh training legs
(ZeRO-2 DistriOptimizer, sharded and asynchronous checkpoints):
nan_skip_mesh, preempt_resume, ckpt_async_torn and torn_shard, with the
harness of tests/test_torch_training_drills.py.

The JAX package runs a leg on one process over the 8 devices of its CPU
mesh; the port runs it on 8 gloo ranks (parallel/launch.spawn, one
module fixture for the four legs; the rank body is
tests/test_torch_training_drills_ranks.py, which imports no JAX), so
each rank holds one shard, as each JAX device does. Rank 0 writes the
model units and publishes each sharded checkpoint. Rank 0's digest must
pass the leg's own gates and equal the reference's, with the
`checkpoint_save` events counted over all ranks (each rank records the
shard units it writes; the JAX process records all 8).

worldsize_resume cannot run as one leg here: it saves at 8 shards and
resumes on a 4-device mesh inside one function, and a port mesh spans
its process group, so the two halves need groups of different sizes
(ROADMAP.md queue C). tests/test_torch_sharded_checkpoint.py holds the
port's world-size change (2 to 1 and back) bitwise.
"""

import pytest

import test_torch_training_drills as td
import test_torch_training_drills_ranks as ranks
from bigdl_tpu_torch.parallel.launch import spawn

WORLD = 8
LEGS = ("nan_skip_mesh", "preempt_resume", "ckpt_async_torn", "torn_shard")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_legs")
    return spawn(ranks.rank_legs, WORLD, str(base / "w"), LEGS,
                 str(base / "legs"), td.jax_weights(), timeout=240)


def _over_ranks(runs, leg):
    """Rank 0's digest with its checkpoint_save counts summed over the
    ranks."""
    got = dict(runs[0][leg])
    for key in ("events", "resume_events"):
        if key in got and "checkpoint_save" in got[key]:
            got[key] = dict(got[key], checkpoint_save=sum(
                r[leg][key].get("checkpoint_save", 0) for r in runs))
    return got


@pytest.mark.parametrize("leg", LEGS)
def test_port_mesh_leg_matches_the_reference(tmp_path, port_runs, leg):
    ref = td.jax_leg(tmp_path, leg)
    got = _over_ranks(port_runs, leg)
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
