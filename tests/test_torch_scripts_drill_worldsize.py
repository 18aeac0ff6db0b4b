"""worldsize_resume through the port's script against the JAX
package's leg: an 8-shard ZeRO-2 sharded checkpoint resumed onto a
4-way data mesh. The JAX leg saves on its 8 CPU devices and resumes on
4 of them inside one process; a port mesh spans its process group, so
the port's script spawns twice (8 gloo ranks save, then 4 resume twice)
and reports rank 0's digest. Both must pass the leg's own gates (the
resume completes finite, loads the 8-shard checkpoint whose padding it
strips and re-pads, and two resumed runs are bitwise equal) and the
digests must be equal, rank 0's events counted against the JAX
process's.
"""

import test_torch_training_drills as td

_fresh = td._fresh


def test_port_worldsize_resume_matches_the_reference(tmp_path):
    ref = td.check_training_leg(tmp_path, "worldsize_resume")
    assert ref["saved_shards"] == 8 and ref["resumed_mesh_devices"] == 4
