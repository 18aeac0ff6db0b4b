"""fleet_tp_failover through the port's script against the JAX
package's leg: a tensor-parallel engine (tp=2) tripped by its watchdog
mid-decode fails its requests over to an unsharded engine, with tokens
bitwise those of an undisturbed run and one cross-layout journey per
rerouted request. The JAX leg shards over two of conftest's CPU
devices; the port's script spawns two gloo ranks, each running the
whole leg (SPMD), and reports rank 0's digest, which must pass the
leg's gates and equal the reference's (tests/test_torch_fleet_drills.py's
harness). Neither side may report `skipped`; on a CUDA device with one
card the port's leg does, with the reason.
"""

from unittest import mock

import test_torch_fleet_drills as fd
from bigdl_tpu_torch.scripts import fault_drill as pdrill

_fresh = fd._fresh


def test_port_tp_failover_matches_the_reference(tmp_path):
    got = fd.check_leg(tmp_path, "fleet_tp_failover")
    assert got["layouts"] == {"degraded_tp": 2, "survivor_tp": 1}
    assert got["journeys"]["cross_layout"] == 3


def test_tp_legs_skip_with_one_card():
    pdrill.configure("cuda")
    try:
        with mock.patch("torch.cuda.device_count", return_value=1):
            for leg in ("fleet_tp_failover", "fleet_journey"):
                got = pdrill.SERVING_LEGS[leg]("/nonexistent")
                assert got["ok"] and "one CUDA card a rank" \
                    in got["skipped"], got
    finally:
        pdrill.configure()
