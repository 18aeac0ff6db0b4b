"""The port's re-enactments of the fault-drill legs
fleet_affinity_failover, fleet_autoscale and fleet_journey, through
tests/test_torch_fleet_drills.py's harness (the same leg code for both
packages, the port's digest fields held to the reference's).
"""

import pytest

import test_torch_fleet_drills as fd

_fresh = fd._fresh


@pytest.mark.parametrize("leg", ["fleet_affinity_failover",
                                 "fleet_autoscale", "fleet_journey"])
def test_port_drill_leg_matches_the_reference(tmp_path, leg):
    fd.check_leg(tmp_path, leg)
