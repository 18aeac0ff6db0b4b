"""The port's re-enactments of the fault-drill legs slo_alert and
tenant_noisy, through tests/test_torch_fleet_drills.py's harness (the
same leg code for both packages, the port's digest fields held to the
reference's).
"""

import pytest

import test_torch_fleet_drills as fd

_fresh = fd._fresh


@pytest.mark.parametrize("leg", ["slo_alert", "tenant_noisy"])
def test_port_drill_leg_matches_the_reference(tmp_path, leg):
    fd.check_leg(tmp_path, leg)
