"""Port re-enactments of the serving fleet's fault-drill legs: serve_spec,
fleet_failover and fleet_drain here; fleet_affinity_failover,
fleet_autoscale and fleet_journey in tests/test_torch_fleet_drills_b.py,
slo_alert and tenant_noisy in tests/test_torch_fleet_drills_c.py,
scenario_chaos and spec_adapt in tests/test_torch_fleet_drills_d.py,
the serve_* legs and fleet_tp_failover in
tests/test_torch_scripts_drill_*.py; all import this file's harness
(several files keep each under 30 s on one core).

Each leg runs twice in this process: once as the JAX package runs it
(scripts/fault_drill.py), and once as the PORT's own script runs it
(bigdl_tpu_torch/scripts/fault_drill.py), configured for the CPU with
the JAX drill's tiny LMs' weights carried in (`configure(lm=, draft=)`,
host arrays). The leg's own gates must pass on the port (`ok`), and
every digest field the two packages share must be equal: statuses,
event counts by kind, failovers, migrations, drain states, autoscale
decisions and their p99s, alert firings and bundles, throttle actions
and per-tenant stats. Fields that depend on sampled token VALUES are
the exception: the port's seeded streams are its own
(serving/sampler.py), so sampled tokens, and the speculative accept
tallies they move, are held to the port's own target-only run by the
leg itself (its bit-identity gates) rather than to the JAX package's.

The tensor-parallel legs (fleet_tp_failover, fleet_journey) run sharded
in both packages: the JAX one over two of conftest's CPU devices, the
port's on two gloo ranks that its script spawns, each running the leg
(SPMD). Neither may report `skipped`.
"""

import importlib.util
import json
from pathlib import Path

import jax
import pytest
import torch

import bigdl_tpu.obs
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.scripts import fault_drill as pdrill
from bigdl_tpu_torch.utils import faults as tfaults

DRILL = Path(__file__).resolve().parent.parent / "scripts" / "fault_drill.py"
_MODS: dict = {}


def _drills():
    """(the JAX drill module, the port's script)."""
    if not _MODS:
        spec = importlib.util.spec_from_file_location("fault_drill_jax_side",
                                                      DRILL)
        jd = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jd)
        _MODS.update(jax=jd, port=pdrill)
    return _MODS["jax"], _MODS["port"]


def jax_lm_weights() -> dict:
    """The JAX drill's tiny LMs' weights as host arrays: configure()'s
    `lm` and `draft`."""
    jd = _drills()[0]
    return {"lm": jax.device_get(jd._serve_lm().variables["params"]),
            "draft": jax.device_get(
                jd._serve_draft_lm().variables["params"])}


def jax_leg(leg, workdir, plane="serving"):
    jd = _drills()[0]
    legs = jd.SERVING_LEGS if plane == "serving" else jd.TRAINING_LEGS
    try:
        return legs[leg](str(workdir))
    finally:
        jfaults.set_plan(None)


def port_leg(leg, workdir, plane="serving", **weights):
    """One leg through the port's script on the CPU; `weights` are
    configure()'s keywords (default: the JAX drill's tiny LMs)."""
    if plane == "serving" and not weights:
        weights = jax_lm_weights()
    pdrill.configure("cpu", **weights)
    legs = pdrill.SERVING_LEGS if plane == "serving" \
        else pdrill.TRAINING_LEGS
    try:
        return legs[leg](str(workdir))
    finally:
        pdrill.join_step_threads()
        tfaults.set_plan(None)
        pdrill.configure()


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' telemetry and fault plans are process-wide. The
    legs' step watchdogs run on the wall clock (50 ms budgets): one
    intra-op thread keeps a tiny CPU decode step from queueing behind
    the other test workers' threads (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    bigdl_tpu.obs.reset_all()
    tobs.reset_all()
    jfaults.set_plan(None)
    tfaults.set_plan(None)


# fields holding sampled token values, or the accept tallies they move
_SAMPLED = {"serve_spec": {"accept_rate"}}
# fields naming the decode step at which a real-time (50 ms) watchdog
# tripped: the injected hang trips it at step 2, but a loaded host can
# trip a tensor-parallel step earlier on either side (the JAX one over
# two CPU devices tripped at step 0 under six test workers); both sides
# must still name a watchdog trip, and every other field is held
_WALL_CLOCK = {"fleet_tp_failover": {"degraded_engine"}}


def check_leg(tmp_path, leg, **weights):
    """Run `leg` through both packages and hold the port's run to the
    reference's (see the module docstring)."""
    ref = jax_leg(leg, tmp_path / "jax")
    got = port_leg(leg, tmp_path / "port", **weights)
    assert "skipped" not in ref and "skipped" not in got
    assert ref["ok"], ref
    assert got["ok"], got
    clocked = _WALL_CLOCK.get(leg, set())
    for r in (ref, got):
        assert all("watchdog trip at decode step" in r[k] for k in clocked)
    skip = _SAMPLED.get(leg, set()) | clocked
    want = {k: v for k, v in ref.items() if k not in skip}
    have = {k: v for k, v in got.items() if k not in skip}
    assert json.dumps(have, sort_keys=True, default=str) \
        == json.dumps(want, sort_keys=True, default=str)
    return got


@pytest.mark.parametrize("leg", ["serve_spec", "fleet_failover",
                                 "fleet_drain"])
def test_port_drill_leg_matches_the_reference(tmp_path, leg):
    check_leg(tmp_path, leg)
