"""Port re-enactments of scripts/fault_drill.py's scenario_chaos and
spec_adapt legs, with the harness of tests/test_torch_fleet_drills.py
(the port's own script, bigdl_tpu_torch/scripts/fault_drill.py, on the
CPU).

- scenario_chaos compiles the built-in `chaos_smoke` scenario and
  replays it twice through a two-SimulatedEngine fleet behind a
  tenancy-armed EngineRouter (the scripts' loadgen `replay`) with a
  FlightRecorder. Both packages get the same calibration: the JAX leg
  asks `CostModel.from_bench_artifacts()` for the JAX package's
  default, the BENCH_r0*.json artifacts at the repository root; the
  port's script is configured with the port's CostModel of those same
  paths (`configure(sim_cost=)`; its own default is the card reading).
  The leg's gates must pass on the port and its whole digest equal the
  reference's: the reports and flight-recorder bundles are pure
  functions of the scenario and the calibration.
- spec_adapt fails on the reference itself (its resume gate: the
  swapped draft's accept_after stays None), so the port's run is held
  to the leg's other gates instead of the JAX digest: tokens bitwise
  target-only before and after the hot swap, zero requests lost, the
  burst-1 collapse (k_live 1, suspended), one swap, no fallback, two
  runs byte-identical. Its private draft carries the JAX drill's draft
  weights (PRNGKey(7)), as the serving draft does, and its
  DraftDistiller is the port's (ZeRO-2 on a one-rank gloo mesh).
"""

import glob
from pathlib import Path

import test_torch_fleet_drills as fd
from bigdl_tpu_torch.serving import sim as tsim

_fresh = fd._fresh
ROOT = Path(__file__).resolve().parent.parent
BENCH = sorted(glob.glob(str(ROOT / "BENCH_r0*.json")))


def test_port_scenario_chaos_matches_the_reference(tmp_path):
    ref = fd.jax_leg("scenario_chaos", tmp_path / "jax")
    got = fd.port_leg("scenario_chaos", tmp_path / "port",
                      sim_cost=tsim.CostModel.from_bench_artifacts(BENCH))
    assert ref["ok"], ref
    assert got["ok"], got
    assert got == ref


def test_port_spec_adapt_holds_its_own_gates(tmp_path):
    got = fd.port_leg("spec_adapt", tmp_path / "port",
                      **fd.jax_lm_weights())
    assert got["statuses"] == ["done"] * 12
    assert got["bit_identical_to_target_only"]
    assert got["requests_lost"] == 0
    assert got["collapsed_mid_run"] == {"k_live": 1, "suspended": True}
    assert got["swap"]["swap"] == 1 and got["swap"]["source"] == "distill"
    assert got["events"]["draft_swap"] == 1
    assert got["events"]["request_terminal"] == 12
    assert got["report_byte_identical"]
