"""Port re-enactments of scripts/fault_drill.py's scenario_chaos and
spec_adapt legs, with the harness of tests/test_torch_fleet_drills.py.

- scenario_chaos compiles the built-in `chaos_smoke` scenario and
  replays it twice through a two-SimulatedEngine fleet behind a
  tenancy-armed EngineRouter (scripts/loadgen.py's host-side `replay`)
  with a FlightRecorder. On the port side `bigdl_tpu.serving.scenarios`
  and `bigdl_tpu.serving.sim` resolve to the port's too. Both packages
  get the same calibration: the leg asks `CostModel.from_bench_artifacts()`
  for the JAX package's default, the BENCH_r0*.json artifacts at the
  repository root, and the port's CostModel takes explicit paths only,
  so the port side is handed those same paths. The leg's gates must pass
  on the port and its whole digest equal the reference's: the reports
  and flight-recorder bundles are pure functions of the scenario and
  the calibration.
- spec_adapt fails on the reference itself (its resume gate: the
  swapped draft's accept_after stays None), so the port's run is held
  to the leg's other gates instead of the JAX digest: tokens bitwise
  target-only before and after the hot swap, zero requests lost, the
  burst-1 collapse (k_live 1, suspended), one swap, no fallback, two
  runs byte-identical. Its `build_lm` resolves to a port TransformerLM
  that carries the JAX initial weights of the same key, and its
  DraftDistiller is the port's (ZeRO-2 on a one-rank gloo mesh).
"""

import glob
import sys
import types
from pathlib import Path
from unittest import mock

import jax

import test_torch_fleet_drills as fd
from bigdl_tpu.models import transformer as jtransformer
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.serving import scenarios as tscenarios
from bigdl_tpu_torch.serving import sim as tsim

_fresh = fd._fresh
ROOT = Path(__file__).resolve().parent.parent
BENCH = sorted(glob.glob(str(ROOT / "BENCH_r0*.json")))


class _BenchCalibrated(tsim.CostModel):
    """The port's CostModel handed the JAX package's default artifacts."""

    @classmethod
    def from_bench_artifacts(cls, paths=None):
        return super().from_bench_artifacts(BENCH if paths is None
                                            else paths)


def _port_build_lm(**cfg):
    """`build_lm` for the port side: a port TransformerLM whose
    `build(key)` carries the JAX model's initial weights for `key`."""
    jm = jtransformer.build_lm(**cfg)
    tm = TransformerLM(TransformerConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["dim"],
        num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
        max_len=cfg["max_len"]), device="cpu")

    def build(key):
        jm.build(key)
        tm.variables = {"params": params_from_jax(
            jax.device_get(jm.variables["params"]), device="cpu"),
            "state": {}}
        return tm

    tm.build = build
    return tm


def _extra():
    sim = types.ModuleType("bigdl_tpu.serving.sim")
    sim.CostModel, sim.SimulatedEngine = (_BenchCalibrated,
                                          tsim.SimulatedEngine)
    transformer = types.ModuleType("bigdl_tpu.models.transformer")
    transformer.build_lm = _port_build_lm
    return [mock.patch.dict(sys.modules, {
        "bigdl_tpu.serving.sim": sim,
        "bigdl_tpu.serving.scenarios": tscenarios,
        "bigdl_tpu.models.transformer": transformer})]


def test_port_scenario_chaos_matches_the_reference(tmp_path):
    jd, pd = fd._drills()
    ref = fd._run(jd, "scenario_chaos", tmp_path / "jax", [])
    got = fd._run(pd, "scenario_chaos", tmp_path / "port",
                  fd._port_side(False) + _extra())
    assert ref["ok"], ref
    assert got["ok"], got
    assert got == ref


def test_port_spec_adapt_holds_its_own_gates(tmp_path):
    _, pd = fd._drills()
    got = fd._run(pd, "spec_adapt", tmp_path / "port",
                  fd._port_side(False) + _extra())
    assert got["statuses"] == ["done"] * 12
    assert got["bit_identical_to_target_only"]
    assert got["requests_lost"] == 0
    assert got["collapsed_mid_run"] == {"k_live": 1, "suspended": True}
    assert got["swap"]["swap"] == 1 and got["swap"]["source"] == "distill"
    assert got["events"]["draft_swap"] == 1
    assert got["events"]["request_terminal"] == 12
    assert got["report_byte_identical"]
