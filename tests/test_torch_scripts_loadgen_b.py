"""More of the port's load generator against the JAX package's, with
tests/test_torch_scripts_loadgen.py's helpers (the JAX CLI's tiny LM
weights carried in, the CPU):

- the reference's other usage lines (autoscaling, SLO objectives,
  tenants with a noisy neighbour and a vision group): the port's report
  equals the JAX CLI's, whole, and two port runs are byte-identical;
- `--sim` and `--scenario chaos_smoke --sim`: both packages' simulated
  fleets over the JAX package's BENCH_r0*.json calibration (the port's
  CostModel takes explicit paths; its default is the card reading)
  give equal reports.

Speculation is in tests/test_torch_scripts_loadgen_spec.py.
"""

import glob
import json

import pytest

import test_torch_scripts_loadgen as tl
from bigdl_tpu_torch.serving import sim as tsim

_fresh = tl._fresh
BENCH = sorted(glob.glob(str(tl.ROOT / "BENCH_r0*.json")))


@pytest.mark.parametrize("line", tl.USAGE[1:])
def test_usage_line_report_equals_the_reference(line, capsys):
    rep = tl.check_usage(line, capsys)
    assert sum(rep["by_status"].values()) + rep["rejected"] \
        == rep["requests"]


@pytest.mark.parametrize("line", ["--requests 32 --sim --engines 2 "
                                  "--sim-pacing per_step --seed 3",
                                  "--scenario chaos_smoke --sim"])
def test_sim_report_equals_the_reference(line, capsys):
    argv = line.split()
    want = tl.jax_report(argv, capsys)
    cost = tsim.CostModel.from_bench_artifacts(BENCH)
    got = tl.port_report(argv, cost=cost)
    assert json.loads(got).keys() == json.loads(want).keys()
    assert got == want
