"""The port's load generator (bigdl_tpu_torch/scripts/loadgen.py) against
the JAX package's (scripts/loadgen.py) on the CPU.

- The reference's usage lines (scripts/loadgen.py's docstring, at most
  32 requests) through both CLIs: the port's report (`run(argv +
  --device cpu)`, the JAX CLI's tiny LMs' weights carried in through
  `weights=`) equals the JAX CLI's printed report, whole. The traces
  are sampled (make_trace's temperature 0.8) and the port's sampled
  streams are its own (serving/sampler.py), but no field of these
  reports holds a token value: they count tokens and time them on the
  virtual clock. Two port runs print byte-identical reports.
- A greedy trace replayed through both packages' `build_fleet` with
  the same weights: the reports equal and every request's tokens equal.
- `--device` defaults to the card and raises without one.

The other usage lines, speculation, the simulator and scenarios are in
tests/test_torch_scripts_loadgen_b.py; `--tp 2` on two gloo ranks in
tests/test_torch_scripts_loadgen_tp.py (both import this file's
helpers).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import pytest
import torch

import bigdl_tpu.obs as jobs
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.scripts import loadgen as tlg

ROOT = Path(__file__).resolve().parent.parent
USAGE = (
    "--requests 32 --engines 2 --arrival bursty --seed 0",
    "--requests 32 --autoscale --target-p99 8.0 --max-engines 3",
    "--requests 32 --slo-target-p99 6.0 --slo-goodput 0.95",
    "--requests 24 --tenants 2 --noisy-tenant 1 --vision-frac 0.25 "
    "--seed 0",
)
_MOD: dict = {}


def jax_loadgen():
    mod = sys.modules.get("bigdl_loadgen")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "bigdl_loadgen", ROOT / "scripts" / "loadgen.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bigdl_loadgen"] = mod
        spec.loader.exec_module(mod)
    return mod


def jax_weights(max_len=96, feature_len=8) -> dict:
    """The JAX CLI's tiny LMs' weights (build_fleet: PRNGKey 0 for the
    LM, 1 for the draft, 2 for the vision head) as host arrays."""
    key = (max_len, feature_len)
    if key not in _MOD:
        from bigdl_tpu.models.transformer import build_lm

        lm = build_lm(vocab_size=50, dim=32, num_heads=2, num_layers=2,
                      max_len=max_len)
        lm.build(jax.random.PRNGKey(0))
        draft = build_lm(vocab_size=50, dim=16, num_heads=2, num_layers=1,
                         max_len=max_len)
        draft.build(jax.random.PRNGKey(1))
        _MOD[key] = {
            "lm": jax.device_get(lm.variables["params"]),
            "draft": jax.device_get(draft.variables["params"]),
            "vision": jax.device_get(jax.random.normal(
                jax.random.PRNGKey(2), (feature_len, 10)))}
    return _MOD[key]


@pytest.fixture(autouse=True)
def _fresh():
    """Both CLIs install a process-wide event log; one intra-op thread
    keeps the port's CPU runs repeatable (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = {o: o.set_enabled(True) for o in (jobs, tobs)}
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        for o, p in prev.items():
            o.reset_all()
            o.set_enabled(p)


def jax_report(argv, capsys) -> str:
    capsys.readouterr()
    assert jax_loadgen().main(argv) == 0
    return capsys.readouterr().out.strip()


def port_report(argv, **kw) -> str:
    kw.setdefault("weights", jax_weights())
    return json.dumps(tlg.run(argv + ["--device", "cpu"], **kw),
                      sort_keys=True)


def check_usage(line, capsys):
    argv = line.split()
    want = jax_report(argv, capsys)
    got = port_report(argv)
    assert got == want
    assert port_report(argv) == got                # byte-identical rerun
    return json.loads(got)


@pytest.mark.parametrize("line", USAGE[:1])
def test_usage_line_report_equals_the_reference(line, capsys):
    rep = check_usage(line, capsys)
    assert rep["requests"] == 32


def test_greedy_replay_tokens_equal_the_reference():
    jlg = jax_loadgen()
    trace_kw = dict(seed=4, arrival="bursty", burst_size=6,
                    temperature=0.0, sessions=2)
    out = {}
    for name, lg, kw in (("jax", jlg, {}),
                         ("torch", tlg, dict(device="cpu",
                                             weights=jax_weights()))):
        router, _, clk = lg.build_fleet(2, **kw)
        toks = {}
        rep = lg.replay(router, lg.make_trace(12, **trace_kw), clock=clk,
                        on_result=lambda r: toks.__setitem__(
                            r.id, list(r.tokens)))
        out[name] = (json.dumps(rep, sort_keys=True),
                     [toks[i] for i in sorted(toks)])
    assert out["torch"] == out["jax"]
    assert len(out["jax"][1]) == 12 + 2 * 3


def test_device_defaults_to_the_card_and_raises_without_one():
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlg.run(["--requests", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlg.main(["--requests", "2"])


def test_cli_runs_as_a_module():
    argv = "--requests 6 --engines 2 --seed 3 --device cpu".split()
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.scripts.loadgen", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout == json.dumps(tlg.run(argv), sort_keys=True) + "\n"
