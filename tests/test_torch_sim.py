"""The port's fleet simulator (bigdl_tpu_torch/serving/sim.py) against
the JAX package's (bigdl_tpu/serving/sim.py) on the CPU.

- `CostModel.from_bench_artifacts(paths)` with the JAX package's default
  artifacts (the BENCH_r0*.json files at the repository root, passed
  explicitly: the port has no default there) gives the reference's
  constants, queries and provenance, exactly (the same Python float
  arithmetic); with no paths it refuses;
- `CostModel.default()` is the committed card reading
  (serving/sim_calibration.json): its provenance names the card, its
  power limit and the torch version, and `decode_ms` at the reading's
  context bucket gives back the reading;
- a SimulatedEngine fleet (two engines, one shared CostModel, an
  EngineRouter) replays one seeded trace (the scripts' `make_trace`
  and `replay`, host-side: scripts/loadgen.py for the JAX package,
  bigdl_tpu_torch/scripts/loadgen.py for the port) with the report,
  the engines' stats and health, and the events counted by kind equal
  to the reference's, in both pacing modes;
- the sim-vs-real divergence check of tests/test_sim.py on the port: the
  same 24-request trace through a real one-engine port fleet (a tiny LM,
  `device="cpu"`) and a simulated one with per-step pacing: statuses
  and goodput exactly, latency, TTFT and makespan within
  max(0.25, 1.5 x the calibration's spread).
"""

import glob
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

import bigdl_tpu.obs as jobs
from bigdl_tpu import serving as jserving
from bigdl_tpu.serving import sim as jsim
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import serving as tserving
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.scripts import loadgen as tloadgen
from bigdl_tpu_torch.serving import sim as tsim

ROOT = Path(__file__).resolve().parent.parent
BENCH = sorted(glob.glob(str(ROOT / "BENCH_r0*.json")))
PKG = {"jax": (jserving, jsim, jobs), "torch": (tserving, tsim, tobs)}


def _loadgen(pkg="jax"):
    """The package's load generator (the JAX package's is loaded from
    scripts/loadgen.py)."""
    if pkg == "torch":
        return tloadgen
    mod = sys.modules.get("bigdl_loadgen")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "bigdl_loadgen", ROOT / "scripts" / "loadgen.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bigdl_loadgen"] = mod
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh():
    prev = {o: o.set_enabled(True) for o in (jobs, tobs)}
    for o in prev:
        o.reset_all()
    try:
        yield
    finally:
        for o, p in prev.items():
            o.reset_all()
            o.set_enabled(p)


def test_bench_calibration_matches_the_reference():
    want = jsim.CostModel.from_bench_artifacts()
    got = tsim.CostModel.from_bench_artifacts(BENCH)
    for k in ("base_decode_ms", "base_prefill_ms", "int8_speedup",
              "spread_frac", "sources"):
        assert getattr(got, k) == getattr(want, k), k
    for kw in ({}, {"bucket": 512, "tp": 2}, {"layout_family": "int8/x"},
               {"spec_accept": 0.4, "bucket": 32}):
        assert got.decode_ms(**kw) == want.decode_ms(**kw)
    assert got.prefill_ms(37, tp=2) == want.prefill_ms(37, tp=2)
    prov, ref = got.provenance(), want.provenance()
    assert prov["source"] == "bench_artifacts"
    assert {k: v for k, v in prov.items() if k != "source"} == ref
    with pytest.raises(ValueError, match="explicit paths"):
        tsim.CostModel.from_bench_artifacts(None)
    with pytest.raises(ValueError, match="calibration rows"):
        tsim.CostModel.from_bench_artifacts([])


def test_default_is_the_committed_card_reading(tmp_path):
    with open(tsim.CARD_CALIBRATION) as f:
        reading = json.load(f)
    cost = tsim.CostModel.default()
    prov = cost.provenance()
    assert prov["source"] == "card_reading"
    src = prov["sources"][0]
    assert src["card"] == reading["card"] and "H100" in src["card"]
    assert src["card"].endswith(" W") and src["torch"] == reading["torch"]
    assert prov["factors"]["train_fwd_factor"] is None
    assert cost.decode_ms(bucket=reading["context_bucket"]) \
        == pytest.approx(reading["decode_ms_per_token"], rel=1e-12)
    assert cost.prefill_ms(10) \
        == pytest.approx(10 * reading["prefill_ms_per_token"], rel=1e-12)
    assert cost.spread_frac == reading["spread_frac"]
    bad = dict(reading)
    del bad["card"]
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="card"):
        tsim.CostModel.from_card_reading(str(path))


def _replay(pkg, engines_fn, trace_fn, tmp_path):
    """Replay trace_fn() through an EngineRouter over engines_fn(clock)
    in one package; (report, per-engine stats and health, events by
    kind)."""
    serving, _, o = PKG[pkg]
    lg = _loadgen(pkg)
    clk = {"t": 0.0}

    def c():
        return clk["t"]

    pool = engines_fn(pkg, c)
    router = serving.EngineRouter(pool, clock=c, obs_label="r0")
    report = lg.replay(router, trace_fn(), clock=clk)
    counts = o.get_event_log().counts_by_kind()
    return (json.loads(json.dumps(report, sort_keys=True)),
            [(e.stats, e.health()) for e in pool], counts)


def _sim_pool(pacing, bench=True):
    def make(pkg, clock):
        sim = PKG[pkg][1]
        cost = sim.CostModel.from_bench_artifacts(BENCH)
        return [sim.SimulatedEngine(cost, clock=clock, slots=4,
                                    max_queue=8, overload_policy="shed-oldest",
                                    pacing=pacing, obs_label=f"sim{i}")
                for i in range(2)]
    return make


@pytest.mark.parametrize("pacing", ["per_step", "throughput"])
def test_sim_fleet_matches_the_reference(tmp_path, pacing):
    lg = _loadgen()

    def trace():
        return lg.make_trace(48, seed=5, arrival="bursty", burst_size=16,
                             deadline_frac=0.2, deadline_s=2.0)

    want = _replay("jax", _sim_pool(pacing), trace, tmp_path)
    got = _replay("torch", _sim_pool(pacing), trace, tmp_path)
    assert got == want
    assert sum(want[0]["by_status"].values()) + want[0]["rejected"] == 48


def _real_pool(pkg, clock):
    model = TransformerLM(TransformerConfig(
        vocab_size=50, dim=32, num_heads=2, num_layers=2, max_len=96),
        device="cpu")
    model.build(torch.Generator().manual_seed(0))
    return [tserving.InferenceEngine(model, slots=4,
                                     prefill_buckets=(8, 16, 32),
                                     block_size=16, clock=clock,
                                     device="cpu")]


def test_divergence_vs_real_port_fleet(tmp_path):
    lg = _loadgen("torch")

    def trace():
        return lg.make_trace(24, seed=3, arrival="poisson", rate=6.0)

    def sim_pool(pkg, clock):
        return [tsim.SimulatedEngine(tsim.CostModel.default(), clock=clock,
                                     slots=4, pacing="per_step")]

    real = _replay("torch", _real_pool, trace, tmp_path)[0]
    sim = _replay("torch", sim_pool, trace, tmp_path)[0]
    assert sim["by_status"] == real["by_status"] == {"done": 24}
    assert sim["goodput_tokens"] == real["goodput_tokens"]
    tol = max(0.25, 1.5 * tsim.CostModel.default().spread_frac)
    for key in ("latency_p50_s", "latency_p99_s", "ttft_p50_s",
                "makespan_s"):
        rv, sv = real[key], sim[key]
        assert abs(sv - rv) / max(abs(rv), 1e-9) <= tol, (key, rv, sv)
