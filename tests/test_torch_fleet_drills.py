"""Port re-enactments of the serving fleet's fault-drill legs
(scripts/fault_drill.py): serve_spec, fleet_failover and fleet_drain
here; fleet_affinity_failover, fleet_autoscale and fleet_journey in
tests/test_torch_fleet_drills_b.py, slo_alert and tenant_noisy in
tests/test_torch_fleet_drills_c.py, which import this file's harness
(three files keep each under 30 s on one core).

Each leg runs twice in this process: once as the JAX package runs it,
and once as the PORT runs it — the same leg code from a second copy of
the drill module, with `bigdl_tpu.serving`, `bigdl_tpu.obs` (and its
flightrecorder, slo, timeseries and journey modules) and
`bigdl_tpu.utils.faults` resolved to `bigdl_tpu_torch`'s for the
duration of the leg, its tiny LMs replaced by port models carrying the
same weights (`params_from_jax`), and its engines built on the CPU.
The leg's own gates must pass on the port (`ok`), and every digest
field the two packages share must be equal: statuses, event counts by
kind, failovers, migrations, drain states, autoscale decisions and
their p99s, alert firings and bundles, throttle actions and per-tenant
stats. Fields that depend on sampled token VALUES are the exception:
the port's seeded streams are its own (serving/sampler.py), so sampled
tokens, and the speculative accept tallies they move, are held to the
port's own target-only run by the leg itself (its bit-identity gates)
rather than to the JAX package's.

`fleet_journey` serves one of its engines tensor-parallel on a
two-device JAX mesh; the port's tensor-parallel engine needs one
process a rank (tests/test_torch_tp_serving.py), so here both packages
run the leg with that engine unsharded (the leg's cross-layout gate
then cannot hold on either side and is not asserted). `spec_adapt`
fails on the reference itself, and `scenario_chaos` needs the
scenario plane, which waits for ROADMAP.md queue A.9.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import pytest
import torch

import bigdl_tpu
import bigdl_tpu.obs
import bigdl_tpu.serving
import bigdl_tpu.utils
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import serving as tserving
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.obs import (flightrecorder, journey, slo,
                                 timeseries)
from bigdl_tpu_torch.utils import faults as tfaults

DRILL = Path(__file__).resolve().parent.parent / "scripts" / "fault_drill.py"
_MODS: dict = {}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, DRILL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_lm(jm):
    """A port TransformerLM carrying the JAX model's weights."""
    c = jm.cfg
    tm = TransformerLM(TransformerConfig(
        vocab_size=c.vocab_size, dim=c.dim, num_heads=c.num_heads,
        num_layers=c.num_layers, max_len=c.max_len), device="cpu")
    tm.variables = params_from_jax(jax.device_get(jm.variables["params"]),
                                   device="cpu")
    return tm


class _CpuEngine(tserving.InferenceEngine):
    """The port engine on the CPU (the drills pass no device)."""

    def __init__(self, model, variables=None, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(model, variables, **kw)


def _drills():
    """(the JAX drill module, the port's copy): the port copy's tiny
    LMs are port models with the JAX ones' weights."""
    if not _MODS:
        jd = _load("fault_drill_jax_side")
        pd = _load("fault_drill_port_side")
        pd._SERVE_LM = _port_lm(jd._serve_lm())
        pd._SERVE_DRAFT_LM = _port_lm(jd._serve_draft_lm())
        _MODS.update(jax=jd, port=pd)
    return _MODS["jax"], _MODS["port"]


def _no_mesh(*_a, **_k):
    return None


def _port_side(unsharded: bool):
    """Resolve the JAX package's serving, obs and faults names to the
    port's for one leg."""
    serving = types.ModuleType("bigdl_tpu.serving")
    serving.__dict__.update({k: getattr(tserving, k)
                             for k in tserving.__all__})
    serving.InferenceEngine = _CpuEngine
    mods = {"bigdl_tpu.serving": serving,
            "bigdl_tpu.obs.flightrecorder": flightrecorder,
            "bigdl_tpu.obs.slo": slo,
            "bigdl_tpu.obs.timeseries": timeseries,
            "bigdl_tpu.obs.journey": journey}
    if unsharded:
        mods["bigdl_tpu.parallel"] = types.SimpleNamespace(
            make_mesh=_no_mesh)
    stack = [mock.patch.dict(sys.modules, mods),
             mock.patch.object(bigdl_tpu, "obs", tobs),
             mock.patch.object(bigdl_tpu, "serving", serving),
             mock.patch.object(bigdl_tpu.utils, "faults", tfaults)]
    return stack


def _jax_side(unsharded: bool):
    if not unsharded:
        return []
    return [mock.patch.dict(sys.modules, {
        "bigdl_tpu.parallel": types.SimpleNamespace(make_mesh=_no_mesh)})]


def _run(mod, leg, workdir, patches):
    for p in patches:
        p.start()
    try:
        return mod.SERVING_LEGS[leg](str(workdir))
    finally:
        for p in reversed(patches):
            p.stop()
        jfaults.set_plan(None)
        tfaults.set_plan(None)


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


def check_leg(tmp_path, leg):
    """Run `leg` through both packages and hold the port's run to the
    reference's (see the module docstring)."""
    jd, pd = _drills()
    unsharded = leg == "fleet_journey"
    ref = _run(jd, leg, tmp_path / "jax", _jax_side(unsharded))
    got = _run(pd, leg, tmp_path / "port", _port_side(unsharded))
    if unsharded:
        # e0 unsharded on both sides: every gate but the cross-layout one
        for r in (ref, got):
            j = r["journeys"]
            assert j["count"] == j["complete"] == 6 and j["lost_hops"] == 0
            assert r["handoff_journeys_ok"] and r["bundle_names_failing_step"]
            assert r["journeys_byte_identical"] and r["bundles_byte_identical"]
            assert all(s == "done" for s in r["statuses"])
    else:
        assert ref["ok"], ref
        assert got["ok"], got
    skip = _SAMPLED.get(leg, set())
    want = {k: v for k, v in ref.items() if k not in skip}
    have = {k: v for k, v in got.items() if k not in skip}
    assert json.dumps(have, sort_keys=True, default=str) \
        == json.dumps(want, sort_keys=True, default=str)


@pytest.mark.parametrize("leg", ["serve_spec", "fleet_failover",
                                 "fleet_drain"])
def test_port_drill_leg_matches_the_reference(tmp_path, leg):
    check_leg(tmp_path, leg)
