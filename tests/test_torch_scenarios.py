"""The port's scenario compiler (bigdl_tpu_torch/serving/scenarios.py)
against the JAX package's (bigdl_tpu/serving/scenarios.py): a host-side
copy whose determinism contract is one `np.random.RandomState(seed)`
consumed in spec order, so every compiled trace must equal the
reference's exactly — arrival times, request fields, sessions and their
continuations, phases, chaos timelines, tenants, fleet and provenance —
for every built-in scenario at full size, and the refusals must match."""

import json

import pytest

from bigdl_tpu.serving import scenarios as jsc
from bigdl_tpu_torch.serving import scenarios as tsc


def _plain(trace):
    """A trace as JSON-able data (Arrival dataclasses to tuples)."""
    out = dict(trace)
    out["arrivals"] = [(a.t, a.spec, a.session, a.turn)
                       for a in trace["arrivals"]]
    return json.loads(json.dumps(out, sort_keys=True))


def test_catalog_matches():
    assert tsc.BUILTIN_SCENARIOS == jsc.BUILTIN_SCENARIOS
    assert tsc.list_scenarios() == jsc.list_scenarios()
    for name in tsc.list_scenarios():
        assert tsc.load_scenario(name) == jsc.load_scenario(name)
        # load_scenario hands out a copy the caller may change
        tsc.load_scenario(name)["seed"] = 99
        assert tsc.BUILTIN_SCENARIOS[name]["seed"] == 0


@pytest.mark.parametrize("name", sorted(jsc.BUILTIN_SCENARIOS))
def test_builtin_scenario_compiles_to_the_reference_trace(name):
    want = _plain(jsc.compile_scenario(name))
    got = _plain(tsc.compile_scenario(name))
    assert len(got["arrivals"]) == len(want["arrivals"])
    assert got == want


@pytest.mark.parametrize("scale", [0.01, 2.0])
def test_scaled_and_file_specs(tmp_path, scale):
    spec = tsc.load_scenario("agentic_sessions")
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    for src in ("agentic_sessions", str(path), spec):
        assert _plain(tsc.compile_scenario(src, scale=scale)) \
            == _plain(jsc.compile_scenario(src, scale=scale))


@pytest.mark.parametrize("bad", [
    {"shapes": [{"kind": "nope", "n": 1}]},
    {"shapes": [{"kind": "steady", "n": 2, "tenant_mix": {"x": 1.0}}]},
    {"shapes": [{"kind": "regional_wave"}]},
    {"shapes": [{"kind": "sessions"}, {"kind": "sessions"}]},
    {"shapes": [], "chaos": [{"t": 1.0, "action": "explode"}]},
    {"shapes": [], "chaos": [{"t": 1.0, "action": "drain"}]},
    {"shapes": [], "chaos": [{"t": 1.0, "action": "tenant_flood"}]},
    {"tenants": [{"weight": 1.0}], "shapes": []},
    {"no": "shapes"},
    "no_such_scenario",
])
def test_refusals_match(bad):
    with pytest.raises(ValueError) as jerr:
        jsc.compile_scenario(bad)
    with pytest.raises(ValueError) as terr:
        tsc.compile_scenario(bad)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        tsc.compile_scenario({"shapes": []}, scale=0)
