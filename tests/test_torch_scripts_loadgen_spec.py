"""The port's load generator against the JAX package's under
speculative decoding, with tests/test_torch_scripts_loadgen.py's
helpers (the JAX CLI's tiny LM and draft weights carried in, the CPU):
a sampled `--spec-draft` CLI run holds the fields no token value moves
(statuses, requests, goodput tokens, the lookahead k) to the JAX CLI's
and reruns byte-identical; a greedy trace through both packages'
speculative fleets gives equal tokens, equal reports and equal
speculation tallies (greedy acceptance depends on the carried weights
only).
"""

import json

import test_torch_scripts_loadgen as tl
from bigdl_tpu_torch.serving import SpeculativeEngine

_fresh = tl._fresh


def test_spec_draft_cli_shares_the_token_free_fields(capsys):
    argv = "--requests 16 --spec-draft --seed 1".split()
    want = json.loads(tl.jax_report(argv, capsys))
    got_text = tl.port_report(argv)
    assert tl.port_report(argv) == got_text
    got = json.loads(got_text)
    for key in ("by_status", "requests", "rejected", "goodput_tokens"):
        assert got[key] == want[key], key
    assert got["spec"]["k"] == want["spec"]["k"] == 4
    assert got["spec"]["proposed"] > 0


def test_greedy_speculative_fleet_equals_the_reference():
    jlg = tl.jax_loadgen()
    out = {}
    for name, lg, kw in (("jax", jlg, {}),
                         ("torch", tl.tlg, dict(device="cpu",
                                                weights=tl.jax_weights()))):
        router, _, clk = lg.build_fleet(1, spec_draft=True, spec_k=3, **kw)
        toks = {}
        rep = lg.replay(router, lg.make_trace(8, seed=2, temperature=0.0),
                        clock=clk, on_result=lambda r: toks.__setitem__(
                            r.id, list(r.tokens)))
        (eng,) = router.engines
        tally = {k: eng.stats[k] for k in ("proposed", "accepted",
                                           "emitted", "wasted")}
        out[name] = (json.dumps(rep, sort_keys=True),
                     [toks[i] for i in sorted(toks)], tally)
    assert isinstance(router.engines[0], SpeculativeEngine)
    assert out["torch"] == out["jax"]
