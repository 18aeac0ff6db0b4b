"""The port's serve_lm example (bigdl_tpu_torch/examples/serve_lm.py) on
the CPU, held to the example's own expectations: the JAX example takes
~45 s on one CPU core, so it is not run beside it. The example asserts
that every request finishes 'done', that the engine's health is 'ok'
and that the speculative stream is the target-only stream verbatim; the
test holds the greedy requests to the task the LM was trained on (the
cyclic grammar: each token the previous one plus 1, mod 64), as the JAX
example's greedy requests continue it, and the printed lines to the
JAX example's."""

import test_torch_examples_ranks as ranks

VOCAB = 64


def _lines(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def test_serve_lm():
    results, out = ranks.run_example("serve_lm", ranks.no_patch())
    assert len(results) == 6 and all(r.status == "done" for r in results)
    lines = _lines(out, "req ")
    assert len(lines) == 6 and all("(done/" in line for line in lines)
    for r in (results[0], results[4]):  # the greedy requests, in order
        want = [(r.prompt[-1] + 1 + i) % VOCAB for i in range(12)]
        assert list(r.tokens) == want, (r.prompt, r.tokens)
    (spec,) = _lines(out, "speculative decode:")
    assert spec.endswith("tokens bit-identical to target-only)")
    assert "engine health: {'state': 'ok'" in out
