"""The port's moe_expert_parallel example on the CPU at world size 1
(one process, one expert), held to the example's own expectations: the
JAX example takes ~37 s on one CPU core, so it is not run beside it.
Each router trains 3 Adam steps of a randomly initialised LM over 256
tokens, whose loss starts at ~ln(256) = 5.545: each final loss is
finite and below it, and printed to 4 decimals in the JAX example's
lines."""

import math

import test_torch_examples_ranks as ranks

PREFIXES = ("top_k top-1", "top_k top-2", "expert_choice (dropless, aux=0)")
LAST = ("every router trained through the same expert-parallel "
        "all_to_all plane")


def printed_losses(text):
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(PREFIXES)]


def check_run(losses, out):
    assert len(losses) == 3
    assert printed_losses(out) == [round(x, 4) for x in losses]
    assert all(math.isfinite(x) and x < math.log(256) for x in losses)
    assert out.splitlines()[-1] == LAST


def test_world_size_1():
    losses, out = ranks.run_example("moe_expert_parallel", ranks.no_patch())
    check_run(losses, out)
