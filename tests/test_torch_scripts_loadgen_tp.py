"""`--tp 2` through the port's load generator: two gloo ranks
(parallel/launch.spawn, the rank body in
tests/test_torch_scripts_loadgen_ranks.py), each replaying the same
seeded trace on the same virtual clock over a fleet of tensor-parallel
engines, print the same report, which equals the `--tp`-off report
but for the pool's `tp` entry (sharded decode is bitwise unsharded
decode, serving/tp.py) and equals the JAX CLI's `--tp 2` report over
two of conftest's CPU devices, the JAX CLI's tiny LM weights carried
in (tests/test_torch_scripts_loadgen.py's helpers).
"""

import json

import test_torch_scripts_loadgen as tl
import test_torch_scripts_loadgen_ranks as ranks
from bigdl_tpu_torch.parallel.launch import spawn

_fresh = tl._fresh
ARGV = "--requests 32 --engines 2 --arrival bursty --seed 0".split()


def test_tp2_on_two_ranks_gives_the_unsharded_report(tmp_path, capsys):
    tp = ARGV + ["--tp", "2"]
    reps = spawn(ranks.rank_report, 2, str(tmp_path / "w"),
                 tp + ["--device", "cpu"], tl.jax_weights(), timeout=300)
    assert reps[0] == reps[1]
    assert reps[0] == tl.jax_report(tp, capsys)
    got = json.loads(reps[0])
    assert got["pool"].pop("tp") == 2
    assert got == json.loads(tl.port_report(ARGV))
