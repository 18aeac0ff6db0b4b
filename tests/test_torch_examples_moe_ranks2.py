"""The port's moe_expert_parallel example on 2 spawned gloo ranks (two
experts, tokens exchanged by all_to_all), held to the example's own
expectations as at world size 1 (test_torch_examples_moe.check_run),
both ranks reporting the same losses."""

from bigdl_tpu_torch.parallel.launch import spawn

import test_torch_examples_ranks as ranks
from test_torch_examples_moe import check_run


def test_two_ranks(tmp_path):
    out = spawn(ranks.rank_example, 2, str(tmp_path),
                "moe_expert_parallel", timeout=180)
    for losses, text in out:
        assert losses == out[0][0]
        check_run(losses, text)
