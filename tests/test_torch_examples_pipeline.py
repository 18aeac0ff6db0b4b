"""The port's pipeline_parallel_lm example on 4 spawned gloo ranks (its
4 stages), held to the example's own expectations: the JAX example
takes ~46 s on one CPU core, so it is not run beside it. Rank 0 prints
the JAX example's eight lines: the schedules' bubbles (0.273 under
GPipe, 0.158 interleaved at 2 virtual stages), five iterations' losses
(a random 256-token LM starts at ~ln(256) = 5.545, within 0.1, and SGD
lowers it every step) and the parameter count, that of the model's
tree."""

import math

from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from bigdl_tpu_torch.parallel.launch import spawn

import test_torch_examples_ranks as ranks


def test_four_stages(tmp_path):
    out = spawn(ranks.rank_example, 4, str(tmp_path),
                "pipeline_parallel_lm", timeout=180)
    losses, text = out[0]
    assert all(o[0] == losses for o in out)
    assert all(o[1] == "" for o in out[1:])
    assert len(losses) == 5
    assert abs(losses[0] - math.log(256)) < 0.1
    assert all(b < a for a, b in zip(losses, losses[1:]))
    cfg = TransformerConfig(vocab_size=256, max_len=64, dim=64,
                            num_heads=4, num_layers=8, dropout=0.0)
    n = sum(t.numel() for t in tree_leaves(
        TransformerLM(cfg, device="cpu").init_params()))
    assert text.splitlines() == [
        "GPipe bubble (4 stages x 8 microbatches): 0.273",
        "interleaved 1F1B bubble (x2 virtual stages):     0.158",
        *[f"iter {i}: loss {x:.4f}" for i, x in enumerate(losses)],
        f"params back in standard layout: {n} scalars"]
