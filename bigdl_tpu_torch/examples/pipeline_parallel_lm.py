"""Pipeline-parallel LM training: GPipe vs interleaved 1F1B (virtual
stages). No reference counterpart (SURVEY.md §2.3 lists only data
parallelism); this is the `pipe` mesh axis with the Megatron-style
interleaved schedule that cuts the GPipe bubble ~in half at equal
microbatches.

Ports examples/pipeline_parallel_lm.py to bigdl_tpu_torch: its 4 stages
are 4 ranks, one process each, each on its own card (or a gloo rank on
the CPU):

    torchrun --nproc_per_node 4 \\
        -m bigdl_tpu_torch.examples.pipeline_parallel_lm [--device cpu]
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.examples._ranks import join
from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import (interleaved_bubble_fraction,
                                      make_mesh, make_pipeline_train_step,
                                      pipeline_bubble_fraction,
                                      shard_params, to_virtual_layout)
from bigdl_tpu_torch.parallel.tensor_parallel import gather_params

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device, world = join(ap.parse_args(argv).device)
    stages, micro, virtual = 4, 8, 2
    if world != stages:
        raise RuntimeError(f"{stages} pipeline stages need {stages} ranks "
                           f"(torchrun --nproc_per_node {stages}), not "
                           f"{world}")
    lead = dist.get_rank() == 0

    def say(line):
        if lead:
            print(line)

    mesh = make_mesh({"pipe": stages}, device=device)
    cfg = TransformerConfig(vocab_size=256, max_len=64, dim=64,
                            num_heads=4, num_layers=8, dropout=0.0)
    model = TransformerLM(cfg, device=device, name="lm")
    params = model.init_params(torch.Generator().manual_seed(0))
    method = SGD(learningrate=0.1, momentum=0.9)

    say(f"GPipe bubble ({stages} stages x {micro} microbatches): "
        f"{pipeline_bubble_fraction(stages, micro):.3f}")
    say(f"interleaved 1F1B bubble (x{virtual} virtual stages):     "
        f"{interleaved_bubble_fraction(stages, micro, virtual):.3f}")

    step = make_pipeline_train_step(model, method, mesh, pipe_axis="pipe",
                                    microbatches=micro,
                                    virtual_stages=virtual)
    # interleaved schedule: params/slots live in virtual-stage layout
    vp = shard_params(mesh, step.specs,
                      to_virtual_layout(params, stages, virtual))
    vs = method.init_slots(tree_leaves(vp))
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, 256, (16, 64)),
                           dtype=torch.int32, device=device)
    tgts = torch.as_tensor(rng.randint(0, 256, (16, 64)),
                           dtype=torch.int32, device=device)
    losses = []
    try:
        for it in range(5):
            vp, vs, loss = step(vp, vs, toks, tgts, 0.1, it, it)
            losses.append(float(loss))
            say(f"iter {it}: loss {losses[-1]:.4f}")
        # checkpoints should store the standard layer order
        std = to_virtual_layout(gather_params(mesh, step.specs, vp),
                                stages, virtual, inverse=True)
    finally:
        mesh.close()
    n = sum(int(np.prod(x.shape)) for x in tree_leaves(std))
    say(f"params back in standard layout: {n} scalars")
    return losses


if __name__ == "__main__":
    main()
