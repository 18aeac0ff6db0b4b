"""Mixture-of-Experts LM with expert parallelism: Switch top-1, GShard
top-2, and the dropless expert-choice router, over an `expert` mesh
axis (tokens exchanged by all_to_all between ranks). No reference
counterpart (SURVEY.md §2.3).

Ports examples/moe_expert_parallel.py to bigdl_tpu_torch: one process a
rank (one expert each), each on its own card (or a gloo rank on the
CPU). Run under torchrun at any world size, or alone at world size 1:

    torchrun --nproc_per_node 4 \\
        -m bigdl_tpu_torch.examples.moe_expert_parallel
    python -m bigdl_tpu_torch.examples.moe_expert_parallel [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch.examples._ranks import join
from bigdl_tpu_torch.models.convert import tree_leaves
from bigdl_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from bigdl_tpu_torch.optim import Adam
from bigdl_tpu_torch.parallel import (make_mesh, make_moe_lm_train_step,
                                      shard_params)

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def run(mesh, routing, top_k, device):
    """Three steps of one router; its last loss."""
    n = mesh.shape["expert"]
    cfg = TransformerConfig(vocab_size=256, max_len=32, dim=64,
                            num_heads=4, num_layers=2, dropout=0.0,
                            moe_experts=n, moe_top_k=top_k,
                            moe_routing=routing)
    model = TransformerLM(cfg, device=device, ep_axis="expert", name="lm")
    params = model.init_params(torch.Generator().manual_seed(0))
    method = Adam(1e-3)
    step = make_moe_lm_train_step(model, method, mesh, ep_axis="expert")
    sp = shard_params(mesh, step.specs, params)
    ss = method.init_slots(tree_leaves(sp))
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(0, 256, (2 * n, 32)),
                           dtype=torch.int32, device=device)
    tgts = torch.as_tensor(rng.randint(0, 256, (2 * n, 32)),
                           dtype=torch.int32, device=device)
    for it in range(3):
        sp, ss, loss = step(sp, ss, toks, tgts, 1e-3, it, it)
    kind = (f"top_k top-{top_k}" if routing == "top_k"
            else "expert_choice (dropless, aux=0)")
    print(f"{kind:32s} final loss {float(loss):.4f}")
    return float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device, world = join(ap.parse_args(argv).device)
    mesh = make_mesh({"expert": world}, device=device)
    try:
        losses = [run(mesh, "top_k", 1, device),          # Switch
                  run(mesh, "top_k", 2, device),          # GShard
                  run(mesh, "expert_choice", 1, device)]  # experts pick
    finally:
        mesh.close()
    print("every router trained through the same expert-parallel "
          "all_to_all plane")
    return losses


if __name__ == "__main__":
    main()
