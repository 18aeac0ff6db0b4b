"""TreeLSTM sentiment (reference: example/treeLSTM — SST). Binary
constituency trees linearized to post-order op sequences (SURVEY.md §7
"hard parts"). Synthetic trees stand in for SST.

Ports examples/treelstm_sentiment.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.treelstm_sentiment [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models.treelstm import BinaryTreeLSTM, encode_from_nested
from bigdl_tpu_torch.optim import Adam, Optimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.utils.device import resolve_device

VOCAB, MAX_NODES = 40, 15


def synthetic_tree(rng, label):
    # sentiment = majority token parity; class-dependent vocabulary band
    def leaf():
        return int(rng.randint(label * 20, label * 20 + 20))
    return (leaf(), (leaf(), leaf()))


def synthetic(n=256, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = int(rng.randint(0, 2))
        enc = encode_from_nested(synthetic_tree(rng, y), MAX_NODES)
        feats = (enc["word"], enc["left"], enc["right"], enc["is_leaf"],
                 enc["mask"])
        out.append(Sample(feats, y))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    samples = synthetic()
    # per-node log-probs (root-first) → pick the root for the criterion
    model = nn.Sequential(
        BinaryTreeLSTM(VOCAB, embed_dim=16, hidden_size=32, class_num=2),
        nn.Select(2, 1))
    model.build(torch.Generator().manual_seed(0), device=device)
    trained = (
        Optimizer(model, DataSet.array(samples[:192]),
                  nn.ClassNLLCriterion(), batch_size=32)
        .set_optim_method(Adam(learningrate=3e-3))
        .set_end_when(Trigger.max_epoch(8))
        .set_validation(Trigger.every_epoch(), DataSet.array(samples[192:]),
                        [Top1Accuracy()])
        .optimize()
    )
    return trained


if __name__ == "__main__":
    main()
