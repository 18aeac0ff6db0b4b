"""NCF recommendation (the BigDL paper's NCF benchmark): GMF+MLP towers,
evaluated with HitRatio@10 / NDCG@10.

Ports examples/recommendation_ncf.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.recommendation_ncf [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models import ncf
from bigdl_tpu_torch.optim import (NDCG, Adam, Evaluator, HitRatio,
                                   Optimizer, Top1Accuracy, Trigger)
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

USERS, ITEMS = 32, 64


def synthetic(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, USERS, n)
    items = rng.randint(0, ITEMS, n)
    labels = ((users * 7 + items) % 5).astype(np.int32)  # rating 0..4
    return [Sample(np.stack([u, i]).astype(np.int32), int(l))
            for u, i, l in zip(users, items, labels)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    samples = synthetic()
    model = ncf.build(USERS, ITEMS, class_num=5, user_embed=16,
                      item_embed=16, hidden_layers=(32, 16), mf_embed=16)
    model.build(torch.Generator().manual_seed(0), device=device)
    trained = (
        Optimizer(model, DataSet.array(samples[:1792]),
                  nn.ClassNLLCriterion(), batch_size=128)
        .set_optim_method(Adam(learningrate=3e-3))
        .set_end_when(Trigger.max_epoch(8))
        .optimize()
    )
    res = Evaluator(trained).test(
        DataSet.array(samples[1792:]),
        [Top1Accuracy(), HitRatio(k=2), NDCG(k=2)], batch_size=128)
    for name, r in res.items():
        print(name, r.result()[0])
    return trained


if __name__ == "__main__":
    main()
