"""Text-classification CNN (reference: example/textclassification —
news20 + GloVe). Synthetic token streams stand in for news20; plug real
tokenized data through the same Sample shape.

Ports examples/text_classification.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.text_classification [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models import textclassifier
from bigdl_tpu_torch.optim import Adam, Optimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.utils.device import resolve_device

VOCAB, SEQ, CLASSES = 200, 160, 4


def synthetic(n=512, seed=0):
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, CLASSES, n).astype(np.int32)
    # each class has a signature token band
    xs = np.stack([
        rng.randint(y * 50, y * 50 + 50, SEQ).astype(np.int32)
        for y in ys])
    return [Sample(x, int(y)) for x, y in zip(xs, ys)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    samples = synthetic()
    model = textclassifier.build(class_num=CLASSES, vocab_size=VOCAB,
                                 sequence_len=SEQ, embedding_dim=32,
                                 filters=16)
    model.build(torch.Generator().manual_seed(0), device=device)
    trained = (
        Optimizer(model, DataSet.array(samples[:384]),
                  nn.ClassNLLCriterion(), batch_size=64)
        .set_optim_method(Adam(learningrate=1e-3))
        .set_end_when(Trigger.max_epoch(8))
        .set_validation(Trigger.every_epoch(), DataSet.array(samples[384:]),
                        [Top1Accuracy()])
        .optimize()
    )
    return trained


if __name__ == "__main__":
    main()
