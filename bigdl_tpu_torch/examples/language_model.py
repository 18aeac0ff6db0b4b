"""LSTM language model (reference: example/languagemodel — PTB).
Synthetic integer sequences stand in for PTB; next-token targets, the
LSTM's time loop in the fused kernels (ops/fused_rnn.py on the card),
TimeDistributedCriterion over all steps.

Ports examples/language_model.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.language_model [--device cpu]
"""

import argparse

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.text import synthetic_next_token
from bigdl_tpu_torch.models import rnn
from bigdl_tpu_torch.optim import Adam, Loss, Optimizer, Trigger
from bigdl_tpu_torch.utils.device import resolve_device

VOCAB, SEQ = 64, 24


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    samples = synthetic_next_token(256, VOCAB, SEQ)
    model = rnn.lstm_lm(VOCAB, embed_dim=32, hidden_size=64)
    model.build(torch.Generator().manual_seed(0), device=device)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    trained = (
        Optimizer(model, DataSet.array(samples[:224]), crit, batch_size=32)
        .set_optim_method(Adam(learningrate=3e-3))
        .set_end_when(Trigger.max_epoch(6))
        .set_validation(Trigger.every_epoch(), DataSet.array(samples[224:]),
                        [Loss(crit)])
        .optimize()
    )
    return trained


if __name__ == "__main__":
    main()
