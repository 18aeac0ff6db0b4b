"""Transformer language model trained through the product surface.

Ports examples/transformer_lm.py to bigdl_tpu_torch: a decoder-only
transformer trained with `Optimizer` + `nn.ChunkedSoftmaxCE` (a
post-parity extension of example/languagemodel). The criterion fuses
with the model, so the training step computes the loss from hidden
states in sequence chunks and never materializes the (B, S, V)
log-prob tensor; attention runs in the flash kernels on the card.

    python -m bigdl_tpu_torch.examples.transformer_lm [--device cpu]
"""

import argparse

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.text import synthetic_next_token
from bigdl_tpu_torch.models import transformer
from bigdl_tpu_torch.optim import Adam, Loss, Optimizer, Trigger
from bigdl_tpu_torch.utils.device import resolve_device

VOCAB, SEQ = 64, 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    samples = synthetic_next_token(256, VOCAB, SEQ)
    model = transformer.build_lm(VOCAB, dim=128, num_heads=4,
                                 num_layers=2, max_len=SEQ, device=device)
    model.build(torch.Generator().manual_seed(0))
    crit = nn.ChunkedSoftmaxCE()
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
