"""Text-classification CNN (news20-style).

Ports bigdl_tpu/models/textclassifier.py (reference:
example/textclassification/TextClassifier.scala): embedding -> temporal
conv(128, k=5) -> ReLU -> temporal max-pool(5), twice -> conv -> ReLU
-> global max pool -> linear(100) -> ReLU -> linear(classNum) ->
logsoftmax, on int token ids (batch, seq_len). The embedding is a
trainable `LookupTable`, optionally initialised from pretrained vectors
(GloVe) by `set_embedding`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch import nn


def build(class_num: int = 20, vocab_size: int = 20000,
          sequence_len: int = 500, embedding_dim: int = 100,
          filters: int = 128) -> nn.Sequential:
    model = nn.Sequential(
        nn.LookupTable(vocab_size, embedding_dim).set_name("embedding"))
    in_dim = embedding_dim
    for i in range(2):
        model.add(nn.TemporalConvolution(in_dim, filters, 5)
                  .set_name(f"conv{i + 1}"))
        model.add(nn.ReLU())
        model.add(nn.TemporalMaxPooling(5, 5))
        in_dim = filters
    model.add(nn.TemporalConvolution(in_dim, filters, 5).set_name("conv3"))
    model.add(nn.ReLU())
    model.add(nn.TemporalMaxPooling(-1))      # global max over time
    model.add(nn.Reshape([filters]))
    model.add(nn.Linear(filters, 100).set_name("fc1"))
    model.add(nn.ReLU())
    model.add(nn.Linear(100, class_num).set_name("score"))
    model.add(nn.LogSoftMax())
    return model


def set_embedding(variables: Dict[str, Any], vectors) -> Dict[str, Any]:
    """`variables` with the embedding table replaced by pretrained
    `vectors` (vocab, dim), e.g. GloVe's, as fp32 on the table's
    device (the reference bakes GloVe into the LookupTable the same
    way). The other leaves are shared, not copied."""
    params = dict(variables["params"])
    key = next(k for k in params if k.endswith("_embedding"))
    emb = dict(params[key])
    old = emb["weight"]
    if tuple(old.shape) != tuple(np.shape(vectors)):
        raise ValueError(f"embedding {tuple(old.shape)} vs vectors "
                         f"{tuple(np.shape(vectors))}")
    if not isinstance(vectors, torch.Tensor):
        vectors = torch.from_numpy(np.asarray(vectors, np.float32))
    emb["weight"] = vectors.to(old.device, torch.float32)
    params[key] = emb
    return {**variables, "params": params}


TextClassifier = build
