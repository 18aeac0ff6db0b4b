"""Recurrent models: PTB-style language models and the BiLSTM sentiment
classifier.

Ports bigdl_tpu/models/rnn.py (reference: models/rnn/SimpleRNN.scala and
the BiLSTM sentiment configuration, BASELINE.md config 4). Same layers,
names and parameter trees, so JAX weights carry across with
models/convert.params_from_jax. Build the weights with
`model.build(generator, device=...)` (None: the card).
"""

from __future__ import annotations

from bigdl_tpu_torch import nn


def simple_rnn(vocab_size: int, hidden_size: int = 40,
               output_size: int = None, embed_dim: int = None
               ) -> nn.Sequential:
    """(reference: models/rnn/SimpleRNN.scala) word-level LM."""
    output_size = output_size or vocab_size
    embed_dim = embed_dim or hidden_size
    return nn.Sequential(
        nn.LookupTable(vocab_size, embed_dim).set_name("embedding"),
        nn.Recurrent(nn.RnnCell(embed_dim, hidden_size)).set_name("rnn"),
        nn.TimeDistributed(nn.Linear(hidden_size, output_size)
                           ).set_name("proj"),
        nn.TimeDistributed(nn.LogSoftMax()),
    )


def lstm_lm(vocab_size: int, embed_dim: int = 128, hidden_size: int = 128,
            num_layers: int = 1, dropout: float = 0.0) -> nn.Sequential:
    """LSTM language model (reference: example/languagemodel PTB
    config). Each layer's time loop runs through ops/fused_rnn.lstm_scan
    (the CUDA kernel on the card); `dropout > 0` adds an `nn.Dropout`
    after each layer."""
    m = nn.Sequential(nn.LookupTable(vocab_size, embed_dim)
                      .set_name("embedding"))
    in_size = embed_dim
    for i in range(num_layers):
        m.add(nn.Recurrent(nn.LSTM(in_size, hidden_size)).set_name(f"lstm{i}"))
        if dropout > 0:
            m.add(nn.Dropout(dropout))
        in_size = hidden_size
    m.add(nn.TimeDistributed(nn.Linear(hidden_size, vocab_size))
          .set_name("proj"))
    m.add(nn.TimeDistributed(nn.LogSoftMax()))
    return m


class _MeanOverTime(nn.Module):
    """Mean-pool over the time axis of (N, T, D)."""

    def apply(self, variables, x, training=False, rng=None):
        return x.mean(dim=1), variables["state"]


def bilstm_sentiment(vocab_size: int, embed_dim: int = 128,
                     hidden_size: int = 128, class_num: int = 2,
                     fused=None) -> nn.Sequential:
    """BiLSTM text classifier (BASELINE.md config 4). `fused` forwards
    to BiRecurrent: None runs both directions in one
    ops/fused_rnn.bilstm_scan call (the CUDA kernel on the card), False
    the per-step loop."""
    return nn.Sequential(
        nn.LookupTable(vocab_size, embed_dim).set_name("embedding"),
        nn.BiRecurrent(nn.LSTM(embed_dim, hidden_size),
                       fused=fused).set_name("bilstm"),
        _MeanOverTime(),
        nn.Linear(2 * hidden_size, class_num).set_name("cls"),
        nn.LogSoftMax(),
    )
