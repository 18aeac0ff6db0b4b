"""Neural Collaborative Filtering (NeuralCF).

Ports bigdl_tpu/models/ncf.py (reference: the BigDL paper's
recommendation benchmark, the reference line's `NeuralCF`): GMF and MLP
towers over user and item embeddings on `nn.Graph`. Input is an int
array (batch, 2) of 0-based [user_id, item_id] pairs; output is
log-probabilities over `class_num` rating classes, trained with
`ClassNLLCriterion`.
"""

from __future__ import annotations

from typing import Sequence

from bigdl_tpu_torch import nn


def build(user_count: int, item_count: int, class_num: int = 5,
          user_embed: int = 20, item_embed: int = 20,
          hidden_layers: Sequence[int] = (40, 20, 10),
          include_mf: bool = True, mf_embed: int = 20) -> nn.Graph:
    """The MLP tower on concat(user, item) embeddings, joined with the
    GMF tower's elementwise product when `include_mf`."""
    pair = nn.Input()
    user = nn.Select(2, 1)(pair)
    item = nn.Select(2, 2)(pair)

    u_mlp = nn.LookupTable(user_count, user_embed)(user)
    i_mlp = nn.LookupTable(item_count, item_embed)(item)
    h = nn.JoinTable(2)(u_mlp, i_mlp)
    in_dim = user_embed + item_embed
    for out_dim in hidden_layers:
        h = nn.Linear(in_dim, out_dim)(h)
        h = nn.ReLU()(h)
        in_dim = out_dim

    if include_mf:
        u_mf = nn.LookupTable(user_count, mf_embed)(user)
        i_mf = nn.LookupTable(item_count, mf_embed)(item)
        gmf = nn.CMulTable()(u_mf, i_mf)
        h = nn.JoinTable(2)(gmf, h)
        in_dim = in_dim + mf_embed

    score = nn.Linear(in_dim, class_num)(h)
    return nn.Graph(pair, nn.LogSoftMax()(score))


NeuralCF = build
