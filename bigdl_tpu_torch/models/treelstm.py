"""TreeLSTM for sentiment over constituency trees.

Ports bigdl_tpu/models/treelstm.py (reference: the BinaryTreeLSTM of
example/treeLSTM / nn/BinaryTreeLSTM.scala: a binary tree LSTM over
SST-style parse trees, per-node sentiment classification, evaluated
with TreeNNAccuracy on the root). No Pallas kernel of the JAX package
lies on this path; it is plain PyTorch.

Trees are linearized to fixed-length post-order arrays (below), so a
batch of trees of any shape has one static shape. Two schedules
compute the same function:

- the slot scan (`_slot_scan`): one step per post-order node slot,
  `max_nodes` serial steps; each slot is a leaf or the composition of
  two earlier slots. Where the JAX package writes its slot into a
  scanned buffer (`h_buf.at[:, t].set`), the port builds the next
  buffer out of place (`torch.where` over a one-hot slot), since an
  in-place write into a buffer autograd saved would fail its backward;
- the wavefront (`_wavefront`, used when the input carries `level` and
  the model has `max_levels`): every leaf in one product, then one
  batched composition step per depth level, `max_levels - 1` serial
  steps; each level composes every slot and keeps those of its level.

A batch deeper than `max_levels - 1` levels poisons the output with
NaN on the device (no host sync), never a silently wrong answer;
`encode_from_nested(..., max_levels=)` refuses such a tree up front.
Dtypes promote as jnp's do: the per-node masks are fp32, so under bf16
compute the classifier (and the slot scan's fp32 node buffers'
composer) run in fp32, as in the JAX package.

Tree encoding per sample (int32 arrays of length `max_nodes`):
    word    — token id for leaves, 0 for internal/pad
    left    — post-order index of left child (internal), -1 otherwise
    right   — likewise for the right child
    is_leaf — 1/0;  mask — 1 for real nodes, 0 for padding
    level   — wavefront depth: 0 for leaves, 1+max(children) internal
Root is the LAST real node in post-order. `roots_first` and
`encode_from_nested` are host numpy, copied from the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module, _fold_rng


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    """x @ W + b with jnp's dtype promotion (torch's matmul wants one
    dtype): a bf16 weight meets an fp32 operand in fp32."""
    dt = torch.promote_types(x.dtype, p["weight"].dtype)
    return x.to(dt) @ p["weight"].to(dt) + p["bias"]


class BinaryTreeLSTM(Module):
    """(reference: nn/BinaryTreeLSTM.scala — binary composer variant)

    `max_levels`: the wavefront schedule's static depth bound. When set
    and the input carries a `level` array (the 6th input, emitted by
    `encode_from_nested`), evaluation is level-batched; otherwise the
    serial slot scan runs (any depth)."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden_size: int,
                 class_num: int, *, max_levels: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_size = hidden_size
        self.class_num = class_num
        self.max_levels = max_levels

    def init_params(self, generator: Optional[torch.Generator] = None):
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        h, d = self.hidden_size, self.embed_dim

        def dense(i, n_in, n_out):
            lim = math.sqrt(6.0 / (n_in + n_out))  # Xavier, the default
            return {"weight": torch.empty(n_in, n_out).uniform_(
                -lim, lim, generator=_fold_rng(g, i)),
                "bias": torch.zeros(n_out)}

        return {
            "embedding": torch.empty(self.vocab_size, d).uniform_(
                -0.5, 0.5, generator=_fold_rng(g, 0)),
            # leaf: x -> (i, o, u) gates (no forget at leaves)
            "leaf": dense(1, d, 3 * h),
            # composer: [h_l, h_r] -> (i, fl, fr, o, u)
            "compose": dense(2, 2 * h, 5 * h),
            "cls": dense(3, h, self.class_num),
        }

    @staticmethod
    def _leaf_step(p, x_emb):
        i, o, u = _dense(x_emb, p["leaf"]).chunk(3, dim=-1)
        c = torch.sigmoid(i) * torch.tanh(u)
        return torch.sigmoid(o) * torch.tanh(c), c

    @staticmethod
    def _compose_step(p, hl, cl, hr, cr):
        z = _dense(torch.cat([hl, hr], -1), p["compose"])
        i, fl, fr, o, u = z.chunk(5, dim=-1)
        c = (torch.sigmoid(fl) * cl + torch.sigmoid(fr) * cr
             + torch.sigmoid(i) * torch.tanh(u))
        return torch.sigmoid(o) * torch.tanh(c), c

    def apply(self, variables, inputs, training=False, rng=None):
        """inputs: a dict with word (N,T), left, right, is_leaf, mask and
        optionally level — or the same tensors as a 5- or 6-tuple in
        that order. Returns per-node log-probs (N, T, C) in root-first
        order: node 0 is the tree's root (TreeNNAccuracy's convention),
        node t the t-th node of reversed post-order, padding at the end.
        Targets use the same order (`roots_first`)."""
        p = variables["params"]
        level = None
        if isinstance(inputs, dict):
            word, left, right = inputs["word"], inputs["left"], \
                inputs["right"]
            is_leaf, mask = inputs["is_leaf"], inputs["mask"]
            level = inputs.get("level")
        elif len(inputs) == 6:
            word, left, right, is_leaf, mask, level = inputs
        else:
            word, left, right, is_leaf, mask = inputs

        if level is not None and self.max_levels is not None:
            h_buf = self._wavefront(p, word, left, right, is_leaf, mask,
                                    level)
        else:
            h_buf = self._slot_scan(p, word, left, right, is_leaf, mask)
        return self._emit_logits(p, h_buf, mask), variables["state"]

    def _slot_scan(self, p, word, left, right, is_leaf, mask):
        """One serial step per post-order node slot (any depth). The
        node buffers are fp32, as the JAX package's `jnp.zeros` are."""
        n_batch, t_nodes = word.shape
        dev = word.device
        emb = p["embedding"][word.long()]
        batch_idx = torch.arange(n_batch, device=dev)
        slots = torch.arange(t_nodes, device=dev)[None, :, None]
        li_all = left.clamp(0, t_nodes - 1).long()
        ri_all = right.clamp(0, t_nodes - 1).long()
        h_buf = c_buf = torch.zeros((n_batch, t_nodes, self.hidden_size),
                                    device=dev)
        for t in range(t_nodes):
            leaf_h, leaf_c = self._leaf_step(p, emb[:, t])
            li, ri = li_all[:, t], ri_all[:, t]
            comp_h, comp_c = self._compose_step(
                p, h_buf[batch_idx, li], c_buf[batch_idx, li],
                h_buf[batch_idx, ri], c_buf[batch_idx, ri])
            leaf_flag = is_leaf[:, t][:, None].float()
            m = mask[:, t][:, None].float()
            h_t = (leaf_flag * leaf_h + (1 - leaf_flag) * comp_h) * m
            c_t = (leaf_flag * leaf_c + (1 - leaf_flag) * comp_c) * m
            at_t = slots == t
            h_buf = torch.where(at_t, h_t[:, None], h_buf)
            c_buf = torch.where(at_t, c_t[:, None], c_buf)
        return h_buf

    def _wavefront(self, p, word, left, right, is_leaf, mask, level):
        """All leaves in one product, then one batched compose step per
        depth level, `max_levels - 1` serial steps. Every slot is
        composed at each level and the select keeps those whose level
        matches, so the function is the slot scan's."""
        t_nodes = word.shape[1]
        emb = p["embedding"][word.long()]
        leaf_h, leaf_c = self._leaf_step(p, emb)            # (N, T, H)
        leaf_on = (is_leaf * mask).bool()[..., None]
        h_buf = torch.where(leaf_on, leaf_h, 0.0)
        c_buf = torch.where(leaf_on, leaf_c, 0.0)

        batch_idx = torch.arange(word.shape[0], device=word.device)[:, None]
        li = left.clamp(0, t_nodes - 1).long()
        ri = right.clamp(0, t_nodes - 1).long()
        compose_on = ((1 - is_leaf) * mask).bool()
        for lvl in range(1, self.max_levels):
            comp_h, comp_c = self._compose_step(
                p, h_buf[batch_idx, li], c_buf[batch_idx, li],
                h_buf[batch_idx, ri], c_buf[batch_idx, ri])
            upd = (compose_on & (level == lvl))[..., None]
            h_buf = torch.where(upd, comp_h, h_buf)
            c_buf = torch.where(upd, comp_c, c_buf)
        # a tree deeper than the static bound would emit the zero h of
        # every never-composed node: poison the whole buffer instead,
        # on the device, so the step never waits on the host
        too_deep = torch.any((level >= self.max_levels) & (mask == 1))
        return torch.where(too_deep, math.nan, h_buf)

    @staticmethod
    def _emit_logits(p, h_buf, mask):
        n_batch, t_nodes = mask.shape
        dev = mask.device
        batch_idx = torch.arange(n_batch, device=dev)
        # root-first: reversed post-order, padding at the end
        n_nodes = mask.int().sum(dim=1)
        t_range = torch.arange(t_nodes, device=dev)[None, :]
        gather_idx = (n_nodes[:, None] - 1 - t_range).clamp(0, t_nodes - 1)
        out_mask = (t_range < n_nodes[:, None]).float()[..., None]
        h_out = h_buf[batch_idx[:, None], gather_idx] * out_mask
        # masked logits: a padded slot gives a uniform distribution with
        # zero gradient to the parameters (never log_softmax(bias))
        logits = _dense(h_out, p["cls"]) * out_mask
        return torch.log_softmax(logits, dim=-1)


# ----------------------------------------------------------- tree encoding
def roots_first(per_node: np.ndarray, n_nodes: int, pad=0) -> np.ndarray:
    """Reorder a post-order per-node array (e.g. labels) into the
    root-first order BinaryTreeLSTM emits its outputs in."""
    out = np.full_like(per_node, pad)
    out[:n_nodes] = per_node[:n_nodes][::-1]
    return out


def encode_from_nested(tree, max_nodes: int, word2id=None,
                       max_levels: Optional[int] = None):
    """Encode a nested-list binary tree, e.g. ((("a", "b"), "c")) where
    leaves are tokens (str or int). Returns dict of int32 arrays of length
    max_nodes: word/left/right/is_leaf/mask/level, plus n_nodes and
    n_levels (root level + 1 — the wavefront step count). `max_levels`
    (optional) enforces the model's static wavefront bound at encode
    time: a tree needing more levels raises here rather than silently
    mis-evaluating on the level-batched path."""
    word, left, right, is_leaf, level = [], [], [], [], []

    def rec(node):
        if not isinstance(node, (tuple, list)):
            tok = word2id(node) if word2id else int(node)
            word.append(tok)
            left.append(-1)
            right.append(-1)
            is_leaf.append(1)
            level.append(0)
            return len(word) - 1
        l_idx = rec(node[0])
        r_idx = rec(node[1])
        word.append(0)
        left.append(l_idx)
        right.append(r_idx)
        is_leaf.append(0)
        level.append(1 + max(level[l_idx], level[r_idx]))
        return len(word) - 1

    rec(tree)
    n = len(word)
    if n > max_nodes:
        raise ValueError(f"tree has {n} nodes > max_nodes {max_nodes}")
    n_levels = max(level) + 1
    if max_levels is not None and n_levels > max_levels:
        raise ValueError(
            f"tree needs {n_levels} levels > max_levels {max_levels}")

    def pad(a, v=0):
        return np.asarray(a + [v] * (max_nodes - n), np.int32)

    return {
        "word": pad(word), "left": pad(left, -1), "right": pad(right, -1),
        "is_leaf": pad(is_leaf), "mask": pad([1] * n),
        "level": pad(level),
        "n_nodes": n, "n_levels": n_levels,
    }
