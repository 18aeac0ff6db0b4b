"""Pipeline parallelism — the GPipe and interleaved microbatch schedules
over a mesh axis.

Ports bigdl_tpu/parallel/pipeline.py (no reference counterpart; the
`pipe` mesh axis). The TransformerLM's stacked parameters make stages
trivial: stage i owns the contiguous layer slice blocks[i·L/n :
(i+1)·L/n], i.e. every stacked block leaf is split on its layer axis
with P('pipe', ...). Activations hop stage to stage with `ppermute`.

The step keeps the JAX package's SPMD tick loop, which has the same
bits and the same kernel launches as the JAX program: on every tick
every rank runs its layer chunk (an idle stage's result simply never
reaches a loss), then the activations move one stage on. M
microbatches flow through n stages in M + n - 1 ticks under GPipe;
under the interleaved schedule (`virtual_stages` v > 1) each rank owns
v round-robin chunks, a tick runs one chunk of L/(n·v) layers and a
microbatch circles the ring v times. Autograd reverses the tick loop,
each `ppermute` backward the reverse shift.

Every rank's graph must be the same for the backward's collectives to
pair up, so the stage masks are `torch.where`s and multiplications,
never a branch that drops a tensor on some ranks: the first stage's
input is `where(first, embedding, received)`, and every rank computes
the head loss of a finishing microbatch, multiplied by 1 on the last
stage and 0 elsewhere. The last stage's loss crosses to every stage
through `tp_reduce` (sum forward, identity backward). Replicated leaves
(embed/pos/final LN) are used on different stages, so their per-stage
gradients are partial and are summed over the pipe axis; the
layer-split leaves' are whole on their stage.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
from bigdl_tpu_torch.nn.normalization import layer_norm
from bigdl_tpu_torch.parallel.collectives import (bind, ppermute,
                                                  psum_leaves, tp_reduce)
from bigdl_tpu_torch.parallel.mesh import P
from bigdl_tpu_torch.parallel.tensor_parallel import _zip_specs

__all__ = ["pipeline_specs", "pipeline_bubble_fraction",
           "interleaved_bubble_fraction", "to_virtual_layout",
           "make_pipeline_train_step"]

logger = logging.getLogger("bigdl_tpu_torch.parallel")


def pipeline_specs(pipe_axis: str = "pipe", tie_embeddings: bool = True):
    """PartitionSpecs: stacked block leaves split on the layer axis."""
    def blk(ndim):
        return P(pipe_axis, *([None] * (ndim - 1)))

    blocks = {
        "ln1_g": blk(2), "ln1_b": blk(2), "ln2_g": blk(2), "ln2_b": blk(2),
        "wq": blk(3), "wk": blk(3), "wv": blk(3), "wo": blk(3),
        "bq": blk(2), "bk": blk(2), "bv": blk(2), "bo": blk(2),
        "w1": blk(3), "b1": blk(2), "w2": blk(3), "b2": blk(2),
    }
    specs = {"embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
             "blocks": blocks}
    if not tie_embeddings:
        specs["head"] = P()
    return specs


def pipeline_bubble_fraction(n_stages: int, microbatches: int) -> float:
    """GPipe idle fraction: each stage idles for (n−1) of the m+n−1
    ticks (warm-up + drain)."""
    return (n_stages - 1) / (microbatches + n_stages - 1)


def _injection_schedule(n: int, m: int, v: int) -> List[int]:
    """Interleaved-schedule injection ticks: microbatch j enters virtual
    stage 0 (rank 0, chunk 0) at tick inject[j]. An in-flight
    microbatch occupies rank (t−t0) mod n at tick t for v·n ticks, so
    two microbatches collide iff their injection ticks share a residue
    mod n while both are in flight; greedy first-free-tick. v=1 is
    GPipe (inject = 0..m−1)."""
    inject, last = [], {}
    t = 0
    for _ in range(m):
        while True:
            r = t % n
            if r not in last or last[r] + v * n <= t:
                break
            t += 1
        inject.append(t)
        last[t % n] = t
        t += 1
    return inject


def interleaved_bubble_fraction(n_stages: int, microbatches: int,
                                virtual_stages: int) -> float:
    """Idle fraction of the interleaved schedule: total ticks of length
    T/v against m·T of useful work a rank (4 stages × 8 microbatches:
    0.273 under GPipe, 0.158 at v=2)."""
    inject = _injection_schedule(n_stages, microbatches, virtual_stages)
    total_ticks = inject[-1] + virtual_stages * n_stages
    return 1.0 - microbatches * virtual_stages / total_ticks


def to_virtual_layout(tree, n_stages: int, virtual_stages: int,
                      inverse: bool = False):
    """Permute a params-shaped tree's stacked "blocks" leaves from layer
    order into the interleaved schedule's virtual-stage order (or back,
    inverse=True). Virtual stage c·n+d (chunk c of rank d) owns global
    layers [(c·n+d)·Lc, (c·n+d+1)·Lc); under the P('pipe') split rank d
    holds rows [d·L/n, (d+1)·L/n), so new row d·(L/n)+c·Lc+l is old row
    (c·n+d)·Lc+l. Optimizer-slot dicts (params-shaped trees one level
    down) are handled by recursing until a "blocks" key appears. Apply
    once at setup; checkpoints store the layer order."""
    if not isinstance(tree, dict) or not tree:
        return tree
    if "blocks" not in tree:
        return {k: to_virtual_layout(v, n_stages, virtual_stages, inverse)
                for k, v in tree.items()}
    blocks = tree["blocks"]
    L = tree_leaves(blocks)[0].shape[0]
    n, v = n_stages, virtual_stages
    if L % (n * v):
        raise ValueError(
            f"{L} stacked layers not divisible by {n} stages x {v} "
            "virtual stages — refusing to build a garbage permutation")
    lc = L // (n * v)
    perm = np.empty(L, np.int64)
    for d in range(n):
        for c in range(v):
            for l in range(lc):
                perm[d * (L // n) + c * lc + l] = (c * n + d) * lc + l
    if inverse:
        perm = np.argsort(perm)
    out = dict(tree)
    index = torch.as_tensor(perm)
    out["blocks"] = tree_map(
        lambda a: torch.as_tensor(a)[index.to(torch.as_tensor(a).device)],
        blocks)
    return out


def make_pipeline_train_step(model, method, mesh, pipe_axis: str = "pipe",
                             dp_axis: Optional[str] = None,
                             microbatches: int = 4,
                             virtual_stages: int = 1) -> Callable:
    """The pipeline training step of a TransformerLM over pipe(×data):

        step(params, slots, tokens, targets, lr, stepno, rng)
            -> (params', slots', mean_loss)

    params/slots: this rank's stage (`shard_params(mesh,
    pipeline_specs(...), tree)`, after `to_virtual_layout` when
    virtual_stages > 1; slots `{name: [tensors]}` in the params' leaf
    order), updated in place and returned; tokens/targets: the global
    (B, S) batch every rank holds alike, B divisible by microbatches ×
    the data axis; `rng` unused (no dropout in the stages, as in the
    JAX package). `step.bubble_fraction` is the schedule's idle share.
    The model must have tp_axis=None and sp_axis=None."""
    if model.tp_axis is not None or model.sp_axis is not None:
        raise ValueError("pipeline stage model must not set tp/sp axes")
    if model.cfg.moe_experts:
        raise NotImplementedError(
            "pipeline over a MoE-FFN TransformerLM (the MoE aux loss "
            "and expert-stacked specs are not plumbed through GPipe)")
    n = mesh.shape[pipe_axis]
    v = virtual_stages
    cfg = model.cfg
    if cfg.num_layers % (n * v):
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by "
            f"{n} pipeline stages x {v} virtual stages")
    m_micro = microbatches
    lpc = cfg.num_layers // (n * v)
    inject = _injection_schedule(n, m_micro, v)
    total_ticks = inject[-1] + v * n
    # static per-tick tables: the chunk each rank runs (idle → 0, its
    # result never reaches a loss), the microbatch injected at rank 0 /
    # finished at rank n-1
    chunk_tbl = np.zeros((total_ticks, n), np.int64)
    for t0 in inject:
        for dt in range(v * n):
            chunk_tbl[t0 + dt, dt % n] = dt // n
    inject_at = {t0: j for j, t0 in enumerate(inject)}
    finish_at = {t0 + v * n - 1: j for j, t0 in enumerate(inject)}
    specs = pipeline_specs(pipe_axis, cfg.tie_embeddings)
    idx = mesh.coord(pipe_axis)

    def loss_fn(p, tokens, targets):
        b, s = tokens.shape
        mb = b // m_micro
        toks_mb = tokens.reshape(m_micro, mb, s)
        tgts_mb = targets.reshape(m_micro, mb, s)
        dev = tokens.device
        first = torch.tensor(idx == 0, device=dev)
        last = 1.0 if idx == n - 1 else 0.0
        names = list(p["blocks"])
        layers = [dict(zip(names, vals)) for vals in
                  zip(*(p["blocks"][k].unbind(0) for k in names))]

        def stage(x, chunk):
            for bp in layers[chunk * lpc:(chunk + 1) * lpc]:
                x, _ = model._block(x, bp, (None, None))
            return x

        def head_loss(x, tg):
            x = layer_norm(x, p["lnf_g"], p["lnf_b"])
            head = p["embed"].T if cfg.tie_embeddings else p["head"]
            logp = torch.log_softmax(x @ head, dim=-1)
            return -logp.gather(-1, tg.long()[..., None]).mean()

        h = torch.zeros(mb, s, cfg.dim, device=dev)
        total = torch.zeros((), device=dev)
        for t in range(total_ticks):
            x_in = h
            if t in inject_at:  # rank 0's slot is free this tick
                tk = toks_mb[inject_at[t]].long()
                x_in = torch.where(first, p["embed"][tk] + p["pos"][:s], h)
            y = stage(x_in, int(chunk_tbl[t, idx]))
            if t in finish_at:  # a microbatch leaves chunk v-1 at n-1
                total = total + head_loss(y, tgts_mb[finish_at[t]]) * last
            if t != total_ticks - 1:
                h = ppermute(y, pipe_axis)
        # the last stage's loss on every stage (identity backward)
        return tp_reduce(total, pipe_axis) / m_micro

    def step(params, slots, tokens, targets, lr, stepno, rng=None):
        leaves = tree_leaves(params)
        if dp_axis:
            nd = mesh.shape[dp_axis]
            tokens = tokens.chunk(nd, 0)[mesh.coord(dp_axis)]
            targets = targets.chunk(nd, 0)[mesh.coord(dp_axis)]
        if tokens.shape[0] % m_micro:
            raise ValueError(f"batch {tokens.shape[0]} does not divide "
                             f"into {m_micro} microbatches")
        with bind(mesh):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = loss_fn(p, tokens, targets)
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
            loss = loss.detach().clone()
            # replicated leaves are used on different stages → sum
            psum_leaves([g for g, sp in zip(grads, _zip_specs(specs, p))
                         if not any(a is not None for a in sp)], pipe_axis)
            if dp_axis:
                psum_leaves(grads + [loss], dp_axis, mean=True)
        method.update(grads, leaves, slots, lr, stepno)
        return params, slots, loss

    step.bubble_fraction = interleaved_bubble_fraction(n, m_micro, v)
    step.specs = specs
    logger.info("pipeline schedule: %d stages x %d microbatches x %d "
                "virtual, bubble fraction %.3f%s", n, m_micro, v,
                step.bubble_fraction, "" if v > 1 else " (GPipe)")
    return step
