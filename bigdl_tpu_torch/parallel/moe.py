"""Mixture-of-Experts with expert parallelism over a mesh axis.

Ports bigdl_tpu/parallel/moe.py (no reference counterpart; the
`expert` mesh axis). The routing is the JAX package's, decision for
decision:

    gates    = softmax(x @ router)                 (T, E)
    top_k=1  Switch: expert = argmax(gates); capacity
             max(1, int(cf · k · T / E)); a token's slot is its position
             among the expert's tokens (a cumsum over the one-hot), and
             a token past capacity is dropped (its output is 0)
    top_k=2  GShard: the second choice is the argmax with the first
             masked; second choices queue behind ALL first choices of
             their expert (dropped ones included); the two gates are
             renormalised over the choices that survived, so a dropped
             second choice leaves the first at full weight
    aux      the Switch load-balancing loss from the first choice:
             E · sum(fraction routed · mean gate)
    expert_choice  each expert takes its top-C tokens by affinity
             (C = max(1, min(T, int(cf · T / E)))), the affinity is the
             combine weight, aux = 0 — balanced by construction, and
             not causally masked (an expert's choice reads the whole
             sequence)

The dispatch differs in form, not in value. The JAX package dispatches
with dense one-hot tensors, dispatch/combine (T, E, C) and two einsums;
at the MoE LM's card size (T = 16384 tokens, E = 8, C = 5120) each is
2.7 GB a layer, and autograd would keep both for the backward. Here a
kept token's slot is an index `e·C + c`: the expert inputs are a
scatter (`index_copy`) of the token rows into an (E·C, D) buffer, and
the output a gather of the slots weighted by the gates. The one-hot
einsum sums a single non-zero term per (token, slot), so the values
are the same.

`_experts` is a batched matmul (`torch.bmm`) with the tanh GELU that
`jax.nn.gelu` computes by default. With `expert_axis` set (and a mesh
bound, parallel/collectives.bind) the experts are sharded over that
axis: the (E, C, D) buffer goes through `all_to_all` so each rank runs
its E/n experts on every rank's tokens, and a second `all_to_all`
brings the outputs home. The aux is this rank's tokens' only; callers
average it over the axis.

Ties: `torch.argmax` takes the first maximum, as `jnp.argmax` does;
`torch.topk` and `lax.top_k` may order equal scores differently.
Seeded random gates make ties improbable, and the tests rely on that.

Gates are computed in fp32 whatever the compute dtype (a bf16 softmax
would tie experts often enough to change routing decisions between two
runs of the same model); the combine weights are cast to the expert
output's dtype.

`moe_specs`, `moe_lm_specs` and `make_moe_lm_train_step` are the
expert-parallel training step of a MoE-FFN TransformerLM: the expert
axis doubles as the batch axis, each rank's local loss is its token
mean divided by the axis size (summed over ranks the global mean), the
expert-sharded leaves' gradients arrive whole through the all_to_all
transposes and the replicated leaves' (router, attention, embeddings)
are summed over the axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.collectives import (all_to_all, axis_size,
                                                  bind, psum_leaves)
from bigdl_tpu_torch.parallel.tensor_parallel import (P, _zip_specs,
                                                      step_generator,
                                                      transformer_tp_specs)

__all__ = ["MoE", "moe_specs", "moe_lm_specs", "make_moe_lm_train_step"]


class MoE(Module):
    """Top-1 (Switch) / top-2 (GShard) / expert-choice MoE
    feed-forward layer.

    apply(variables, x (..., T, D)) → ((y (..., T, D), aux_loss),
    state). With `expert_axis` set, apply() must run with a mesh bound
    (parallel/collectives.bind) holding that axis; the expert-stacked
    params (leading dim num_experts) are then this rank's
    num_experts / axis_size experts."""

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = None, top_k: int = 1,
                 routing: str = "top_k",
                 name: Optional[str] = None):
        super().__init__(name=name)
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        if routing not in ("top_k", "expert_choice"):
            raise ValueError(
                f"routing must be top_k|expert_choice, got {routing!r}")
        if routing == "expert_choice" and top_k != 1:
            raise ValueError(
                "top_k has no meaning under expert_choice routing "
                "(experts pick tokens; capacity_factor is the knob) — "
                "leave top_k=1")
        self.dim = dim
        self.hidden = hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.expert_axis = expert_axis
        self.top_k = top_k
        self.routing = routing
        # the last call's routing record: tokens, capacity, each
        # choice's expert per token and the dropped choices (tensors,
        # recorded without a host sync)
        self.last_route: Dict[str, Any] = {}

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        e, d, f = self.num_experts, self.dim, self.hidden
        init = Xavier()
        return {
            "router": init(g, (d, e), fan_in=d, fan_out=e),
            "w1": init(g, (e, d, f), fan_in=d, fan_out=f),
            "b1": torch.zeros(e, f),
            "w2": init(g, (e, f, d), fan_in=f, fan_out=d),
            "b2": torch.zeros(e, d),
        }

    # ------------------------------------------------------------ routing
    def capacity(self, t: int) -> int:
        if self.routing == "expert_choice":
            return max(1, min(t, int(self.capacity_factor * t
                                     / self.num_experts)))
        return max(1, int(self.capacity_factor * self.top_k * t
                          / self.num_experts))

    def _route(self, x2: torch.Tensor, router: torch.Tensor):
        """x2: (T, D) → (slots, weights, aux, cap): for each choice a
        (T,) slot index e·cap + c (-1 where dropped) and its (T,) fp32
        combine weight."""
        t = x2.shape[0]
        e = self.num_experts
        cap = self.capacity(t)
        gates = torch.softmax((x2 @ router).float(), dim=-1)    # (T, E)

        def choice_slot(expert, offset):
            """(slot (T,), keep (T,) bool) for one choice, given per-
            expert queue offsets (E,) from earlier choices: a token's
            position among its expert's tokens, by a cumsum over the
            one-hot laid out (E, T) so the scan runs along the inner
            dim (along the outer one a GPU scans each of the E columns
            alone: 3 ms a call at T = 16384 on the card)."""
            onehot = F.one_hot(expert, e).T.contiguous()         # (E, T)
            pos = onehot.cumsum(1).gather(0, expert[None])[0] - 1 \
                + offset[expert]
            keep = pos < cap
            return torch.where(keep, expert * cap + pos,
                               torch.full_like(pos, -1)), keep

        def gate_of(expert):
            return gates.gather(1, expert[:, None])[:, 0]

        e1 = gates.argmax(-1)
        oh1 = F.one_hot(e1, e)
        s1, keep1 = choice_slot(e1, torch.zeros(e, dtype=torch.long,
                                                device=x2.device))
        g1 = gate_of(e1) * keep1
        # Switch load-balancing aux from the first choice (both modes)
        frac = oh1.float().mean(0)
        aux = (frac * gates.mean(0)).sum() * e
        record = {"tokens": t, "capacity": cap, "experts": (e1,),
                  "dropped_first": (~keep1).sum()}
        if self.top_k == 1:
            self.last_route = record
            return (s1,), (g1,), aux, cap
        e2 = (gates * (1 - oh1)).argmax(-1)
        s2, keep2 = choice_slot(e2, oh1.sum(0))
        g2 = gate_of(e2) * keep2
        # renormalise over the surviving choices
        denom = g1 + g2 + 1e-9
        record["dropped_second"] = (~keep2).sum()
        record["experts"] = (e1, e2)
        self.last_route = record
        return (s1, s2), (g1 / denom, g2 / denom), aux, cap

    def _experts(self, p, xin: torch.Tensor) -> torch.Tensor:
        """xin: (E_local, C_tot, D) → the same shape through each
        expert."""
        h = torch.bmm(xin, p["w1"]) + p["b1"][:, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, p["w2"]) + p["b2"][:, None, :]

    def _run_experts(self, p, xin: torch.Tensor, cap: int) -> torch.Tensor:
        """(E, cap, D) token buffer → (E, cap, D) expert outputs, the
        experts local or sharded over `expert_axis`."""
        if self.expert_axis is None:
            return self._experts(p, xin)
        axis = self.expert_axis
        n = axis_size(axis)
        e_local = p["w1"].shape[0]
        if e_local * n != self.num_experts:
            raise ValueError(
                f"num_experts {self.num_experts} != {e_local}·{n}")
        d = self.dim
        # (n, e_local, C, D): slice j to rank j
        xin = all_to_all(xin.reshape(n, e_local, cap, d), axis, 0, 0)
        xin = xin.transpose(0, 1).reshape(e_local, n * cap, d)
        yout = self._experts(p, xin)                  # (e_local, nC, D)
        yout = yout.reshape(e_local, n, cap, d).transpose(0, 1)
        yout = all_to_all(yout.contiguous(), axis, 0, 0)
        return yout.reshape(self.num_experts, cap, d)

    def apply(self, variables, x, training=False, rng=None):
        p = variables["params"]
        shape = x.shape
        x2 = x.reshape(-1, self.dim)
        t, d = x2.shape
        e = self.num_experts
        if self.routing == "expert_choice":
            cap = self.capacity(t)
            scores = torch.softmax((x2 @ p["router"]).float(), dim=-1)
            g, idx = torch.topk(scores.T, cap, dim=-1)        # (E, C)
            xin = x2.index_select(0, idx.reshape(-1)).reshape(e, cap, d)
            yout = self._run_experts(p, xin, cap)
            y = torch.zeros_like(x2).index_add(
                0, idx.reshape(-1),
                (yout * g[..., None].to(yout.dtype)).reshape(-1, d))
            self.last_route = {"tokens": t, "capacity": cap}
            aux = x2.new_zeros((), dtype=torch.float32)
            return (y.reshape(shape), aux), variables.get("state", {})

        slots, weights, aux, cap = self._route(x2, p["router"])
        # dropped tokens are written to one spare row past the buffer
        # (any of them may land there; the row is never read), so the
        # dispatch needs no host sync to count the kept tokens
        xin = x2.new_zeros(e * cap + 1, d)
        for s in slots:
            xin = xin.index_copy(0, torch.where(s >= 0, s, e * cap), x2)
        yout = self._run_experts(p, xin[:-1].reshape(e, cap, d), cap)
        yout = torch.cat([yout.reshape(e * cap, d),
                          yout.new_zeros(1, d)])    # dropped: a zero row
        # index_select, whose backward is an index_add (advanced
        # indexing's sorts its indices: 92 ms a step on the card)
        y = sum(yout.index_select(0, torch.where(s >= 0, s, e * cap))
                * w[:, None].to(yout.dtype) for s, w in zip(slots, weights))
        return (y.reshape(shape), aux), variables.get("state", {})


def moe_specs(expert_axis: str = "expert") -> Dict[str, P]:
    """PartitionSpecs for MoE params (experts stacked on the lead dim)."""
    return {"router": P(),
            "w1": P(expert_axis, None, None), "b1": P(expert_axis, None),
            "w2": P(expert_axis, None, None), "b2": P(expert_axis, None)}


def moe_lm_specs(ep_axis: str, tie_embeddings: bool = True):
    """PartitionSpecs for a MoE-FFN TransformerLM's params: the expert-
    stacked block leaves (L, EX, ...) sharded on the expert dim, all
    else replicated — transformer_tp_specs' key structure with
    moe_specs' expert layout, the layer dim prepended."""
    base = transformer_tp_specs("unused_axis", tie_embeddings)
    specs = tree_map(lambda _: P(), base)
    specs["blocks"].update({
        k: (P() if k == "router" else P(None, *tuple(s)))
        for k, s in moe_specs(ep_axis).items()})
    return specs


def make_moe_lm_train_step(model, method, mesh,
                           ep_axis: str = "expert") -> Callable:
    """The expert-parallel training step of a MoE-FFN TransformerLM:

        step(params, slots, tokens, targets, lr, stepno, rng)
            -> (params', slots', mean_loss)

    params/slots: this rank's shard (`shard_params(mesh,
    moe_lm_specs(...), tree)`; slots `{name: [tensors]}` in the params'
    leaf order, `method.init_slots`), updated in place and returned;
    tokens/targets: the global (B, S) batch every rank holds alike —
    this rank trains its rows (the expert axis doubles as the batch
    axis); `rng`: an int seed or None, folded with the expert index
    (dropout). The model must be built with ep_axis=<axis>."""
    if getattr(model, "ep_axis", None) != ep_axis:
        raise ValueError(
            f"model.ep_axis={getattr(model, 'ep_axis', None)!r} != "
            f"step ep_axis={ep_axis!r}")
    if model.tp_axis is not None or model.sp_axis is not None:
        raise NotImplementedError(
            "the EP step runs on a pure expert mesh (the expert axis "
            "doubles as the batch axis); tp/sp composition is not "
            "implemented")
    n = mesh.shape[ep_axis]
    me = mesh.coord(ep_axis)
    specs = moe_lm_specs(ep_axis, model.cfg.tie_embeddings)

    def step(params, slots, tokens, targets, lr, stepno, rng=None):
        leaves = tree_leaves(params)
        b = tokens.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide by the "
                             f"{ep_axis!r} axis size {n}")
        rows = slice(me * (b // n), (me + 1) * (b // n))
        gen = step_generator(rng, me, leaves[0].device)
        with bind(mesh):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            # local token-mean / n: sums to the global mean over ranks
            local = model.loss({"params": p, "state": {}}, tokens[rows],
                               targets[rows], training=True, rng=gen) / n
            grads = torch.autograd.grad(local, tree_leaves(p))
            # replicated leaves: per-rank partials → sum; expert-sharded
            # leaves are whole already (the all_to_all transposes)
            psum_leaves([g for g, s in zip(grads, _zip_specs(specs, params))
                         if not any(a is not None for a in s)], ep_axis)
            loss = local.detach().clone()
            psum_leaves([loss], ep_axis)
        method.update(list(grads), leaves, slots, lr, stepno)
        return params, slots, loss

    step.specs = specs
    return step
