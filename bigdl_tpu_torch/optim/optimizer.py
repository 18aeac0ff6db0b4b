"""Optimizer front-end and the single-host training loop.

Ports `Optimizer` and `LocalOptimizer` from bigdl_tpu/optim/optimizer.py
(reference: optim/Optimizer.scala, optim/LocalOptimizer.scala). The
builder keeps the JAX package's surface:

    Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
              batch_size=8).set_optim_method(Adam(3e-4)) \\
        .set_precision("bf16").set_end_when(Trigger.max_iteration(10)) \\
        .optimize()

Where the JAX package jits one pure step, a step here is eager
PyTorch: the loss (ops/losses.build_train_loss, so
nn.ChunkedSoftmaxCE fuses into the model), `torch.autograd.grad` with
respect to the fp32 master weights, clipping, then the optim method's
in-place update. The run loop keeps the JAX package's train state
(`epoch`, `neval`, `nupdates`, `records`, `loss`), evaluates the
schedule per step, rolls epochs over by records seen, and fetches
step N's loss for the log line only after step N+1 is enqueued, so
the host never waits on the card mid-loop.

Ported: `set_optim_method`, `set_end_when`, `set_precision`,
`set_constant_gradient_clipping`, `set_gradient_clipping_by_l2_norm`,
`set_validation` and `optimize`. When the validation trigger fires
after a step, the loop runs the model over the validation set under
`torch.no_grad()` in the compute dtype (outputs cast back to the
output dtype), logs each method's result, keeps the first method's
value in `train_state["score"]` (a schedule with `on_metric` sees it)
and all of them, by method name, in `train_state["validation"]` —
where an end trigger can read them. Checkpoints and resume, gradient
accumulation, the anomaly guard and fault plans, summaries and obs
telemetry, and `set_mesh` raise NotImplementedError; ROADMAP.md queues
them.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.ops.losses import build_train_loss
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED, Policy

logger = logging.getLogger("bigdl_tpu_torch.optim")


def _not_ported(what: str, queue: str = "A.5"):
    raise NotImplementedError(
        f"Optimizer: {what} is not ported to bigdl_tpu_torch yet "
        f"(ROADMAP.md, queue {queue})")


def _batch_iterator(dataset: AbstractDataSet, train: bool,
                    batch_size: Optional[int]):
    """MiniBatches from a dataset that yields Samples or MiniBatches."""
    it = dataset.data(train=train)
    first = next(it, None)
    if first is None:
        return iter(())
    chained = itertools.chain([first], it)
    if isinstance(first, MiniBatch):
        return chained
    if batch_size is None:
        raise ValueError("dataset yields Samples; batch_size is required")
    return SampleToMiniBatch(batch_size)(chained)


def _to_device(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_to_device(e, device) for e in x)
    return torch.as_tensor(x).to(device)


class Optimizer:
    """Builder facade (reference: optim/Optimizer.scala#Optimizer.apply).
    Training runs on the device of the model's parameters."""

    def __init__(self, model: Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: Optional[int] = None,
                 seed: int = 42):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.seed = seed
        self.optim_method: OptimMethod = SGD(learningrate=1e-2)
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.grad_clip_const: Optional[tuple] = None
        self.grad_clip_norm: Optional[float] = None
        self.precision: Optional[Policy] = None  # None → full fp32
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: List[ValidationMethod] = []
        self.validation_batch_size: Optional[int] = None

    # ------------------------------------------------------- builder surface
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_precision(self, policy) -> "Optimizer":
        """Mixed precision: a `utils.precision.Policy`, or "bf16" /
        "mixed" (bf16 compute, fp32 master weights) or "fp32"."""
        if isinstance(policy, str):
            policy = {"bf16": DEFAULT_MIXED, "mixed": DEFAULT_MIXED,
                      "fp32": None}[policy]
        elif policy is not None and not isinstance(policy, Policy):
            raise TypeError(f"expected Policy or str, got {type(policy)}")
        self.precision = policy
        return self

    def set_constant_gradient_clipping(self, min_v: float,
                                       max_v: float) -> "Optimizer":
        self.grad_clip_const = (min_v, max_v)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        self.grad_clip_norm = clip_norm
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        self.validation_batch_size = batch_size or self.batch_size
        return self

    def set_checkpoint(self, *args, **kwargs) -> "Optimizer":
        _not_ported("checkpointing (set_checkpoint)")

    def resume_from_checkpoint(self) -> "Optimizer":
        _not_ported("resume (resume_from_checkpoint)")

    def set_train_summary(self, summary) -> "Optimizer":
        _not_ported("train summaries (set_train_summary)")

    def set_validation_summary(self, summary) -> "Optimizer":
        _not_ported("validation summaries (set_validation_summary)")

    def set_gradient_accumulation(self, n: int) -> "Optimizer":
        _not_ported("gradient accumulation (set_gradient_accumulation)")

    def set_anomaly_guard(self, *args, **kwargs) -> "Optimizer":
        _not_ported("the anomaly guard (set_anomaly_guard)")

    def set_mesh(self, *args, **kwargs) -> "Optimizer":
        _not_ported("distributed training (set_mesh, DistriOptimizer)",
                    "A.8")

    def optimize(self) -> Module:
        return LocalOptimizer(self).run()


class LocalOptimizer:
    """Single-device eager training loop (reference:
    optim/LocalOptimizer.scala)."""

    def __init__(self, opt: Optimizer):
        self.o = opt
        self.metrics = Metrics()

    def _make_step(self, slots: Dict[str, Any]) -> Callable:
        o = self.o
        method = o.optim_method
        clip_const, clip_norm = o.grad_clip_const, o.grad_clip_norm
        loss_call = build_train_loss(o.model, o.criterion, o.precision)

        def step(params, leaves, mod_state, bx, by, lr, stepno, rng):
            loss, new_state = loss_call(params, mod_state, bx, by, rng)
            grads = list(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                if clip_const is not None:
                    torch._foreach_clamp_min_(grads, clip_const[0])
                    torch._foreach_clamp_max_(grads, clip_const[1])
                if clip_norm is not None:
                    gnorm = torch.stack(
                        [(g.float() * g.float()).sum() for g in grads]
                    ).sum().sqrt()
                    scale = (clip_norm / gnorm.clamp_min(1e-12)).clamp_max(
                        1.0)
                    torch._foreach_mul_(grads, scale)
                method.update(grads, leaves, slots, lr, stepno)
            return loss.detach(), new_state

        return step

    def run(self) -> Module:
        o = self.o
        variables = dict(o.model.variables)  # existing build or default init
        params = tree_map(lambda t: t.detach().clone().requires_grad_(
            t.is_floating_point()), variables["params"])
        leaves = [t for t in tree_leaves(params) if t.requires_grad]
        if not leaves:
            raise ValueError(f"{o.model!r} has no trainable parameters")
        device = leaves[0].device
        slots = o.optim_method.init_slots(leaves)
        step = self._make_step(slots)
        train_state: Dict[str, Any] = {"epoch": 1, "neval": 0,
                                       "nupdates": 0, "records": 0,
                                       "loss": None, "score": None}
        dataset_size = o.dataset.size()
        batches = _batch_iterator(o.dataset, True, o.batch_size)
        pending = None  # step N's telemetry, emitted after step N+1
        epoch_start = iter_start = time.perf_counter()

        while not o.end_when(train_state):
            with Timer(self.metrics, "data_fetch_s"):
                mb = next(batches)
            lr = o.optim_method.current_rate(train_state)
            # per-step dropout stream, the counterpart of fold_in(rng, neval)
            rng = torch.Generator(device=device).manual_seed(
                o.seed * 1_000_003 + train_state["neval"])
            with Timer(self.metrics, "dispatch_s"):
                loss, variables["state"] = step(
                    params, leaves, variables["state"],
                    _to_device(mb.input, device),
                    _to_device(mb.target, device), lr,
                    train_state["nupdates"], rng)
            # `loss` stays on the device: it is read one step late
            real = getattr(mb, "real_size", mb.size)
            train_state["neval"] += 1
            train_state["nupdates"] += 1
            train_state["records"] += real
            train_state["loss"] = loss
            now = time.perf_counter()
            iter_wall, iter_start = now - iter_start, now
            self.metrics.add("iter_s", iter_wall)
            if pending is not None:
                self._emit(pending)
            pending = (dict(train_state), loss, lr,
                       real / max(iter_wall, 1e-9))

            # epoch rollover (the reference counts records vs dataset size)
            if train_state["records"] >= dataset_size:
                train_state["epoch"] += 1
                train_state["records"] = 0
                logger.info("epoch %d done in %.1fs",
                            train_state["epoch"] - 1,
                            time.perf_counter() - epoch_start)
                epoch_start = time.perf_counter()

            if (o.validation_trigger is not None
                    and o.validation_trigger(train_state)):
                res = self._validate(params, variables["state"])
                for name, r in res.items():
                    v, n = r.result()
                    logger.info("validation %s = %.6f (%d)", name, v, n)
                train_state["validation"] = res
                first = next(iter(res.values()), None)
                if first is not None:
                    train_state["score"] = first.result()[0]
                    sched = o.optim_method.schedule
                    if hasattr(sched, "on_metric"):
                        sched.on_metric(train_state["score"])

        if pending is not None:
            self._emit(pending)
        o.model.variables = {"params": tree_map(lambda t: t.detach(),
                                                params),
                             "state": variables["state"]}
        return o.model

    def _validate(self, params, mod_state
                  ) -> Dict[str, ValidationResult]:
        """The validation methods over the validation set, the forward
        under torch.no_grad() in the compute dtype."""
        # imported here: the evaluator imports this module's batching
        from bigdl_tpu_torch.optim.evaluator import evaluate

        o = self.o
        return evaluate(o.model, o.validation_dataset, o.validation_methods,
                        o.validation_batch_size,
                        {"params": params, "state": mod_state}, o.precision)

    def _emit(self, pending) -> None:
        """The log line of an already-enqueued step; `float(loss)` here
        is the host's wait for step N, taken after step N+1 is queued."""
        state, loss, lr, throughput = pending
        logger.info("epoch %d iteration %d: loss %.6f lr %.3g "
                    "%.1f records/s %s", state["epoch"], state["neval"],
                    float(loss), lr, throughput, self.metrics.summary())
