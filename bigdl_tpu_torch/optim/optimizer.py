"""Optimizer front-end and the single-host training loop.

Ports `Optimizer` and `LocalOptimizer` from bigdl_tpu/optim/optimizer.py
(reference: optim/Optimizer.scala, optim/LocalOptimizer.scala). The
builder keeps the JAX package's surface:

    Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
              batch_size=8).set_optim_method(Adam(3e-4)) \\
        .set_precision("bf16").set_end_when(Trigger.max_iteration(10)) \\
        .set_checkpoint("/ckpt", Trigger.several_iteration(1000)) \\
        .optimize()

Where the JAX package jits one pure step, a step here is eager
PyTorch: the loss (ops/losses.build_train_loss, so
nn.ChunkedSoftmaxCE fuses into the model), `torch.autograd.grad` with
respect to the fp32 master weights, clipping, then the optim method's
in-place update. The run loop keeps the JAX package's train state
(`epoch`, `neval`, `nupdates`, `records`, `loss`), evaluates the
schedule per update, rolls epochs over by records seen, and fetches
step N's loss for the log line and the summaries only after step N+1
is enqueued, so an unguarded loop never waits on the card mid-run.

Ported:
- `set_optim_method`, `set_end_when`, `set_precision`,
  `set_constant_gradient_clipping`, `set_gradient_clipping_by_l2_norm`,
  the attribute `log_every`, and `optimize`;
- `set_validation`: after a step that fires the trigger, the model runs
  over the validation set under `torch.no_grad()` in the compute dtype;
  each method's result is logged (and written to the validation
  summary), the first method's value is kept in `train_state["score"]`
  (a schedule with `on_metric` sees it) and all of them, by name, in
  `train_state["validation"]`;
- `set_checkpoint(path, trigger, async_save=)` and
  `resume_from_checkpoint`: the JAX package's checkpoint format
  (serialization/checkpoint.py; the port's flat slot lists are saved
  as trees shaped like the params and flattened again at load), with
  the train state and a mid-cycle accumulator; resume fast-forwards the
  deterministic batch stream (`_batch_iterator(skip=)`), so a resumed
  run sees the batches the uninterrupted run would have;
- `set_gradient_accumulation(n)`: grads-only micro-steps summed into an
  fp32 accumulator, the mean applied every n-th micro-batch, a partial
  cycle flushed when the end trigger fires mid-cycle;
- `set_anomaly_guard`: the guarded step reads the loss's finiteness and
  the pre-clip gradient norm on the host before it updates in place, so
  an anomalous step leaves params, slots and module state bit for bit
  (`skip_step`), reloads the newest valid checkpoint (`rollback`) or
  raises (`halt`); schedules and Adam's step index advance per applied
  update (`nupdates`), never per micro-batch or discarded step;
- the fault points of utils/faults.py (`preempt`, `step`, `nan`,
  `data`, and the checkpoint's `ckpt_torn`/`ckpt_corrupt`);
- `set_train_summary`/`set_validation_summary` (visualization/): Loss,
  Throughput and LearningRate through obs/training.StepTelemetry, and
  parameter histograms under the summary's "Parameters" trigger;
- the training plane's telemetry (obs/): StepTelemetry's registry
  series and one `train_step` event a step, the phase stopwatches'
  `training_phase_seconds` and host spans, and a `preempted` event
  before a preemption propagates; all from host values the loop
  already holds, so telemetry adds no device read;
- `set_mesh(mesh, axis, zero)`: `optimize()` dispatches to
  parallel/distri_optimizer.DistriOptimizer (data parallelism with
  ZeRO-1/2); LocalOptimizer resumes its `zero1_flat`/`zero2_flat`
  checkpoints, unflattening the flat slots.

`set_checkpoint(sharded=True)` writes the ZeRO flat optimizer state as
per-shard units under a mesh (DistriOptimizer); a mesh-less run refuses
to write them, and resumes from them (the flat layout unflattens).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.models.convert import (tree_leaves,
                                            tree_leaves_with_path, tree_map,
                                            tree_unflatten)
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.obs.training import StepTelemetry
from bigdl_tpu_torch.ops.losses import build_train_loss
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.serialization.checkpoint import Checkpoint
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.anomaly import (AnomalyError, AnomalyGuard,
                                           global_norm, health_ok)
from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED, Policy

logger = logging.getLogger("bigdl_tpu_torch.optim")


def _batch_iterator(dataset: AbstractDataSet, train: bool,
                    batch_size: Optional[int], skip: int = 0):
    """MiniBatches from a dataset that yields Samples or MiniBatches.

    `skip` fast-forwards past the first `skip` batches (resume): the
    training stream replays deterministic epoch permutations from its
    seed, so skipping the batches a checkpointed run consumed re-aligns
    it. Samples are skipped without stacking. A training stream passes
    through the `data@<position>` fault point at global stream position
    skip + local index; the skipped batches do not fire it."""
    it = dataset.data(train=train)
    first = next(it, None)
    if first is None:
        return iter(())
    chained = itertools.chain([first], it)
    if isinstance(first, MiniBatch):
        for _ in range(skip):
            next(chained, None)
        return _fault_gate(chained, skip) if train else chained
    if batch_size is None:
        raise ValueError("dataset yields Samples; batch_size is required")
    for _ in range(skip * batch_size):
        next(chained, None)
    batched = SampleToMiniBatch(batch_size)(chained)
    return _fault_gate(batched, skip) if train else batched


def _fault_gate(it, start: int):
    """A training batch stream with the `data` fault point."""
    def gen():
        pos = start
        for mb in it:
            faults.get_plan().maybe_raise("data", pos)
            pos += 1
            yield mb

    return gen()


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
        self.checkpoint: Optional[Checkpoint] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.train_summary = None
        self.validation_summary = None
        self.log_every = 1
        self.grad_accum = 1
        self.anomaly_guard: Optional[AnomalyGuard] = None
        self.mesh = None
        self.mesh_axis = "data"
        self.mesh_zero = 1
        self.train_state: Optional[Dict[str, Any]] = None  # after optimize()
        self._resume = False

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

    def set_checkpoint(self, path: str, trigger: Trigger,
                       sharded: bool = False,
                       async_save: bool = False) -> "Optimizer":
        """Save a checkpoint under `path` whenever `trigger` fires after
        a step; `async_save=True` moves the disk writes to a background
        thread (the host snapshot stays on the loop's thread).
        `sharded=True` saves the ZeRO flat optimizer state as per-shard
        units with a manifest-last publish (mesh runs only; resume
        reshards across world sizes)."""
        self.checkpoint = Checkpoint(path, sharded=sharded,
                                     async_save=async_save)
        self.checkpoint_trigger = trigger
        return self

    def resume_from_checkpoint(self) -> "Optimizer":
        """Continue from the newest valid checkpoint under the checkpoint
        path, if there is one (reference: Optimizer resume)."""
        self._resume = True
        return self

    @staticmethod
    def _coerce_summary(summary, cls):
        if isinstance(summary, str):
            return cls(summary, "bigdl_tpu_torch")
        if not hasattr(summary, "add_scalar"):
            raise TypeError(
                f"expected a {cls.__name__} (or a logdir string), got "
                f"{type(summary).__name__}")
        return summary

    def set_train_summary(self, summary) -> "Optimizer":
        from bigdl_tpu_torch.visualization import TrainSummary

        self.train_summary = self._coerce_summary(summary, TrainSummary)
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        from bigdl_tpu_torch.visualization import ValidationSummary

        self.validation_summary = self._coerce_summary(summary,
                                                       ValidationSummary)
        return self

    def set_gradient_accumulation(self, n: int) -> "Optimizer":
        """Accumulate gradients over `n` micro-batches before each
        update (effective batch n x batch_size)."""
        if n < 1:
            raise ValueError("accumulation steps must be >= 1")
        self.grad_accum = n
        return self

    def set_anomaly_guard(self, guard="skip_step", **kwargs) -> "Optimizer":
        """Arm the numeric-anomaly guard (utils/anomaly.py). `guard` is
        an AnomalyGuard, a policy string ('skip_step' | 'rollback' |
        'halt'; kwargs go to AnomalyGuard), or None to disarm."""
        if isinstance(guard, str):
            guard = AnomalyGuard(policy=guard, **kwargs)
        elif guard is not None and not isinstance(guard, AnomalyGuard):
            raise TypeError(
                f"expected AnomalyGuard, policy str or None, got "
                f"{type(guard).__name__}")
        elif kwargs:
            raise ValueError("kwargs only apply when guard is a policy str")
        self.anomaly_guard = guard
        return self

    def set_mesh(self, mesh, axis: str = "data",
                 zero: int = 1) -> "Optimizer":
        """Train data-parallel over a process mesh
        (parallel/mesh.make_mesh): `optimize()` then runs
        DistriOptimizer. `zero=2` also shards the fp32 master weights
        across the axis (bit for bit the ZeRO-1 result in fp32)."""
        if zero not in (1, 2):
            raise ValueError(f"zero must be 1 or 2, got {zero!r}")
        self.mesh = mesh
        self.mesh_axis = axis
        self.mesh_zero = zero
        return self

    def optimize(self) -> Module:
        try:
            if self.mesh is not None:
                from bigdl_tpu_torch.parallel.distri_optimizer import \
                    DistriOptimizer

                return DistriOptimizer(self, self.mesh, self.mesh_axis,
                                       zero=self.mesh_zero).run()
            if self.checkpoint is not None and self.checkpoint.sharded:
                raise ValueError(
                    "sharded checkpoints shard the ZeRO flat optimizer "
                    "state — they need a mesh (set_mesh); a local run "
                    "can still RESUME from one (the flat layout "
                    "unflattens)")
            return LocalOptimizer(self).run()
        except BaseException:
            # a dying run drains the background checkpoint writer, so a
            # restart never races a still-live write of this process; a
            # writer error here is secondary to the one propagating
            if self.checkpoint is not None:
                try:
                    self.checkpoint.wait()
                except Exception:
                    logger.exception("checkpoint writer failed while the "
                                     "run was dying")
            raise


def _matched(what: str, template, loaded) -> List[torch.Tensor]:
    """`loaded`'s leaves in `template`'s order, checked leaf by leaf:
    the same key paths and shapes."""
    want, got = tree_leaves_with_path(template), tree_leaves_with_path(loaded)
    if [p for p, _ in want] != [p for p, _ in got]:
        raise ValueError(
            f"checkpoint {what} tree does not match the model's: "
            f"{sorted(set(p for p, _ in want) ^ set(p for p, _ in got))[:4]}")
    for (path, t), (_, a) in zip(want, got):
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"checkpoint {what} leaf {path}: shape "
                             f"{tuple(a.shape)}, model {tuple(t.shape)}")
    return [a for _, a in got]


class LocalOptimizer:
    """Single-device eager training loop (reference:
    optim/LocalOptimizer.scala)."""

    # a step exception reloads the newest checkpoint this many times in
    # a row before it propagates (DistriOptimizer sets it)
    max_retries = 0
    # whether this process writes the validation summary
    writer = True
    # whether a run that raises records its last completed step first
    # (DistriOptimizer sets it: the JAX DistriOptimizer records each step
    # as it completes, where this loop records a step one step late)
    record_on_raise = False

    def __init__(self, opt: Optimizer):
        self.o = opt
        self.metrics = Metrics()
        self.telemetry = StepTelemetry(summary=opt.train_summary,
                                       log_every=opt.log_every)

    # ---------------------------------------------------------- the step
    def _make_step(self, leaves: List[torch.Tensor],
                   slots: Dict[str, Any]) -> Callable:
        """`step(params, mod_state, bx, by, lr, stepno, rng, max_gnorm)
        -> (loss, new_state, ok, gnorm)`: updates `leaves` and `slots`
        in place. `ok`/`gnorm` are host values read on a guarded step
        (True/None otherwise); an anomalous step returns the old module
        state and updates nothing. With accumulation the step carries
        `flush`, `micro_state`, `restore_micro` and `clear_micro`."""
        o = self.o
        method = o.optim_method
        clip_const, clip_norm = o.grad_clip_const, o.grad_clip_norm
        accum = o.grad_accum
        guarded = o.anomaly_guard is not None
        loss_call = build_train_loss(o.model, o.criterion, o.precision)

        def grads_of(params, mod_state, bx, by, rng):
            loss, new_state = loss_call(params, mod_state, bx, by, rng)
            grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), new_state, grads

        @torch.no_grad()
        def health(loss, grads, max_gnorm):
            """ok and the pre-clip norm, in one read by the host."""
            gnorm = global_norm(grads)
            ok = health_ok(loss, gnorm, max_gnorm)
            ok_f, gnorm_f = torch.stack([ok.to(gnorm.dtype), gnorm]).tolist()
            return bool(ok_f), gnorm_f

        @torch.no_grad()
        def clip_and_update(grads, lr, stepno):
            if clip_const is not None:
                torch._foreach_clamp_min_(grads, clip_const[0])
                torch._foreach_clamp_max_(grads, clip_const[1])
            if clip_norm is not None:
                gnorm = torch.stack(
                    [(g.float() * g.float()).sum() for g in grads]
                ).sum().sqrt()
                scale = (clip_norm / gnorm.clamp_min(1e-12)).clamp_max(1.0)
                torch._foreach_mul_(grads, scale)
            method.update(grads, leaves, slots, lr, stepno)

        # gradient accumulation: grads-only micro-steps, the mean applied
        # every `accum`-th call; summed in fp32 and divided once, as the
        # JAX package's upd_fn does
        micro: Dict[str, Any] = {"acc": None, "n": 0}

        def apply_mean(lr, stepno, n):
            with torch.no_grad():
                mean = torch._foreach_div(micro["acc"], float(n))
            clip_and_update(mean, lr, stepno)
            micro["acc"], micro["n"] = None, 0

        def accumulate(grads, lr, stepno):
            if micro["acc"] is None:
                micro["acc"] = grads
            else:
                with torch.no_grad():
                    torch._foreach_add_(micro["acc"], grads)
            micro["n"] += 1
            if micro["n"] == accum:
                apply_mean(lr, stepno, accum)

        consume = clip_and_update if accum == 1 else accumulate

        def step(params, mod_state, bx, by, lr, stepno, rng,
                 max_gnorm=None):
            loss, new_state, grads = grads_of(params, mod_state, bx, by,
                                              rng)
            ok, gnorm = True, None
            if guarded:
                ok, gnorm = health(loss, grads, max_gnorm)
                if not ok:
                    # an anomalous step updates nothing and drops its
                    # module state; under accumulation its gradients
                    # never touch the accumulator and the cycle extends
                    # by one batch
                    return loss, mod_state, ok, gnorm
            consume(grads, lr, stepno)
            return loss, new_state, ok, gnorm

        if accum == 1:
            return step

        def flush(lr, stepno):
            """Apply a pending partial accumulator (end trigger fired
            mid-cycle): the mean over the micro-batches actually seen."""
            if micro["n"]:
                apply_mean(lr, stepno, micro["n"])

        def restore_micro(acc, n):
            """Reinstall a checkpointed mid-cycle accumulator. A cycle
            from a run with a larger grad_accum (n >= accum) would never
            complete: refuse it and restart the cycle."""
            if n >= accum:
                logger.warning(
                    "checkpointed accumulation cycle (%d micro-batches) "
                    "does not fit grad_accum=%d; discarding the partial "
                    "accumulator and restarting the cycle", n, accum)
                return
            micro["acc"], micro["n"] = acc, n

        step.flush = flush
        step.micro_state = lambda: (micro["acc"], micro["n"])
        step.restore_micro = restore_micro
        step.clear_micro = lambda: micro.update(acc=None, n=0)
        return step

    # -------------------------------------------------------- checkpoints
    def _require_rollback_checkpoint(self) -> None:
        """The 'rollback' policy has nothing to roll back to without a
        saved checkpoint."""
        o = self.o
        if o.checkpoint is None or not o.checkpoint.latest():
            raise AnomalyError(
                "anomaly policy 'rollback' needs a checkpoint "
                "(set_checkpoint) with at least one save; none found")

    @staticmethod
    def _as_tree(params, flat: List[torch.Tensor]):
        """A list over the trainable leaves as a tree shaped like
        `params` (the JAX package's slot layout); a non-trainable leaf
        gets zeros."""
        it = iter(flat)
        return tree_unflatten(params, [
            next(it) if p.requires_grad else torch.zeros_like(p)
            for p in tree_leaves(params)])

    @staticmethod
    def _as_flat(what: str, params, tree) -> List[torch.Tensor]:
        """The inverse of `_as_tree`: a loaded tree's trainable leaves."""
        return [a for a, p in zip(_matched(what, params, tree),
                                  tree_leaves(params)) if p.requires_grad]

    # ---------------------------------------------------------------- run
    def run(self) -> Module:
        """The training loop of every optimizer. This class and
        DistriOptimizer differ only in the pieces below it: `_setup`,
        `_train_batches`, `_step_rng`, `_train_step`, `_rows`,
        `_load_checkpoint`, `_save`, `_validate`, `_param_tree`,
        `_flush`, `_final_params` and `_close`."""
        o = self.o
        self._setup()
        guard = o.anomaly_guard
        plan = faults.get_plan()
        # "nupdates" counts optimizer updates actually applied: the
        # schedule's and the optim method's step clock. Without the
        # guard it equals neval // grad_accum; with it, a discarded
        # update or micro-batch does not advance it
        train_state: Dict[str, Any] = {"epoch": 1, "neval": 0,
                                       "nupdates": 0, "records": 0,
                                       "loss": None, "score": None}

        def restore():
            """Reload the newest valid checkpoint (the reference's
            reload-last-checkpoint recovery)."""
            o.checkpoint.wait()  # surface any pending async-save error
            saved = self._load_checkpoint()
            train_state.update(saved)
            if "nupdates" not in saved:  # pre-counter checkpoint
                train_state["nupdates"] = \
                    train_state["neval"] // o.grad_accum

        pending = None  # step N's telemetry, emitted after step N+1
        try:
            if (o._resume and o.checkpoint is not None
                    and o.checkpoint.latest()):
                restore()
                logger.info("resumed from %s at %s",
                            o.checkpoint._last_loaded, train_state)
            dataset_size = o.dataset.size()
            batches = self._train_batches(train_state["neval"])
            epoch_start = iter_start = time.perf_counter()
            retries = 0

            while not o.end_when(train_state):
                try:
                    plan.maybe_preempt(train_state["neval"])
                except faults.Preempted:
                    # the worker is dead, not retryable: record the
                    # incident (a flight-recorder trigger) and let it
                    # propagate, outside the retry budget
                    obs.emit_event("preempted", plane="training",
                                   step=train_state["neval"])
                    raise
                try:
                    plan.maybe_raise("step", train_state["neval"])
                    with Timer(self.metrics, "data_fetch_s"):
                        mb = next(batches)
                    if plan.fires("nan", train_state["neval"]):
                        mb = faults.poison_minibatch(mb)
                    # schedules and the step index advance per applied
                    # update
                    eff_step = train_state["nupdates"]
                    lr = o.optim_method.current_rate(
                        train_state if o.grad_accum == 1 and guard is None
                        else {**train_state, "neval": eff_step})
                    rng = self._step_rng(train_state["neval"])
                    with Timer(self.metrics, "dispatch_s"):
                        loss, ok, gnorm, applied = self._train_step(
                            mb, lr, eff_step, rng,
                            None if guard is None else guard.threshold())
                except Exception:
                    if (retries < self.max_retries
                            and o.checkpoint is not None
                            and o.checkpoint.latest()):
                        retries += 1
                        logger.exception(
                            "step failed; recovering from checkpoint "
                            "(retry %d/%d)", retries, self.max_retries)
                        restore()
                        batches = self._train_batches(train_state["neval"])
                        continue
                    raise
                if guard is not None:
                    action = guard.observe(ok, gnorm, train_state["neval"])
                    if action == "rollback":
                        self._require_rollback_checkpoint()
                        restore()
                        batches = self._train_batches(train_state["neval"])
                        continue
                # a consecutive-failure budget, not a lifetime cap
                retries = 0
                # `loss` stays on the device: it is read one step late
                real = self._rows(mb)
                train_state["neval"] += 1
                train_state["nupdates"] += int(applied)
                train_state["records"] += real
                train_state["loss"] = loss
                now = time.perf_counter()
                iter_wall, iter_start = now - iter_start, now
                self.metrics.add("iter_s", iter_wall)
                if pending is not None:
                    self._emit(pending)
                # histograms are read here, before the next step updates
                # the params in place (a host sync, on the trigger's
                # steps only)
                hists = None
                if o.train_summary is not None:
                    pt = o.train_summary.get_summary_trigger("Parameters")
                    if pt is not None and pt(train_state):
                        hists = [(name, t.detach().to("cpu", copy=True)
                                  .numpy()) for name, t in
                                 o.model.parameters(
                                     {"params": self._param_tree()})]
                pending = (dict(train_state), loss, lr,
                           real / max(iter_wall, 1e-9), real, hists,
                           gnorm, ok)

                # epoch rollover (the reference counts records vs
                # dataset size)
                if train_state["records"] >= dataset_size:
                    train_state["epoch"] += 1
                    train_state["records"] = 0
                    logger.info("epoch %d done in %.1fs",
                                train_state["epoch"] - 1,
                                time.perf_counter() - epoch_start)
                    epoch_start = time.perf_counter()

                if (o.validation_trigger is not None
                        and o.validation_trigger(train_state)):
                    res = self._validate()
                    for name, r in res.items():
                        v, n = r.result()
                        logger.info("validation %s = %.6f (%d)", name, v, n)
                        if o.validation_summary is not None and self.writer:
                            o.validation_summary.add_scalar(
                                name, v, train_state["neval"])
                    train_state["validation"] = res
                    first = next(iter(res.values()), None)
                    if first is not None:
                        train_state["score"] = first.result()[0]
                        sched = o.optim_method.schedule
                        if hasattr(sched, "on_metric"):
                            sched.on_metric(train_state["score"])

                if (o.checkpoint is not None
                        and o.checkpoint_trigger is not None
                        and o.checkpoint_trigger(train_state)):
                    with Timer(self.metrics, "checkpoint_s"):
                        path = self._save(train_state)
                    logger.info("checkpoint -> %s", path)

            # the end trigger may fire mid-cycle: flush the partial
            # accumulator so those micro-batches' gradients count
            if o.grad_accum > 1:
                eff_step = train_state["nupdates"]
                self._flush(o.optim_method.current_rate(
                    {**train_state, "neval": eff_step}), eff_step)
            if pending is not None:
                self._emit(pending)
                pending = None
            if o.checkpoint is not None:
                # a failed async save must fail the run, not vanish with
                # the writer thread
                o.checkpoint.wait()
            for summary in (o.train_summary, o.validation_summary):
                if summary is not None:
                    summary.writer.flush()
            o.model.variables = {"params": self._final_params(),
                                 "state": self.mod_state}
        except BaseException:
            if self.record_on_raise and pending is not None:
                self._emit(pending)
            raise
        finally:
            self._close()
        o.train_state = train_state
        return o.model

    # ------------------------------------------------ this loop's pieces
    def _setup(self) -> None:
        """The weights (a param tree whose trainable leaves the step
        updates in place), the slots, the module state and the step."""
        o = self.o
        variables = dict(o.model.variables)  # existing build or default init
        self.params = tree_map(lambda t: t.detach().clone().requires_grad_(
            t.is_floating_point()), variables["params"])
        leaves = [t for t in tree_leaves(self.params) if t.requires_grad]
        if not leaves:
            raise ValueError(f"{o.model!r} has no trainable parameters")
        self.device = leaves[0].device
        self.slots = o.optim_method.init_slots(leaves)
        self.step = self._make_step(leaves, self.slots)
        self.mod_state = variables["state"]

    def _train_batches(self, skip: int):
        """The training batch stream, `skip` batches in."""
        return _batch_iterator(self.o.dataset, True, self.o.batch_size,
                               skip=skip)

    def _step_rng(self, neval: int) -> torch.Generator:
        """The step's dropout stream, the counterpart of
        fold_in(rng, neval)."""
        return torch.Generator(device=self.device).manual_seed(
            self.o.seed * 1_000_003 + neval)

    def _train_step(self, mb, lr, stepno, rng, max_gnorm):
        """One batch -> (loss, ok, gnorm, applied): `applied` when an
        optimizer update was applied (a good step, or the one that
        completes an accumulation cycle)."""
        loss, self.mod_state, ok, gnorm = self.step(
            self.params, self.mod_state, _to_device(mb.input, self.device),
            _to_device(mb.target, self.device), lr, stepno, rng, max_gnorm)
        if self.o.grad_accum == 1:
            return loss, ok, gnorm, ok
        # a completed cycle leaves the step's micro-batch count at 0
        return loss, ok, gnorm, ok and self.step.micro_state()[1] == 0

    def _rows(self, mb) -> int:
        """The records a batch trains on."""
        return getattr(mb, "real_size", mb.size)

    def _load_checkpoint(self) -> Dict[str, Any]:
        """Install the newest valid checkpoint's params, slots, module
        state and mid-cycle accumulator in place; returns its train
        state."""
        o, params, device = self.o, self.params, self.device
        loaded, slot_trees, saved, optim_meta = o.checkpoint.load(
            with_optim_meta=True)
        saved_accum = o.checkpoint.load_accum()
        if (optim_meta or {}).get("layout") in ("zero1_flat", "zero2_flat"):
            # a DistriOptimizer checkpoint: each slot (and a mid-cycle
            # accumulator) is one flat (padded,) vector over the whole
            # parameter set
            from bigdl_tpu_torch.parallel.param_layout import FlatParamSpec

            spec = FlatParamSpec(loaded["params"], optim_meta["num_shards"])
            slot_trees = {k: spec.unflatten(torch.as_tensor(v))
                          for k, v in slot_trees.items()}
            if saved_accum is not None:
                saved_accum = {"g_acc": spec.unflatten(torch.as_tensor(
                    saved_accum["g_acc"])),
                    "micro_n": saved_accum["micro_n"]}
        if set(slot_trees) != set(self.slots):
            raise ValueError(
                f"checkpoint slots {sorted(slot_trees)} do not match "
                f"{type(o.optim_method).__name__}'s {sorted(self.slots)}")
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), _matched(
                    "params", params, loaded["params"])):
                dst.copy_(src)
            for key, flat in self.slots.items():
                for dst, src in zip(flat, self._as_flat(
                        f"slot {key!r}", params, slot_trees[key])):
                    dst.copy_(src)
        self.mod_state = tree_map(lambda t: t.to(device),
                                  loaded.get("state", {}))
        if hasattr(self.step, "clear_micro"):
            self.step.clear_micro()
        if saved_accum is not None:
            n = int(saved_accum["micro_n"])
            if not hasattr(self.step, "restore_micro"):
                logger.warning(
                    "checkpoint holds a mid-cycle accumulator (%d "
                    "micro-batches) but this run has grad_accum=1; the "
                    "partial gradients are discarded", n)
            else:
                self.step.restore_micro(
                    [a.to(device) for a in self._as_flat(
                        "accumulator", params, saved_accum["g_acc"])], n)
        return saved

    def _save(self, train_state) -> str:
        """One checkpoint: the model, the slots as param-shaped trees,
        the train state and, mid-cycle, the partial accumulator."""
        params = self.params
        accum_state = None
        micro_state = getattr(self.step, "micro_state", None)
        if micro_state is not None:
            acc, n = micro_state()
            if n:
                accum_state = {"g_acc": self._as_tree(params, acc),
                               "micro_n": n}
        return self.o.checkpoint.save(
            train_state["neval"], {"params": params,
                                   "state": self.mod_state},
            {k: self._as_tree(params, v) for k, v in self.slots.items()},
            {k: train_state[k] for k in
             ("epoch", "neval", "nupdates", "records")},
            accum_state=accum_state)

    def _validate(self) -> Dict[str, ValidationResult]:
        """The validation methods over the validation set, the forward
        under torch.no_grad() in the compute dtype."""
        # imported here: the evaluator imports this module's batching
        from bigdl_tpu_torch.optim.evaluator import evaluate

        o = self.o
        return evaluate(o.model, o.validation_dataset, o.validation_methods,
                        o.validation_batch_size,
                        {"params": self.params, "state": self.mod_state},
                        o.precision)

    def _param_tree(self):
        """The current params as a tree (the histograms' source)."""
        return self.params

    def _flush(self, lr, stepno) -> None:
        """Apply a pending partial accumulator (grad_accum > 1)."""
        self.step.flush(lr, stepno)

    def _final_params(self):
        return tree_map(lambda t: t.detach(), self.params)

    def _close(self) -> None:
        """Release what `_setup` opened."""

    def _emit(self, pending) -> None:
        """Telemetry of an already-enqueued step through StepTelemetry
        (registry, events, TrainSummary sink, log line). `float(loss)`
        here is the host's wait for step N, taken after step N+1 is
        queued, and only on a step that logs or writes a summary:
        telemetry alone never reads the card, so on any other step the
        `train_step` event omits the loss."""
        state, loss, lr, throughput, real, hists, gnorm, ok = pending
        o = self.o
        fence = (o.train_summary is not None
                 or state["neval"] % o.log_every == 0)
        if not (fence or obs.enabled()):
            return
        if fence:
            with Timer(self.metrics, "fence_s"):
                loss = float(loss)
        else:
            loss = None
        self.telemetry.emit_step(
            epoch=state["epoch"], step=state["neval"], loss=loss,
            lr=lr, throughput=throughput, records=real,
            update_applied=ok, gnorm=gnorm, hists=hists,
            metrics_summary=self.metrics.summary())
