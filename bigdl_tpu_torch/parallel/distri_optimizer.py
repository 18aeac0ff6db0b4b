"""Distributed (mesh) training loop.

Ports `DistriOptimizer` from bigdl_tpu/parallel/distri_optimizer.py
(reference: optim/DistriOptimizer.scala — per iteration a local
forward/backward, the AllReduceParameter reduce-scatter, a sharded
optimizer step and an all-gather, with driver-side triggers,
validation, checkpoints and failure recovery).

Every rank of the mesh is a process running LocalOptimizer's loop in
lockstep (parallel/data_parallel.py's eager step); this class supplies
its weights (the flat fp32 vector, or this rank's slice of it under
ZeRO-2), its step, its checkpoints and its validation. `batch_size` is
global and must divide by the data axis. Each rank feeds its own rows
of every global batch: of a stream that every rank reads alike (a
seeded DataSet), the rank's slice, so a run at world size n sees the
batches that the JAX package's n-device mesh sees; of a dataset with
`for_rank` (RecordFileDataSet, whose C++ plane orders batches by its
worker threads), its own partition at batch_size / n, as each process
of the JAX package's multi-process path iterates its own.

Kept from the JAX package: the batch-size divisibility errors; ZeRO-1
and ZeRO-2 (`zero=`); the bf16 or exact gradient wire (`grad_dtype`);
gradient accumulation with a sharded accumulator; clipping; the anomaly
guard (the health predicate is read from all-reduced values, so every
rank takes the same branch); the fault points; checkpoints in the JAX
package's format, the flat slots gathered to rank 0 and written with
`optim_meta` layout `zero1_flat`/`zero2_flat`, which
param_layout.adapt_flat_tree re-pads for another world size and
LocalOptimizer unflattens; recovery from the newest valid checkpoint
after a step exception (`max_retries`); and validation through
`make_dp_eval_step` with a row mask, a batch whose size does not divide
by the axis padded with copies of its last row (the JAX package's
`tile_first`, which keeps the Loss edge correction exact).

Sharded checkpoints (`set_checkpoint(sharded=True)`): each rank hands
`Checkpoint.save_sharded` its own slice of the flat slots — no slot
gather, no full optimizer state on any one rank — and rank 0 also the
gathered model and accumulator; every rank then drains its writer and
meets the others at a barrier, so none runs ahead of a checkpoint it
might recover from. A sharded checkpoint loads as the full flat
vectors, so a resume at another world size re-pads them
(param_layout.adapt_flat_tree) as it does the full format's.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.models.convert import tree_map
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             _batch_iterator, _to_device)
from bigdl_tpu_torch.optim.validation import ValidationResult
from bigdl_tpu_torch.parallel.data_parallel import (FlatParamSpec,
                                                    _all_gather,
                                                    make_dp_accum_steps,
                                                    make_dp_eval_step,
                                                    make_dp_train_step,
                                                    rank_generator)
from bigdl_tpu_torch.parallel.mesh import Mesh, host_to_global, place_global
from bigdl_tpu_torch.parallel.param_layout import (adapt_flat_tree,
                                                   repad_flat)
from bigdl_tpu_torch.serving.bucketing import pad_rows

logger = logging.getLogger("bigdl_tpu_torch.optim")


class DistriOptimizer(LocalOptimizer):
    """Mesh data-parallel optimizer (reference:
    optim/DistriOptimizer.scala): LocalOptimizer's loop over this
    class's weights, step, checkpoints and validation."""

    record_on_raise = True

    def __init__(self, opt: Optimizer, mesh: Mesh, axis: str = "data",
                 grad_dtype: Optional[str] = "bfloat16",
                 max_retries: int = 3, zero: int = 1):
        super().__init__(opt)
        if zero not in (1, 2):
            raise ValueError(f"zero must be 1 or 2, got {zero!r}")
        self.mesh = mesh
        self.axis = axis
        self.grad_dtype = grad_dtype
        self.max_retries = max_retries
        self.zero = zero
        self.writer = mesh.rank == 0
        self.rank_dataset = None

    # ------------------------------------------------------------- helpers
    def _place_w(self, params) -> torch.Tensor:
        flat = self.spec.flatten(params).to(self.mesh.device)
        return place_global(self.mesh, flat, self.axis) \
            if self.zero == 2 else flat

    def _full_w(self) -> torch.Tensor:
        if self.zero == 1:
            return self.flat_w
        return _all_gather(self.flat_w, self.n, self.mesh.group)

    def _fresh_acc(self) -> torch.Tensor:
        return torch.zeros(self.spec.shard_size, device=self.mesh.device)

    # ------------------------------------------------ this loop's pieces
    def _setup(self) -> None:
        o, mesh, axis = self.o, self.mesh, self.axis
        n = self.n = mesh.shape[axis]
        if o.batch_size is None or o.batch_size % n != 0:
            raise ValueError(
                f"global batch_size {o.batch_size} must be divisible by the "
                f"'{axis}' mesh axis size {n}")
        vbs = o.validation_batch_size or o.batch_size
        if o.validation_methods and vbs % n != 0:
            raise ValueError(
                f"validation batch_size {o.validation_batch_size} must be "
                f"divisible by the '{axis}' mesh axis size {n}")
        self.device = mesh.device
        variables = place_global(mesh, dict(o.model.variables))
        spec = self.spec = FlatParamSpec(variables["params"], n)
        logger.info("DistriOptimizer: %d ranks on axis %r (ZeRO-%d, %s), "
                    "%d params (padded %d, %d per shard)", n, axis,
                    self.zero, mesh.backend, spec.total, spec.padded,
                    spec.shard_size)
        kw = dict(axis=axis, grad_dtype=self.grad_dtype,
                  clip_const=o.grad_clip_const, clip_norm=o.grad_clip_norm,
                  precision=o.precision, health=o.anomaly_guard is not None,
                  zero=self.zero)
        if o.grad_accum == 1:
            self.step_fn = make_dp_train_step(o.model, o.criterion,
                                              o.optim_method, mesh, spec,
                                              **kw)
        else:
            self.micro_fn, self.apply_fn = make_dp_accum_steps(
                o.model, o.criterion, o.optim_method, mesh, spec, **kw)
        self.eval_fn = make_dp_eval_step(
            o.model, o.validation_methods, mesh,
            axis) if o.validation_methods else None
        self.flat_w = self._place_w(variables["params"])
        self.mod_state = variables["state"]
        # ZeRO-1: each rank holds only its slice's slots
        self.slots = o.optim_method.init_slots([self._fresh_acc()])
        self.g_acc = self._fresh_acc() if o.grad_accum > 1 else None
        self.micro_n = 0
        if n > 1 and hasattr(o.dataset, "for_rank"):
            # a stream whose order is its own (the C++ plane's threads):
            # each rank reads its own partition at batch_size / n
            self.rank_dataset = o.dataset.for_rank(mesh.rank, n)

    def _train_batches(self, skip: int):
        if self.rank_dataset is None:
            return super()._train_batches(skip)
        return _batch_iterator(self.rank_dataset, True,
                               self.o.batch_size // self.n, skip=skip)

    def _rows(self, mb) -> int:
        rows = super()._rows(mb)
        return rows * self.n if self.rank_dataset is not None else rows

    def _step_rng(self, neval: int) -> torch.Generator:
        return rank_generator(self.device, self.o.seed, neval,
                              self.mesh.rank)

    def _feed(self, x):
        """This rank's rows of a batch: its slice of a global batch, or
        the whole of a batch from its own partition."""
        if self.rank_dataset is not None:
            return _to_device(x, self.device)
        return host_to_global(self.mesh, x, self.axis)

    def _train_step(self, mb, lr, stepno, rng, max_gnorm):
        bx, by = self._feed(mb.input), self._feed(mb.target)
        ok, gnorm = True, None
        if self.o.grad_accum == 1:
            out = self.step_fn(self.flat_w, self.slots, self.mod_state, bx,
                               by, lr, stepno, rng, max_gnorm)
            self.flat_w, self.slots, self.mod_state, loss = out[:4]
            if len(out) > 4:
                ok, gnorm = out[4:]
            return loss, ok, gnorm, ok
        out = self.micro_fn(self.flat_w, self.g_acc, self.mod_state, bx, by,
                            rng, max_gnorm)
        self.g_acc, self.mod_state, loss = out[:3]
        if len(out) > 3:
            ok, gnorm = out[3:]
        # an anomalous micro-gradient was not added; it does not count
        # toward the cycle either
        self.micro_n += int(ok)
        if self.micro_n < self.o.grad_accum:
            return loss, ok, gnorm, False
        self._apply(lr, stepno, self.micro_n)
        return loss, ok, gnorm, True

    def _apply(self, lr, stepno, count) -> None:
        self.flat_w, self.slots, self.g_acc = self.apply_fn(
            self.flat_w, self.slots, self.g_acc, lr, stepno, float(count))
        self.micro_n = 0

    def _flush(self, lr, stepno) -> None:
        if self.micro_n:  # the mean over the micro-batches actually seen
            self._apply(lr, stepno, self.micro_n)

    def _param_tree(self):
        return self.spec.unflatten(self._full_w())

    def _final_params(self):
        return tree_map(lambda t: t.detach().clone(), self._param_tree())

    def _close(self) -> None:
        if self.rank_dataset is not None and hasattr(self.rank_dataset,
                                                     "close"):
            self.rank_dataset.close()

    # -------------------------------------------------------- checkpoints
    def _load_checkpoint(self) -> Dict[str, Any]:
        o, spec = self.o, self.spec
        saved_vars, saved_slots, saved_ts, om = o.checkpoint.load(
            with_optim_meta=True)
        self.flat_w = self._place_w(saved_vars["params"])
        self.mod_state = tree_map(lambda t: t.to(self.device),
                                  saved_vars.get("state", {}))
        # the same padding, another world size's, or a LocalOptimizer
        # checkpoint's param-shaped trees
        full = adapt_flat_tree(saved_slots, om, spec)
        if set(full) != set(self.slots):
            raise ValueError(
                f"checkpoint slots {sorted(full)} do not match "
                f"{type(o.optim_method).__name__}'s {sorted(self.slots)}")
        self.slots = {k: [place_global(self.mesh, torch.as_tensor(v),
                                       self.axis)]
                      for k, v in full.items()}
        self._restore_accum(om)
        return saved_ts

    def _restore_accum(self, optim_meta) -> None:
        """Reinstall a checkpointed mid-cycle accumulator (or reset): a
        LocalOptimizer checkpoint's param-shaped one is flattened,
        another world size's flat one re-padded."""
        o, spec, accum = self.o, self.spec, self.o.grad_accum
        saved = o.checkpoint.load_accum()
        if accum == 1:
            if saved is not None:
                logger.warning(
                    "checkpoint holds a mid-cycle accumulator (%d "
                    "micro-batches) but this run has grad_accum=1; the "
                    "partial gradients are discarded", int(saved["micro_n"]))
            return
        if saved is None or int(saved["micro_n"]) >= accum:
            if saved is not None:
                logger.warning(
                    "checkpointed accumulation cycle (%d micro-batches) "
                    "does not fit grad_accum=%d; restarting the cycle",
                    int(saved["micro_n"]), accum)
            self.g_acc, self.micro_n = self._fresh_acc(), 0
            return
        acc = saved["g_acc"]
        if isinstance(acc, dict):
            flat = spec.flatten(acc)
        else:
            flat = torch.as_tensor(acc)
            old_total = (optim_meta or {}).get("total")
            if flat.shape[0] != spec.padded:
                if old_total is None or old_total > spec.padded:
                    raise ValueError(
                        f"cannot adapt accumulator of length "
                        f"{flat.shape[0]} to padded {spec.padded}")
                flat = repad_flat(flat, old_total, spec.padded)
        self.g_acc = place_global(self.mesh, flat.to(self.device), self.axis)
        self.micro_n = int(saved["micro_n"])

    def _save(self, train_state) -> Optional[str]:
        """One checkpoint in the JAX package's format. Full format: the
        flat slots and accumulator gathered from every rank, written by
        rank 0. Sharded: each rank writes its own slot slice, rank 0
        the model, the accumulator and the manifest. Either way the
        ranks then wait at a barrier until the write is complete."""
        o, mesh, spec = self.o, self.mesh, self.spec
        ck = o.checkpoint
        flat_full = self._full_w()
        group = mesh.group
        accum_state = None
        if self.micro_n:  # mid-cycle: persist the partial accumulator
            accum_state = {"g_acc": _all_gather(self.g_acc, self.n, group),
                           "micro_n": self.micro_n}
        model = {"params": spec.unflatten(flat_full),
                 "state": self.mod_state}
        train_meta = {k: train_state[k] for k in
                      ("epoch", "neval", "nupdates", "records")}
        optim_meta = {"layout": f"zero{self.zero}_flat",
                      "num_shards": self.n, "total": spec.total,
                      "padded": spec.padded}
        if ck.sharded:
            if self.n > 1:
                # a torn save of this step (a writer that died) left its
                # staging dir behind: rank 0 removes it before any rank
                # writes, or rank 0 could publish it on the stale units'
                # manifests while another rank still rewrites its unit
                # there (the previous save is complete on every rank:
                # the barrier below)
                if mesh.rank == 0:
                    ck.discard_staging(train_state["neval"])
                dist.barrier(group=group)
            path = ck.save_sharded(
                train_state["neval"], model if mesh.rank == 0 else None,
                {mesh.rank: {k: v[0] for k, v in self.slots.items()}},
                nshards=self.n, train_state=train_meta,
                optim_meta=optim_meta, accum_state=accum_state)
        else:
            full_slots = {k: _all_gather(v[0], self.n, group)
                          for k, v in self.slots.items()}
            path = None
            if mesh.rank == 0:
                path = ck.save(train_state["neval"], model, full_slots,
                               train_meta, optim_meta=optim_meta,
                               accum_state=accum_state)
        if self.n > 1:
            # no rank may run ahead (and recover from this checkpoint)
            # before the write is complete everywhere
            if mesh.rank == 0 or ck.sharded:
                ck.wait()
            dist.barrier(group=mesh.group)
        return path

    # ------------------------------------------------------------ validate
    def _validate(self):
        o, mesh, n = self.o, self.mesh, self.n
        params = self._param_tree()
        results = [ValidationResult(0.0, 0.0, m.name)
                   for m in o.validation_methods]
        vbs = o.validation_batch_size or o.batch_size
        for mb in _batch_iterator(o.validation_dataset, False, vbs):
            real = getattr(mb, "real_size", mb.size)
            rows = -(-mb.size // n) * n
            if rows != mb.size:
                # every filler row repeats the batch's last row, so the
                # Loss edge correction cancels it exactly
                mb = MiniBatch(pad_rows(mb.input, rows),
                               pad_rows(mb.target, rows))
            mask = (np.arange(rows) < real).astype(np.float32)
            stats = self.eval_fn(
                params, self.mod_state,
                host_to_global(mesh, mb.input, self.axis),
                host_to_global(mesh, mb.target, self.axis),
                host_to_global(mesh, mask, self.axis))
            for i, (s, c) in enumerate(stats):
                results[i] = results[i] + ValidationResult(float(s), float(c))
        return {m.name: r for m, r in zip(o.validation_methods, results)}
