"""Synthetic-data throughput harness.

Ports bigdl_tpu/models/perf.py (reference: models/utils/
LocalOptimizerPerf.scala — per-model synthetic training benchmarks).
Runs on the card by default:

    python -m bigdl_tpu_torch.models.perf --model resnet50 -b 256 -i 10 \\
        --precision bf16

The models are the JAX package's table: lenet, resnet50, resnet18,
resnet20-cifar, inception-v1, inception-v2, vgg16 and alexnet.
`--mesh data=N` times the data-parallel step of
parallel/data_parallel.py (ZeRO-1, the bf16 gradient wire) on this
rank's rows of the batch; N > 1 runs under `torchrun --nproc_per_node
N`. Other mesh axes build as parallel/mesh.py allows, but the harness
times the data axis only, and a mesh without one is refused, as the
JAX harness refuses it.
The result is logged as one JSON line through the
`bigdl_tpu_torch.models` logger, on stdout.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike


def _build_model(name: str, class_num: int):
    from bigdl_tpu_torch.models import alexnet, inception, lenet, resnet, vgg

    name = name.lower()
    table = {
        "lenet": (lambda: lenet.build(10), (28, 28, 1), 10),
        "resnet50": (lambda: resnet.build_imagenet(50, class_num),
                     (224, 224, 3), class_num),
        "resnet18": (lambda: resnet.build_imagenet(18, class_num),
                     (224, 224, 3), class_num),
        "resnet20-cifar": (lambda: resnet.build_cifar(20, 10),
                           (32, 32, 3), 10),
        "inception-v1": (lambda: inception.build(class_num),
                         (224, 224, 3), class_num),
        "inception-v2": (lambda: inception.build_v2(class_num),
                         (224, 224, 3), class_num),
        "vgg16": (lambda: vgg.build(16, class_num), (224, 224, 3),
                  class_num),
        "alexnet": (lambda: alexnet.build(class_num), (224, 224, 3),
                    class_num),
    }
    if name not in table:
        raise SystemExit(f"unknown model {name!r}; choices: {sorted(table)}")
    build, shape, classes = table[name]
    return build(), shape, classes


def train_step(model_name: str = "resnet50", batch_size: int = 32,
               optimizer: str = "sgd", class_num: int = 1000,
               precision: Optional[str] = None,
               device: DeviceLike = None) -> Callable[[int], torch.Tensor]:
    """`step(i)`: one eager train step of `model_name` on one synthetic
    batch (seeded), returning its loss on the device. A step is the loss
    (ops/losses.build_train_loss), autograd's gradients with respect to
    the fp32 master weights and the optim method's in-place update:
    SGD(0.01, momentum 0.9, dampening 0) or Adam(1e-3).
    `precision="bf16"` (or "mixed") computes in bf16 over fp32 master
    weights. Builds on `device` (None: the card). The step keeps its
    model as `step.model` and returns the trained variables from
    `step.variables()`."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.nn.module import _fold_rng
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.optim import SGD, Adam
    from bigdl_tpu_torch.utils.device import resolve_device
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    dev = resolve_device(device)
    policy = DEFAULT_MIXED if precision in ("bf16", "mixed") else None
    model, shape, classes = _build_model(model_name, class_num)
    variables = model.init(torch.Generator().manual_seed(0), dev)
    method = (SGD(learningrate=0.01, momentum=0.9, dampening=0.0)
              if optimizer == "sgd" else Adam(1e-3))
    rng = np.random.RandomState(0)
    bx = torch.from_numpy(
        rng.rand(batch_size, *shape).astype(np.float32)).to(dev)
    by = torch.from_numpy(
        rng.randint(0, classes, batch_size).astype(np.int32)).to(dev)

    leaves = [t.requires_grad_() for t in tree_leaves(variables["params"])]
    slots = method.init_slots(leaves)
    loss_call = build_train_loss(model, nn.ClassNLLCriterion(), policy)
    params, state = variables["params"], variables["state"]
    base = torch.Generator(device=dev).manual_seed(7)

    def step(i: int) -> torch.Tensor:
        nonlocal state
        loss, state = loss_call(params, state, bx, by, _fold_rng(base, i))
        grads = torch.autograd.grad(loss, leaves)
        method.update(grads, leaves, slots, 0.01, i)
        return loss.detach()

    step.model = model
    step.variables = lambda: {"params": params, "state": state}
    return step


def dp_train_step(model_name: str, batch_size: int, mesh_axes: str,
                  optimizer: str = "sgd", class_num: int = 1000,
                  precision: Optional[str] = None,
                  device: DeviceLike = None
                  ) -> Callable[[int], torch.Tensor]:
    """`step(i)`: one data-parallel train step (make_dp_train_step over
    `make_mesh(parse_axes(mesh_axes))`) on this rank's rows of the same
    seeded batch as `train_step`, returning the mean loss over the
    mesh."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Adam
    from bigdl_tpu_torch.parallel import (FlatParamSpec, host_to_global,
                                          make_dp_train_step, make_mesh,
                                          parse_axes)
    from bigdl_tpu_torch.parallel.mesh import place_global
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    axes = parse_axes(mesh_axes)
    if "data" not in axes:
        raise SystemExit(
            f"--mesh {mesh_axes!r} has no 'data' axis; the perf harness "
            "benchmarks data-parallel training (e.g. --mesh data=8)")
    mesh = make_mesh(axes, device)
    policy = DEFAULT_MIXED if precision in ("bf16", "mixed") else None
    model, shape, classes = _build_model(model_name, class_num)
    variables = place_global(mesh, model.init(
        torch.Generator().manual_seed(0), mesh.device))
    method = (SGD(learningrate=0.01, momentum=0.9, dampening=0.0)
              if optimizer == "sgd" else Adam(1e-3))
    spec = FlatParamSpec(variables["params"], mesh.shape["data"])
    dp_step = make_dp_train_step(model, nn.ClassNLLCriterion(), method,
                                 mesh, spec, precision=policy)
    rng = np.random.RandomState(0)
    bx = host_to_global(mesh, rng.rand(batch_size, *shape)
                        .astype(np.float32))
    by = host_to_global(mesh, rng.randint(0, classes, batch_size)
                        .astype(np.int32))
    w = spec.flatten(variables["params"])
    slots = method.init_slots([torch.zeros(spec.shard_size,
                                           device=mesh.device)])
    state = variables["state"]
    base = torch.Generator(device=mesh.device).manual_seed(7)

    def step(i: int) -> torch.Tensor:
        nonlocal w, slots, state
        w, slots, state, loss = dp_step(w, slots, state, bx, by, 0.01, i,
                                        base)
        return loss

    step.model = model
    step.mesh = mesh  # run_perf closes a group the mesh opened
    step.variables = lambda: {"params": spec.unflatten(w), "state": state}
    return step


def run_perf(model_name: str = "resnet50", batch_size: int = 32,
             iterations: int = 10, mesh_axes: Optional[str] = None,
             optimizer: str = "sgd", class_num: int = 1000,
             precision: Optional[str] = None,
             device: DeviceLike = None,
             step: Optional[Callable[[int], torch.Tensor]] = None
             ) -> dict:
    """Steady-state throughput of `train_step`: one untimed warm-up
    step, then `iterations` timed steps. The timing is fenced by a host
    read of the last loss, which depends on every earlier step's
    weights. `compile_s` is the warm-up step's wall time (the JAX
    package's compile; here the first step's allocations and cuDNN's
    first calls); the rates are not rounded. Runs on `device` (None:
    the card). `step`, a `train_step` of the same arguments, is timed
    in place of a new one, so its caller keeps the trained weights
    (`step.variables()`)."""
    own_mesh = None
    if step is None and mesh_axes:
        step = dp_train_step(model_name, batch_size, mesh_axes, optimizer,
                             class_num, precision, device)
        own_mesh = step.mesh
    run_one = step or train_step(model_name, batch_size, optimizer,
                                 class_num, precision, device)
    try:
        return _timed(run_one, model_name, batch_size, iterations)
    finally:
        if own_mesh is not None:
            own_mesh.close()


def _timed(run_one, model_name, batch_size, iterations) -> dict:
    t0 = time.perf_counter()
    float(run_one(0))  # warm-up; the host read is the fence
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    loss = None
    for i in range(1, iterations + 1):
        loss = run_one(i)
    float(loss)  # the last loss depends on every step: fences the chain
    steady = time.perf_counter() - t0

    return {
        "model": model_name,
        "batch_size": batch_size,
        "iterations": iterations,
        "compile_s": compile_s,
        "steady_wall_s": steady,
        "images_per_sec": iterations * batch_size / steady,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("-b", "--batch-size", type=int, default=32)
    ap.add_argument("-i", "--iterations", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="data-parallel axes, e.g. data=1 (data=N>1 under "
                         "torchrun --nproc_per_node N)")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--class-num", type=int, default=1000)
    ap.add_argument("--precision", default=None,
                    choices=[None, "bf16", "mixed", "fp32"],
                    help="bf16 → mixed precision (fp32 master weights)")
    args = ap.parse_args(argv)
    result = run_perf(args.model, args.batch_size, args.iterations,
                      args.mesh, args.optimizer, args.class_num,
                      args.precision)
    result["device"] = torch.cuda.get_device_name(0)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    logging.getLogger("bigdl_tpu_torch.models").info(json.dumps(result))


if __name__ == "__main__":
    main()
