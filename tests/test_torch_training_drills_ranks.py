"""The port side of scripts/fault_drill.py's training legs, for
tests/test_torch_training_drills.py: `port_train` stands in for the
drill module's `_train` (the same MLP, data, optimizer, checkpoint and
fault-plan calls, made through bigdl_tpu_torch, with the JAX model's
initial weights handed in), and `run_leg` runs a leg from a copy of the
drill module whose JAX-package names resolve to the port's. `rank_legs`
is the body of one rank of a gloo group (parallel/launch.spawn) for the
legs whose shard count is the world size. This module imports neither
JAX nor the JAX package: spawn re-imports it in every rank.
"""

import importlib.util
import os
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np

from bigdl_tpu_torch import nn, obs
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models.convert import params_from_jax
from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
from bigdl_tpu_torch.parallel import make_mesh
from bigdl_tpu_torch.utils import faults

DRILL = Path(__file__).resolve().parent.parent / "scripts" / "fault_drill.py"


def make_port_train(weights):
    """The drill's `_train` on the port: one training run under a fault
    plan, returning (flat params, the Optimizer, the consumed plan). A
    mesh run builds the data axis over the whole process group (one
    rank in a lone process)."""

    def port_train(workdir, end_iter, *, faults="", guard=None,
                   mesh=False, ckpt_iter=None, resume=False, tag="run",
                   zero=1, sharded=False, async_save=False,
                   mesh_devices=None):
        import torch.distributed as dist

        rng = np.random.RandomState(11)
        samples = [Sample(rng.rand(6).astype(np.float32),
                          int(rng.randint(0, 4))) for _ in range(64)]
        model = nn.Sequential(nn.Linear(6, 16), nn.ReLU(),
                              nn.Linear(16, 4), nn.LogSoftMax())
        model.variables = {"params": params_from_jax(weights,
                                                     device="cpu"),
                           "state": model.init_state()}
        opt = (Optimizer(model, DataSet.array(samples),
                         nn.ClassNLLCriterion(), batch_size=8)
               .set_optim_method(Adam(learningrate=1e-2))
               .set_end_when(Trigger.max_iteration(end_iter)))
        if guard is not None:
            opt.set_anomaly_guard(guard)
        if ckpt_iter is not None:
            opt.set_checkpoint(os.path.join(workdir, tag),
                               Trigger.several_iteration(ckpt_iter),
                               sharded=sharded, async_save=async_save)
        if resume:
            opt.resume_from_checkpoint()
        m = None
        if mesh or mesh_devices:
            world = dist.get_world_size() if dist.is_initialized() else 1
            m = make_mesh({"data": world}, device="cpu")
            opt.set_mesh(m, zero=zero)
        faults_mod = sys.modules["bigdl_tpu.utils.faults"]
        faults_mod.set_plan(faults_mod.FaultPlan(faults))
        try:
            trained = opt.optimize()
        finally:
            plan = faults_mod.get_plan()
            faults_mod.set_plan(None)
            if m is not None:
                m.close()               # a group it opened, not a launcher's
        flat = np.concatenate([
            np.ravel(np.asarray(a.detach(), np.float32))
            for _, a in trained.parameters()])
        return flat, opt, plan

    return port_train


def port_modules():
    """sys.modules entries that resolve the names a training leg
    imports from the JAX package to the port's."""
    root = types.ModuleType("bigdl_tpu")
    utils = types.ModuleType("bigdl_tpu.utils")
    root.obs, root.utils, utils.faults = obs, utils, faults
    return {"bigdl_tpu": root, "bigdl_tpu.utils": utils,
            "bigdl_tpu.utils.faults": faults, "bigdl_tpu.obs": obs}


def load_drill(name):
    """A fresh copy of scripts/fault_drill.py (its import-time platform
    set-up skipped: the port side never touches JAX)."""
    env = os.environ.pop("JAX_PLATFORMS", None)
    try:
        spec = importlib.util.spec_from_file_location(name, DRILL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if env is not None:
            os.environ["JAX_PLATFORMS"] = env
    return mod


def run_leg(leg, workdir, weights, drill=None):
    """One training leg on the port; its digest."""
    drill = drill or load_drill("fault_drill_port_training")
    drill._train = make_port_train(weights)
    with mock.patch.dict(sys.modules, port_modules()):
        try:
            return drill.TRAINING_LEGS[leg](str(workdir))
        finally:
            faults.set_plan(None)
            obs.reset_all()


def rank_legs(rank, world, legs, workdir, weights):
    """Every leg of `legs` on this rank of a gloo group, in order, each
    under workdir/<leg> (shared by the ranks, as a cluster's checkpoint
    directory is); the digests."""
    import torch

    torch.set_num_threads(1)
    drill = load_drill("fault_drill_port_rank")
    return {leg: run_leg(leg, os.path.join(workdir, leg), weights, drill)
            for leg in legs}
