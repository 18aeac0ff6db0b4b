"""Helpers of the example tests (tests/test_torch_examples_*.py) that
import no JAX: a port example's `main` run on the CPU with its output
captured, optionally with the JAX example's initial weights carried in,
and the rank bodies that parallel/launch.spawn runs for the
rank-parallel examples. spawn re-imports this module in every rank.
"""

import contextlib
import importlib
import io
import tempfile
from unittest import mock

import torch

from bigdl_tpu_torch.models.convert import variables_from_jax
from bigdl_tpu_torch.optim.optimizer import Optimizer


def carried_optimizers(trees):
    """A patch under which the n-th Optimizer built takes the n-th of
    `trees` (the JAX package's `variables`, host arrays) as its model's
    variables, on the model's device."""
    pending = list(trees)
    init = Optimizer.__init__

    def patched(self, model, *args, **kwargs):
        init(self, model, *args, **kwargs)
        device = next(t for _, t in model.parameters()).device
        model.variables = variables_from_jax(pending.pop(0), device=device)

    return mock.patch.object(Optimizer, "__init__", patched)


def no_patch():
    return contextlib.nullcontext()


@contextlib.contextmanager
def scratch_tempdir():
    """Every temporary directory made inside goes under one that is
    removed on exit: the examples' own (checkpoints, summaries, shards,
    model files), which they leave behind for their users."""
    saved = tempfile.tempdir
    with tempfile.TemporaryDirectory(prefix="example_run_") as tmp:
        tempfile.tempdir = tmp
        try:
            yield tmp
        finally:
            tempfile.tempdir = saved


def run_example(name, patch):
    """`main(["--device", "cpu"])` of the port example `name` under
    `patch`, its temporary directories removed after it: (its return
    value, its standard output)."""
    mod = importlib.import_module(f"bigdl_tpu_torch.examples.{name}")
    out = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # beside other test workers' processes
    try:
        with patch, scratch_tempdir(), contextlib.redirect_stdout(out):
            result = mod.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return result, out.getvalue()


def flat_params(model):
    return torch.cat([t.detach().reshape(-1).float()
                      for _, t in model.parameters()]).numpy()


def rank_ddp(rank, world, trees):
    """The DDP example on this rank: (flat trained params, stdout)."""
    model, out = run_example("distributed_data_parallel",
                             carried_optimizers(trees))
    return flat_params(model), out


def rank_example(rank, world, name):
    """The example `name` on this rank: (its return value, stdout)."""
    return run_example(name, no_patch())
