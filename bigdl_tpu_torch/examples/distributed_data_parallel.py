"""ZeRO-1 data-parallel training over a mesh of ranks (reference:
optim/DistriOptimizer + parameters/AllReduceParameter → reduce-scatter /
sharded update / all-gather).

Ports examples/distributed_data_parallel.py to bigdl_tpu_torch: one
process a rank, each on its own card (or a gloo rank on the CPU). Run
under torchrun at any world size, or alone at world size 1:

    torchrun --nproc_per_node 4 \\
        -m bigdl_tpu_torch.examples.distributed_data_parallel
    python -m bigdl_tpu_torch.examples.distributed_data_parallel [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.examples._ranks import join
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.parallel import make_mesh

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device, n_dev = join(ap.parse_args(argv).device)
    mesh = make_mesh({"data": n_dev}, device=device)
    rng = np.random.RandomState(0)
    ys = rng.randint(0, 10, 1024).astype(np.int32)
    xs = rng.rand(1024, 28, 28, 1).astype(np.float32)
    samples = [Sample(x, int(y)) for x, y in zip(xs, ys)]

    model = lenet.build(10).build(torch.Generator().manual_seed(0),
                                  device=device)
    try:
        trained = (
            Optimizer(model, DataSet.array(samples),
                      nn.ClassNLLCriterion(), batch_size=16 * n_dev)
            .set_optim_method(SGD(learningrate=0.05, momentum=0.9))
            .set_end_when(Trigger.max_epoch(1))
            .set_mesh(mesh)
            .optimize()
        )
    finally:
        mesh.close()
    print(f"trained with ZeRO-1 DP over {n_dev} devices")
    return trained


if __name__ == "__main__":
    main()
