"""LeNet-5 local training (reference: models/lenet/Train.scala).

Ports examples/lenet_local_train.py to bigdl_tpu_torch. Runs on MNIST
if `-f <folder>` points at the idx files, else on a synthetic stand-in.
Shows the full Optimizer surface: SGD+momentum, epoch triggers,
validation, checkpointing, TensorBoard summaries. Checkpoints go to
`--checkpoint` (default: a fresh temporary directory), the summaries
to a fresh temporary directory.

    python -m bigdl_tpu_torch.examples.lenet_local_train [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, mnist
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.visualization import TrainSummary

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def synthetic(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, n).astype(np.int32)
    xs = rng.rand(n, 28, 28, 1).astype(np.float32) * 0.1
    for i, y in enumerate(ys):  # class-dependent bright square
        r, c = divmod(int(y), 4)
        xs[i, 3 + 5 * r:8 + 5 * r, 3 + 5 * c:8 + 5 * c] += 0.8
    return [Sample(x, int(y)) for x, y in zip(xs, ys)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--dataFolder", default=None)
    ap.add_argument("-b", "--batchSize", type=int, default=128)
    ap.add_argument("--maxEpoch", type=int, default=3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    checkpoint = args.checkpoint or tempfile.mkdtemp(prefix="lenet_ckpt_")

    if args.dataFolder:
        train = DataSet.array(mnist.load_mnist(args.dataFolder, train=True))
        val = DataSet.array(mnist.load_mnist(args.dataFolder, train=False))
    else:
        samples = synthetic()
        train = DataSet.array(samples[:1792])
        val = DataSet.array(samples[1792:])

    model = lenet.build(10).build(torch.Generator().manual_seed(0),
                                  device=device)
    trained = (
        Optimizer(model, train, nn.ClassNLLCriterion(),
                  batch_size=args.batchSize)
        .set_optim_method(SGD(learningrate=0.05, momentum=0.9))
        .set_end_when(Trigger.max_epoch(args.maxEpoch))
        .set_validation(Trigger.every_epoch(), val, [Top1Accuracy()])
        .set_checkpoint(checkpoint, Trigger.every_epoch())
        .set_train_summary(TrainSummary(
            tempfile.mkdtemp(prefix="lenet_tb_"), "lenet"))
        .optimize()
    )
    print("done; checkpoints in", checkpoint)
    return trained


if __name__ == "__main__":
    main()
