"""Disk-resident training through the native dataplane.

Ports examples/imagenet_records_pipeline.py to bigdl_tpu_torch.
Reference counterpart: the reference feeds ImageNet from Hadoop
sequence files partitioned across Spark executors (`dataset/image/`
tooling, SURVEY.md §2.4). Here the dataset lives in BDLS sharded
record files on disk, mmap()ed and streamed by C++ worker threads
(dataset/csrc) into the training loop — datasets larger than RAM ride
the OS page cache. Under a process group each rank reads its own
partition (`RecordFileDataSet.for_rank`, through DistriOptimizer).

This example writes a small synthetic dataset to shards in a fresh
temporary directory, then trains a small CIFAR-style ResNet from disk
exactly as `models/train.py --records` would:

    python -m bigdl_tpu_torch.examples.imagenet_records_pipeline [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import RecordFileDataSet, write_shards
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.optim import (SGD, Evaluator, Optimizer, Top1Accuracy,
                                   Trigger)
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- 1. write the dataset as BDLS shards (once, offline) --------
    rng = np.random.RandomState(0)
    n = 512
    images = np.zeros((n, 32, 32, 3), np.uint8)
    labels = (np.arange(n) % 4).astype(np.int32)
    bands = {0: (0, 8), 1: (24, 32), 2: (0, 32), 3: None}
    for i in range(n):  # separable AND augmentation-invariant classes:
        c = labels[i]   # top stripe / bottom stripe / all bright / dark
        if bands[c] is not None:
            lo, hi = bands[c]
            images[i, lo:hi, :, :] = 220
        images[i] += rng.randint(0, 25, (32, 32, 3)).astype(np.uint8)
    shard_dir = tempfile.mkdtemp(prefix="bdls_example_")
    paths = write_shards(images, labels, shard_dir, num_shards=4)
    print(f"wrote {len(paths)} shards under {shard_dir}")

    # ---- 2. train FROM DISK through the native prefetcher -----------
    ds = RecordFileDataSet(shard_dir, batch_size=64,
                           mean=[127.5] * 3, std=[127.5] * 3,
                           pad=1, hflip=True, n_threads=2)
    print(f"native plane: {ds.native}; {ds.size()} samples {ds.shape}")

    model = resnet.build_cifar(8, 4).build(torch.Generator().manual_seed(0),
                                           device=device)
    try:
        trained = (Optimizer(model, ds, nn.ClassNLLCriterion(),
                             batch_size=64)
                   .set_optim_method(SGD(learningrate=0.02, momentum=0.9,
                                         dampening=0.0))
                   .set_end_when(Trigger.max_epoch(6))
                   .optimize())

        # ---- 3. evaluate — eval iterates the shards once, unaugmented
        res = Evaluator(trained).test(ds, [Top1Accuracy()], batch_size=64)
    finally:
        ds.close()
    acc = res["Top1Accuracy"].result()[0]
    print(f"accuracy from disk-fed training: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
