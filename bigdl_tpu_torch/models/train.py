"""Unified training CLI for the model zoo.

Ports bigdl_tpu/models/train.py (reference: the per-model
`Train.scala` scopt CLIs, models/lenet/Train.scala,
models/resnet/Train.scala, ...). Every flag and model of the JAX CLI is
kept (-f dataFolder, -b batchSize, --learningRate, --maxEpoch,
--checkpoint, --resume, --summary, --records, --tfrecords, --mesh,
--precision, ...). It trains on the card unless the caller of `main`
passes `device="cpu"`:

    python -m bigdl_tpu_torch.models.train --model resnet50 \\
        --records /data/shards --recordsAug hflip --mesh data=1 \\
        --precision bf16 -b 128 --maxEpoch 1 --checkpoint /tmp/ck
    python -m bigdl_tpu_torch.models.train --model lenet --synthetic

`--records` streams BDLS shards through dataset/native.py (its C++
plane when g++ builds it), `--tfrecords` TFRecord shards through
dataset/tfrecord.py. `--mesh data=N` trains through
`Optimizer.set_mesh` (parallel/distri_optimizer.DistriOptimizer): N = 1
opens its own one-rank group (NCCL on the card, gloo on the CPU); N > 1
runs under `torchrun --nproc_per_node N`. `--moeExperts E` (with
`--moeTopK`, `--moeRouting`) gives the transformer a mixture-of-experts
FFN of E experts (parallel/moe.py).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="lenet",
                    help="lenet | resnet20-cifar | resnet50 | resnet18 | "
                         "inception-v1 | vgg16 | alexnet | "
                         "textclassifier | ncf | bilstm | transformer")
    ap.add_argument("-f", "--dataFolder", default=None)
    ap.add_argument("-b", "--batchSize", type=int, default=128)
    ap.add_argument("--learningRate", type=float, default=0.01)
    ap.add_argument("--maxEpoch", type=int, default=5)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weightDecay", type=float, default=0.0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--summary", default=None, help="TensorBoard log dir")
    ap.add_argument("--mesh", default=None, help="e.g. data=1")
    ap.add_argument("--synthetic", action="store_true",
                    help="use synthetic data (no dataset folder needed)")
    ap.add_argument("--records", default=None, metavar="DIR|GLOB",
                    help="train from disk-resident BDLS record shards "
                         "through the data plane (any vision model; see "
                         "bigdl_tpu_torch.dataset.records)")
    ap.add_argument("--recordsMean", default="127.5",
                    help="comma per-channel mean for --records")
    ap.add_argument("--recordsStd", default="127.5",
                    help="comma per-channel std for --records")
    ap.add_argument("--recordsAug", default="",
                    help="comma subset of: hflip,pad<N> (e.g. hflip,pad4)")
    ap.add_argument("--moeExperts", type=int, default=0,
                    help="transformer only: Switch/GShard-MoE FFN with "
                         "this many experts (0 = dense)")
    ap.add_argument("--moeTopK", type=int, default=1, choices=[1, 2])
    ap.add_argument("--moeRouting", default="top_k",
                    choices=["top_k", "expert_choice"])
    ap.add_argument("--tfrecords", default=None, metavar="DIR|GLOB",
                    help="train a vision model from TFRecord shards of "
                         "tf.train.Examples (image/shape/label layout; "
                         "see bigdl_tpu_torch.dataset.tfrecord)")
    ap.add_argument("--precision", default=None,
                    choices=["bf16", "mixed", "fp32"],
                    help="bf16 → mixed-precision training")
    return ap


def _data_and_model(args, dev):
    """(model, train samples, validation samples) of the JAX CLI."""
    from bigdl_tpu_torch.dataset import Sample

    if args.model == "lenet":
        from bigdl_tpu_torch.dataset.mnist import load_mnist, synthetic_mnist
        from bigdl_tpu_torch.models import lenet

        model = lenet.build(10)
        if args.synthetic or not args.dataFolder:
            return model, synthetic_mnist(4096), synthetic_mnist(512, seed=9)
        return (model, load_mnist(args.dataFolder, train=True),
                load_mnist(args.dataFolder, train=False))
    if args.model == "resnet20-cifar":
        from bigdl_tpu_torch.dataset.cifar import (load_cifar10,
                                                   synthetic_cifar10)
        from bigdl_tpu_torch.models import resnet

        model = resnet.build_cifar(20, 10)
        if args.synthetic or not args.dataFolder:
            return (model, synthetic_cifar10(2048),
                    synthetic_cifar10(256, seed=9))
        return (model, load_cifar10(args.dataFolder, train=True),
                load_cifar10(args.dataFolder, train=False))
    if args.model in ("textclassifier", "ncf", "bilstm"):
        rng = np.random.RandomState(0)
        n = args.batchSize * 4
        if args.model == "textclassifier":
            from bigdl_tpu_torch.models import textclassifier

            model = textclassifier.build(class_num=4, vocab_size=200,
                                         sequence_len=200)
            ys = rng.randint(0, 4, n)
            train = [Sample(rng.randint(y * 50, y * 50 + 50,
                                        200).astype(np.int32), int(y))
                     for y in ys]
        elif args.model == "ncf":
            from bigdl_tpu_torch.models import ncf

            model = ncf.build(64, 128, class_num=5)
            train = [Sample(np.asarray(
                [rng.randint(64), rng.randint(128)], np.int32),
                np.int32(rng.randint(5))) for _ in range(n)]
        else:  # bilstm sentiment
            from bigdl_tpu_torch.models import rnn

            model = rnn.bilstm_sentiment(100, embed_dim=32, hidden_size=32)
            ys = rng.randint(0, 2, n)
            train = [Sample(rng.randint(y * 40, y * 40 + 40,
                                        24).astype(np.int32), int(y))
                     for y in ys]
        return model, train, train[:args.batchSize]
    if args.model == "transformer":
        from bigdl_tpu_torch.dataset.text import synthetic_next_token
        from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM)

        seq = 32
        model = TransformerLM(TransformerConfig(
            vocab_size=64, dim=128, num_heads=4, num_layers=2, max_len=seq,
            moe_experts=args.moeExperts, moe_top_k=args.moeTopK,
            moe_routing=args.moeRouting), device=dev)
        train = synthetic_next_token(args.batchSize * 4, 64, seq)
        return model, train, train[:args.batchSize]
    from bigdl_tpu_torch.models.perf import _build_model

    if args.dataFolder:
        raise SystemExit(
            f"--dataFolder is not supported for model {args.model!r} "
            "(only lenet / resnet20-cifar have dataset loaders); drop "
            "-f to train on synthetic data")
    model, shape, classes = _build_model(args.model, 1000)
    if args.records or args.tfrecords:
        return model, [], []  # disk shards replace the synthetic pool
    rng = np.random.RandomState(0)
    train = [Sample(rng.rand(*shape).astype(np.float32),
                    np.int32(rng.randint(classes)))
             for _ in range(args.batchSize * 4)]
    return model, train, train[:args.batchSize]


def _disk_datasets(args):
    """(train, validation) datasets of --tfrecords or --records."""
    log = logging.getLogger("bigdl_tpu_torch")
    if args.tfrecords:
        from bigdl_tpu_torch.dataset import Sample, TFRecordDataSet
        from bigdl_tpu_torch.dataset.tfrecord import default_image_parser

        if args.recordsAug:
            raise SystemExit(
                "--recordsAug applies to --records (native-plane "
                "augmentation); TFRecord training is unaugmented")
        mean = np.asarray([float(v) for v in args.recordsMean.split(",")],
                          np.float32)
        std = np.asarray([float(v) for v in args.recordsStd.split(",")],
                         np.float32)

        def parser(example):
            s = default_image_parser(example)
            return Sample((s.feature - mean) / std, s.label)

        ds = TFRecordDataSet(args.tfrecords, parser=parser)
        log.info("tfrecords: %d samples from %d shards (mean=%s std=%s)",
                 ds.size(), len(ds.paths), mean, std)
        return ds, ds
    from bigdl_tpu_torch.dataset import RecordFileDataSet, resolve_shards
    from bigdl_tpu_torch.dataset.records import read_header

    _, _, _, chans = read_header(resolve_shards(args.records)[0])

    def per_channel(spec):
        vals = [float(v) for v in spec.split(",")]
        return vals * chans if len(vals) == 1 else vals

    pad, hflip = 0, False
    for tok in filter(None, args.recordsAug.split(",")):
        if tok == "hflip":
            hflip = True
        elif tok.startswith("pad"):
            pad = int(tok[3:])
        else:
            raise SystemExit(f"unknown --recordsAug token {tok!r}")
    ds = RecordFileDataSet(args.records, args.batchSize,
                           mean=per_channel(args.recordsMean),
                           std=per_channel(args.recordsStd), pad=pad,
                           hflip=hflip)
    log.info("records: %d samples %s from %d shards (native=%s)",
             ds.size(), ds.shape, len(ds.paths), ds.native)
    return ds, ds  # eval iterates the shards once, unaugmented


def main(argv=None, device=None):
    """Parse `argv` (None: sys.argv) and train. `device`: None → the
    card (raises without CUDA); "cpu" runs the plain path. Returns the
    Optimizer: its `model` holds the trained variables, `dataset` the
    training set it read and `train_state` the run's final state."""
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import (SGD, Adam, Loss, Optimizer,
                                       Top1Accuracy, Trigger)
    from bigdl_tpu_torch.utils.device import resolve_device
    from bigdl_tpu_torch.visualization import (TrainSummary,
                                               ValidationSummary)

    if args.records and args.tfrecords:
        raise SystemExit("--records and --tfrecords are exclusive")
    if (args.records or args.tfrecords) and args.model in (
            "transformer", "textclassifier", "ncf", "bilstm"):
        raise SystemExit(
            f"record shards hold images; model {args.model!r} takes "
            "token inputs (use a vision model)")
    dev = resolve_device(device)
    model, train, val = _data_and_model(args, dev)
    model.build(torch.Generator().manual_seed(42), dev)

    method = (SGD(learningrate=args.learningRate, momentum=args.momentum,
                  dampening=0.0, weightdecay=args.weightDecay)
              if args.optimizer == "sgd" else Adam(args.learningRate))
    if args.model == "transformer":
        # the fused chunked criterion: no (B, S, V) log-prob tensor
        criterion = nn.ChunkedSoftmaxCE()
        val_methods = [Loss(criterion)]
    else:
        criterion = nn.ClassNLLCriterion()
        val_methods = [Top1Accuracy()]

    if args.records or args.tfrecords:
        train_ds, val_ds = _disk_datasets(args)
    else:
        train_ds, val_ds = DataSet.array(train), DataSet.array(val)

    opt = (Optimizer(model, train_ds, criterion, batch_size=args.batchSize)
           .set_optim_method(method)
           .set_end_when(Trigger.max_epoch(args.maxEpoch))
           .set_validation(Trigger.every_epoch(), val_ds, val_methods,
                           args.batchSize))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        if args.resume:
            opt.resume_from_checkpoint()
    if args.summary:
        opt.set_train_summary(TrainSummary(args.summary, args.model))
        opt.set_validation_summary(ValidationSummary(args.summary,
                                                     args.model))
    if args.precision and args.precision != "fp32":
        opt.set_precision("bf16")
    mesh = None
    if args.mesh:
        from bigdl_tpu_torch.parallel import make_mesh, parse_axes

        mesh = make_mesh(parse_axes(args.mesh), dev)
        opt.set_mesh(mesh)
    try:
        opt.optimize()
    finally:
        if mesh is not None:
            mesh.close()
        if hasattr(train_ds, "close"):
            train_ds.close()
    return opt


if __name__ == "__main__":
    main()
