"""Transfer learning through the estimator API (reference:
example/MLPipeline DLClassifier transfer-learning demo): take a
"pretrained" conv backbone, attach a fresh head, fit on a DataFrame.

Ports examples/transfer_learning.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.transfer_learning [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.ml import DLClassifier
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

H = W = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.RandomState(0)
    ys = rng.randint(0, 2, 256).astype(np.int32)
    xs = (rng.rand(256, H, W, 1) * 0.4 +
          ys[:, None, None, None] * 0.6).astype(np.float32)

    # "pretrained" backbone (weights would come from load_caffe/load_tf)
    backbone = nn.Sequential(
        nn.SpatialConvolution(1, 4, 3, 3), nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape([4 * 3 * 3]))
    head = nn.Sequential(nn.Linear(4 * 3 * 3, 2), nn.LogSoftMax())
    model = nn.Sequential(backbone, head).build(
        torch.Generator().manual_seed(0), device=device)

    df = {"features": list(xs.reshape(256, -1)), "label": list(ys)}
    clf = (DLClassifier(model, nn.ClassNLLCriterion(), [H, W, 1])
           .set_batch_size(64).set_max_epoch(12).set_learning_rate(0.3))
    fitted = clf.fit(df)
    out = fitted.transform(df)
    acc = np.mean(np.asarray(out["prediction"]) == ys)
    print("transfer-learning accuracy:", acc)
    return fitted


if __name__ == "__main__":
    main()
