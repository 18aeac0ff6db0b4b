"""Caffe model import (reference: example/loadmodel): build a caffemodel
programmatically (stand-in for a downloaded one), import it, run it.

Ports examples/load_caffe_model.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.load_caffe_model [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.caffe import loader as caffe
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def build_model():
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1).set_name("conv1"),
        nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        # caffe's implicit flatten orders features (C,H,W) — use the
        # NHWC→NCHW + reshape idiom so the export is wire-faithful
        nn.Transpose(((2, 4), (3, 4))),
        nn.Reshape((-1,)),
        nn.Linear(8 * 4 * 4, 5).set_name("fc"),
        nn.SoftMax())


def round_trip(m, variables, device):
    """Export (m, variables) as a caffemodel, re-import it and run it on
    the example's input: (imported model, its variables, output)."""
    d = tempfile.mkdtemp(prefix="caffe_example_")
    proto, weights = f"{d}/net.prototxt", f"{d}/net.caffemodel"
    caffe.persist(proto, weights, m, variables, input_shape=(1, 8, 8, 3))
    model, params = caffe.load(proto, weights, device=device)
    x = torch.as_tensor(np.random.RandomState(0).rand(2, 8, 8, 3)
                        .astype(np.float32), device=device)
    out, _ = model.apply(params, x, training=False)
    return model, params, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    # export a native model as a caffemodel, then re-import it —
    # the same code path a real downloaded caffemodel takes
    m = build_model()
    variables = m.init(torch.Generator().manual_seed(0), device=device)
    model, _, out = round_trip(m, variables, device)
    print("imported caffe model output:", tuple(out.shape))
    return model


if __name__ == "__main__":
    main()
