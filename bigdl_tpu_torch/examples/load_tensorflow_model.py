"""TensorFlow frozen-graph import (reference: example/loadmodel TF path).
Writes a GraphDef with our saver (stand-in for a downloaded frozen .pb),
imports it, and computes gradients into the imported weights.

Ports examples/load_tensorflow_model.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.load_tensorflow_model [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
from bigdl_tpu_torch.utils import tf as tf_interop
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def build_model():
    return nn.Sequential(
        nn.SpatialConvolution(1, 4, 5, 5).set_name("c1"), nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape([4 * 12 * 12]),
        nn.Linear(4 * 12 * 12, 10).set_name("fc"), nn.LogSoftMax())


def round_trip(m, variables, device):
    """Save (m, variables) as a frozen GraphDef, import it, run it on the
    example's input and differentiate the NLL loss into the imported
    weights: (imported model, output, the gradient tree)."""
    path = os.path.join(tempfile.mkdtemp(prefix="tf_example_"), "frozen.pb")
    tf_interop.save(m, variables, path, (1, 28, 28, 1))
    model, params = tf_interop.load(path, device=device)
    x = torch.as_tensor(np.random.RandomState(0).rand(2, 28, 28, 1),
                        dtype=torch.float32, device=device)
    out, _ = model.apply(params, x, training=False)
    y = torch.as_tensor([1, 2], dtype=torch.int32, device=device)
    crit = nn.ClassNLLCriterion()
    p = tree_map(lambda t: t.detach().requires_grad_(), params["params"])
    o, _ = model.apply({"params": p, "state": params["state"]}, x,
                       training=False)
    grads = torch.autograd.grad(crit(o, y), tree_leaves(p))
    return model, out, grads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    m = build_model()
    variables = m.init(torch.Generator().manual_seed(0), device=device)
    model, out, grads = round_trip(m, variables, device)
    print("imported TF model output:", tuple(out.shape))
    print("grad leaves:", len(grads))
    return model


if __name__ == "__main__":
    main()
