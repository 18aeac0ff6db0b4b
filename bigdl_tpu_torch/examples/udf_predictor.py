"""Model-as-UDF serving (reference: example/udfpredictor — there a
Spark SQL UDF classifying text columns; here the same shape without
Spark: wrap a trained model as a column function over a DataFrame-like
dict, batching under the hood via Predictor).

Ports examples/udf_predictor.py to bigdl_tpu_torch.

    python -m bigdl_tpu_torch.examples.udf_predictor [--device cpu]
"""

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.optim import Predictor
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout


def make_udf(model, batch_size: int = 64):
    """model → callable mapping a sequence of feature arrays to class ids
    (the reference registers the same thing as a SQL UDF)."""
    predictor = Predictor(model, batch_size=batch_size)

    def udf(features):
        ds = DataSet.array([Sample(np.asarray(f), np.int32(0))
                            for f in features])
        return predictor.predict_class(ds)

    return udf


def build_model():
    """A "trained" text classifier stand-in."""
    return nn.Sequential(
        nn.LookupTable(50, 16), nn.TemporalMaxPooling(-1),
        nn.Reshape([16]), nn.Linear(16, 3), nn.LogSoftMax())


def classify_frame(model):
    """The example's 6-row frame with its predicted column."""
    rng = np.random.RandomState(0)
    df = {"id": list(range(6)),
          "tokens": [rng.randint(0, 50, 12).astype(np.int32)
                     for _ in range(6)]}
    classify = make_udf(model)
    df["predicted"] = list(classify(df["tokens"]))
    return df


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    model = build_model()
    model.build(torch.Generator().manual_seed(0), device=device).evaluate()
    df = classify_frame(model)
    for i, p in zip(df["id"], df["predicted"]):
        print(f"row {i}: class {int(p)}")
    return df


if __name__ == "__main__":
    main()
