"""ML pipeline API (counterpart: bigdl_tpu/ml/; reference:
org.apache.spark.ml.DL* inside the dl tree)."""

from bigdl_tpu_torch.ml.estimator import (DLClassifier, DLClassifierModel,
                                          DLEstimator, DLModel)
