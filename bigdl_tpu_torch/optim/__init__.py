"""bigdl_tpu_torch.optim — training orchestration (counterpart:
bigdl_tpu/optim/): the Optimizer builder and LocalOptimizer loop, SGD,
Adam, Adagrad, Adamax, RMSprop, AdaDelta, Ftrl and LBFGS, schedules,
triggers, metrics, validation methods, Evaluator and Predictor."""

from bigdl_tpu_torch.optim.optim_method import (
    OptimMethod, SGD, Adam, Adagrad, Adamax, RMSprop, AdaDelta, Ftrl,
)
from bigdl_tpu_torch.optim.lbfgs import LBFGS
from bigdl_tpu_torch.optim.lr_schedule import (
    LearningRateSchedule, Default, Step, MultiStep, EpochStep, EpochDecay,
    Poly, Exponential, NaturalExp, Warmup, Plateau, SequentialSchedule,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optimizer import Optimizer, LocalOptimizer
from bigdl_tpu_torch.optim.validation import (
    ValidationResult, ValidationMethod, Top1Accuracy, Top5Accuracy, Loss,
    TreeNNAccuracy, HitRatio, NDCG, MAE,
)
from bigdl_tpu_torch.optim.evaluator import (Evaluator, Predictor,
                                             LocalPredictor)
