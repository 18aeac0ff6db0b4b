"""bigdl_tpu_torch.optim — training orchestration (counterpart:
bigdl_tpu/optim/): the Optimizer builder and LocalOptimizer loop, SGD
and Adam, schedules, triggers and metrics."""

from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD, Adam
from bigdl_tpu_torch.optim.lr_schedule import (
    LearningRateSchedule, Default, Step, MultiStep, EpochStep, EpochDecay,
    Poly, Exponential, NaturalExp, Warmup, Plateau, SequentialSchedule,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optimizer import Optimizer, LocalOptimizer
