"""bigdl_tpu_torch.parallel — the process mesh, the flat parameter
layout and data-parallel training with ZeRO-1/2 (counterpart:
bigdl_tpu/parallel/; reference: bigdl/parameters/ and
optim/DistriOptimizer). Tensor, pipeline, sequence and expert
parallelism wait for ROADMAP.md queue A.8, step 5."""

from bigdl_tpu_torch.parallel.mesh import (
    Mesh, host_to_global, make_mesh, parse_axes, place_global, replicated,
    sharded,
)
from bigdl_tpu_torch.parallel.data_parallel import (
    FlatParamSpec, make_dp_accum_steps, make_dp_eval_step,
    make_dp_train_step,
)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer

__all__ = ["DistriOptimizer", "FlatParamSpec", "Mesh", "host_to_global",
           "make_dp_accum_steps", "make_dp_eval_step", "make_dp_train_step",
           "make_mesh", "parse_axes", "place_global", "replicated",
           "sharded"]
