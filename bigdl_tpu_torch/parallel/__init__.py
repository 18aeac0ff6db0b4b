"""bigdl_tpu_torch.parallel — the process mesh, the flat parameter
layout, data-parallel training with ZeRO-1/2, and the tensor, sequence,
pipeline and expert parallel strategies (counterpart:
bigdl_tpu/parallel/; reference: bigdl/parameters/ and
optim/DistriOptimizer). The JAX package's names, exported alike; the
port's own pieces (`Mesh`, `P`, `place_global`, the differentiable
collectives of `collectives.py`, the `launch.py` rank spawner) are
reached through their modules. `shard_map_compat` has no port: each
rank is a process, and `collectives.bind(mesh)` binds the axis names."""

from bigdl_tpu_torch.parallel.mesh import (
    host_to_global, make_mesh, parse_axes, replicated, sharded,
)
from bigdl_tpu_torch.parallel.data_parallel import (
    FlatParamSpec, make_dp_accum_steps, make_dp_eval_step,
    make_dp_train_step,
)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.ring_attention import (
    make_ring_attention, ring_attention, ulysses_attention,
    zigzag_ring_attention,
)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    make_transformer_train_step, shard_params, slot_specs_for,
    transformer_tp_specs,
)
from bigdl_tpu_torch.parallel.pipeline import (
    interleaved_bubble_fraction,
    make_pipeline_train_step,
    pipeline_bubble_fraction,
    pipeline_specs,
    to_virtual_layout,
)
from bigdl_tpu_torch.parallel.moe import (
    MoE, make_moe_lm_train_step, moe_lm_specs, moe_specs,
)

__all__ = ["DistriOptimizer", "FlatParamSpec", "MoE", "host_to_global",
           "interleaved_bubble_fraction", "make_dp_accum_steps",
           "make_dp_eval_step", "make_dp_train_step", "make_mesh",
           "make_moe_lm_train_step", "make_pipeline_train_step",
           "make_ring_attention", "make_transformer_train_step",
           "moe_lm_specs", "moe_specs", "parse_axes",
           "pipeline_bubble_fraction", "pipeline_specs", "replicated",
           "ring_attention", "shard_params", "sharded", "slot_specs_for",
           "to_virtual_layout", "transformer_tp_specs",
           "ulysses_attention", "zigzag_ring_attention"]
