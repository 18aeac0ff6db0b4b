"""bigdl_tpu_torch.serialization — training checkpoints and the module
serializer (counterpart: bigdl_tpu/serialization/): the JAX package's
full and sharded checkpoint formats and its module files
(`save_module`/`load_module`), so what either package writes loads in
the other."""

from bigdl_tpu_torch.serialization.checkpoint import (
    Checkpoint, CheckpointCorruptError, load_pytree, save_pytree,
    verify_pytree,
)
from bigdl_tpu_torch.serialization.module_serializer import (
    load_module, module_to_spec, save_module, spec_to_module,
)
