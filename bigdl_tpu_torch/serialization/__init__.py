"""bigdl_tpu_torch.serialization — training checkpoints (counterpart:
bigdl_tpu/serialization/): the JAX package's full and sharded formats,
so a checkpoint written by either package loads in the other. The module
serializer (`save_module`/`load_module`) is queued (ROADMAP.md, A.10)."""

from bigdl_tpu_torch.serialization.checkpoint import (
    Checkpoint, CheckpointCorruptError, load_pytree, save_pytree,
    verify_pytree,
)
