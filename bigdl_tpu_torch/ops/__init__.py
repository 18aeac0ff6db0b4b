"""Tensor ops and hand-written CUDA kernels of the port (counterpart:
bigdl_tpu/ops/). Kernel sources live in `csrc/` and build at first use
(`_build.py`), never at import.

As in the JAX package, `flash_attention` here is the function: reach the
module with `importlib.import_module("bigdl_tpu_torch.ops.flash_attention")`.
"""

from bigdl_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    flash_attention_with_lse,
)
from bigdl_tpu_torch.ops.fused_rnn import bilstm_scan, gru_scan, lstm_scan

__all__ = [
    "attention_reference",
    "bilstm_scan",
    "flash_attention",
    "flash_attention_with_lse",
    "gru_scan",
    "lstm_scan",
]
