"""Tensor ops and hand-written CUDA kernels of the port (counterpart:
bigdl_tpu/ops/). Kernel sources live in `csrc/` and build at first use
(`_build.py`), never at import."""

from bigdl_tpu_torch.ops.fused_rnn import bilstm_scan, gru_scan, lstm_scan
