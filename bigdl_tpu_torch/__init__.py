"""bigdl_tpu_torch — the PyTorch/CUDA port of `bigdl_tpu`.

A second package beside the JAX one (bigdl_tpu/), with the same layout
and names so each module's counterpart is easy to find (every module's
docstring names the file it ports). It imports `torch` and numpy only, never
`jax` or `bigdl_tpu`; the host-side pure-Python modules it needs are
copied, not imported.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`utils.device.resolve_device`). Every TPU kernel on a ported path is a
hand-written Hopper kernel behind an `impl=` switch whose `"torch"`
value is the plain PyTorch version; on a CPU tensor the switch takes
the plain version, on a CUDA tensor it launches the kernel or raises.

Ported so far, slice by slice:

1. serving — the Transformer-LM's paged KV prefill/decode through
   `serving.InferenceEngine`, with the CUDA paged-decode kernel
   (`ops/csrc/paged_decode.cu`);
2. training — `optim.Optimizer(...).optimize()` (`LocalOptimizer`,
   SGD/Adam, schedules, triggers, mixed precision) over
   `dataset.DataSet.array`, with `nn.ChunkedSoftmaxCE` fused into the
   Transformer-LM (`ops/losses.py`) and flash attention forward and
   backward in the CUDA kernels of `ops/csrc/flash_attention.cu`;
3. recurrent — `models/rnn.py` (BiLSTM sentiment classifier, LSTM LM,
   simple RNN) on the `nn` layers it needs (containers, embedding,
   linear, activations, criteria, `nn/recurrent.py`), trained through
   the same `Optimizer`, with the LSTM time loop — one or two
   directions, forward and backward — in the persistent CUDA kernels of
   `ops/csrc/fused_rnn.cu`;
4. GRU, validation and prediction — the GRU kernels of the same file,
   `set_validation`, `Evaluator` and `Predictor`;
5. CNNs — LeNet-5 and the ResNets, Inception v1/v2, VGG and
   AlexNet through `models/perf.py`, `nn.Graph`, dropout, the
   `ml/estimator.py` pipeline API and the TreeLSTM (`models/treelstm.py`),
   on cuDNN and ATen (no Pallas kernel lies on that path);
6. long runs — checkpoints in the JAX package's format and resume
   (`serialization/`), gradient accumulation, the anomaly guard
   (`utils/anomaly.py`), fault plans (`utils/faults.py`), TensorBoard
   summaries (`visualization/`, `obs/training.py`) and the other optim
   methods, in `optim.Optimizer`.
"""

__version__ = "0.1.0"
