#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving (with its reliability layer,
layouts, spill tier and disaggregated prefill), training (with
checkpoints, resume, gradient accumulation and the anomaly guard),
recurrent, CNN and TreeLSTM paths, its text, record-file and TFRecord
input pipelines, LBFGS, criterions and eager facade, MultiHeadAttention,
the rest of nn/ (int8, sparse, volumetric, ...), the NCF,
TextClassifier and autoencoder models, data-parallel training, the
MoE-FFN LM, the tensor/pipeline/sequence/expert-parallel steps at world
size 1, sharded checkpoints, tensor-parallel serving at world size 1,
the serving fleet (router, tenancy, autoscaler, the telemetry plane),
speculative decoding with a distilled, hot-swapped draft, a vision
group beside the LM pool, the fleet simulator's card calibration, the
command-line scripts (load generator, report surfaces, fault drill), the
training plane's telemetry, the keras surface, module files,
Caffe/TensorFlow model import, the LM's dense-cache decode, and the
trainer's LM at two heads (head dim 256) and at one (head dim 512)
trained and served, on one NVIDIA GPU and check them; then
run the port's static analysis over the port.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --profile  # also: where decode, train,
                                     # ResNet-50, Inception and MHA
                                     # steps go

It drives `bigdl_tpu_torch` only (never JAX or the JAX package):

1. device — the card's name and `nvidia-smi` name/power limit;
2. build  — compiles every CUDA kernel from the sources in the checkout
   (`bigdl_tpu_torch/ops/_build.py`: one nvcc per source for sm_90a, all
   started together) and reports ptxas registers/spills; for each flash,
   paged-decode, LSTM and GRU kernel also its tensor-core instructions
   in the built SASS (`cuobjdump -sass`: HGMMA for wgmma, HMMA for
   mma.sync). Fails if one of those kernels spills or is missing
   (RNN_BUILT_KERNELS), or a bf16 flash kernel, bf16 LSTM backward or
   GRU sweep, or bf16 dW kernel has no tensor-core instruction;
3. kernel — the paged-decode kernel against its plain PyTorch version
   on DECODE_CASES: the engine's shape (B=8, H=8, 37 blocks of 16,
   D=64) with ragged clocks including 0 and S-1, one key, and a 4096-key
   extent at D=128 with clocks 0, 2047 and 4095 (ranks of a cluster see
   no key), the engine's shape at two heads of D=256 and at one head of
   D=512, the scripts' tiny LMs (bigdl_tpu_torch/scripts/: 4 slots, H=2,
   96 keys at D=16; 2 slots, 64 keys at D=8), and D = 20, 48, 80, 320
   (between and above the kernel's tiers; D = 20 in bf16 copies its
   40-byte rows element by element) and 1100 (the row-split kernel
   above the tiers); shuffled tables, a NaN scratch block 0 and
   NaN rows past each clock inside its last page; fp32 and bf16 pools
   (max abs err <= 2e-5); each row of a launch must be BITWISE the same
   row launched alone; times at those shapes but one_key and long with
   CUDA events, L2 flushed before each launch;
4. flash  — the flash-attention kernels (forward; backward = dk/dv +
   dq launches) against their plain versions on FLASH_CASES: the
   training shape (BH=64, S=2048, D=64, causal), a long sequence
   (BH=8, S=8192), ragged lengths with Sq != Sk and fully masked rows,
   D = 32/128, no mask, sm_scale = 0, one query over 65 keys, 129
   rows and keys at D = 128 (one past the bf16 forward's 128-row CTA),
   and at D = 256 the trainer's shape at two heads (BH=16, S=2048),
   ragged lengths and D = 160 (padded to 256), and above 256 on the
   column-split kernels the trainer's shape at one head (BH=8, S=2048,
   D=512), D = 320 ragged and D = 512 with fully masked rows, every
   column slice's lse row bitwise the first's; fp32 and bf16 (bf16 on
   the tensor cores); bf16 also element by element (in bf16 ulps)
   against the plain versions that round where the kernels round, while
   the same versions without the roundings must fail that check; two
   backward runs bitwise equal; gradients through both outputs of
   flash_attention_with_lse, kernels vs plain; kernel, plain and SDPA
   (library yardstick) times at the three training shapes, the long
   sequence, D = 160 (the padding's cost) and D = 320;
5. dense_decode (after engine) — `TransformerLM.init_cache` /
   `prefill` / `decode_step` at bench.py bench_lm_decode's
   configuration: the 43M LM (fp32 weights, serving_params layout), a
   512-token prompt, 128 greedy tokens over an fp32 cache (the prefill
   launching the flash forward once a layer, counted from 0), the
   prefill's and five decode steps' logits within 1e-4 of the full
   forward, 16 steps over a bf16 cache within 0.1; prefill ms and
   decode ms a token; the greedy tokens against the paged
   InferenceEngine's (equal, or where they part and the top-2 margin);
5a. model — the 43M Transformer-LM at full width: `decode_step_paged`
   through the kernel against the plain version on the same pools and
   tokens for 8 steps (logits max abs diff <= 1e-4);
6. engine — the serving path: `InferenceEngine.run` serves a warm-up
   wave and then a timed wave of 16 ragged greedy requests (prompts of
   512/253/495/170 tokens, 64 new tokens each, 8 slots, prefill buckets
   256/512 — the repository's serving benchmark configuration). The
   kernel's launch count is set to 0 just before the timed wave and
   read just after; it must equal decode steps x layers. Reported, not
   gated: token agreement with a plain-attention engine and whether a
   warm (prefix-cache) admission decodes bitwise like a cold one;
6a. engine_lifecycle — the engine's request lifecycle on an injected
   clock (1.0 a step): a scripted wave of 16 through 8 slots with
   max_queue=4 and shed-lowest-priority — 4 deadlines that run out
   mid-decode, 2 queue-wait TTLs that run out queued, a cancellation
   queued and one in flight, a named shed victim — through the kernel
   engine and the plain-attention engine: statuses, reasons, ttft_s and
   latency_s equal and as scripted, done tokens equal, K1 launches ==
   steps x 8;
6b. engine_faults — serve_nan poisons slot 0 and every other request's
   tokens equal the clean run's; serve_err retried once (tokens equal)
   or twice (degraded, all failed, submit raises); serve_slow trips a
   0.5 s step watchdog armed at construction (once, at the faulted
   step); drain() mid-wave (draining, then drained, tokens equal);
   health()'s decode p50/p95/p99;
6c. engine_layouts — the timed wave under fp32/float32, fp32/bfloat16
   and int8/bfloat16 (bf16 pools run K1's bf16 instantiation), in turns
   on two waves: launches exact, bf16 kernel engines against plain bf16
   engines (agreed prefix >= 0.9), lossy layouts against fp32 (agreed
   prefix >= 0.25, first tokens >= 0.6); tokens/s, step ms, device ms a
   step, pool GiB, weight bytes (per token); swap_params mid-wave to the
   same weights leaves the tokens bitwise unchanged;
6d. engine_spill_handoff — fp32, bitwise: a second wave of the first
   wave's (sampled) prompts through the default 297-block pool with
   spill=True spills and re-admits and decodes the cold wave's tokens;
   export_tree into a fresh engine (import_tree) gives prefix hits and
   the same tokens; a role="prefill" engine hands the timed wave to a
   role="decode" engine (take_handoffs/import_handoff) with the engine
   phase's tokens; seconds a spill and a re-admission (per MiB), export
   and import a request, tree export and import;
7. train_model — one fp32 loss-and-grad step of the 43M LM at B=8,
   S=2048 through the flash kernels against the same step through the
   plain versions (|dloss| <= 1e-4, gradients <= 1e-3 relative);
8. trainer — the training path: `Optimizer(model, DataSet.array(...),
   nn.ChunkedSoftmaxCE(), batch_size=8).set_optim_method(Adam(3e-4))
   .set_precision("bf16").optimize()` on the repository's 43M training
   benchmark configuration (remat "attn_saved", synthetic next-token
   data). The flash launch counts are set to 0 after 2 warm-up steps
   and read after 10 timed steps: forward launches == steps x layers,
   backward == steps x layers x 2; losses finite and falling; train
   tokens/s, ms a step and the model-flops share;
8a. train_telemetry — the same loop with obs on and off in turns: the
   loss streams bitwise equal, one train_step event and the registry
   series a step with obs on, none with it off, checkpoint_save and
   checkpoint_load on a save and a resume; step ms of both and the
   telemetry's host ms a step;
9. lm_resume — checkpoint and resume through the flash kernels: the
   trainer's LM with `set_gradient_accumulation(2)`, four runs from the
   same seeded weights and samples through `Optimizer(...).optimize()`:
   U (8 micro-steps), U' (U again: the card repeats its own run bit for
   bit, or the phase names where the runs part), R1 (async checkpoints
   every 3 micro-steps, a train summary, the fault plan
   "ckpt_corrupt@6,preempt@7": checkpoint 3 holds the accumulator, 6
   is published and damaged, the run dies preempted) and R2 (another
   seed's model, `resume_from_checkpoint()`, synchronous checkpoints:
   it skips the damaged checkpoint and resumes from 3). Gates: R2's
   params and U''s equal U's leaf for leaf (`torch.equal`), R2 ends at
   neval 8 and nupdates 4, each run's flash launches exact, R1's Loss
   scalars finite at steps 1-6. Reported: the checkpoint's GiB, each
   save's stall (async and sync), load and fast-forward seconds, U's
   micro-step against the trainer's step, and the step of the trainer's
   configuration unguarded and guarded (skip_step, no fault) in turns;
10. rnn    — the persistent-LSTM kernels (forward with and without
   residuals, backward; one or two directions a launch) against their
   plain versions on RNN_CASES: the BiLSTM trainer's shape (N = T = H =
   128) with one and two directions, the LSTM LM's shape (N = 32, T =
   64, one direction), a ragged batch of 37 rows, T = 1, H = 512 and
   H = 200; fp32 (forward <= 2e-5 abs, gradients <= 1e-4 relative) and
   bf16 element by element against the plain versions that round where
   the kernels round (<= 4 ulps, <= 2% off; the unrounded control must
   exceed 2% wherever T > 1), with bf16 dW also held to the plain
   backward's dW (RNN_BF16_DW_TOL relative); two backward runs bitwise
   equal; kernel, plain and cuDNN (`torch.nn.LSTM`, library yardstick)
   times at the trainer's and the LM's shapes;
11. rnn_model — one fp32 loss-and-grad step of the full-width BiLSTM
   classifier (vocab 20000, 128/128, batch 128 x 128) and of a 2-layer
   LSTM LM (vocab 10000, batch 32 x 64) through the kernels against the
   same step through the plain versions;
12. rnn_trainer — the recurrent path: `Optimizer(bilstm_sentiment(20000,
   128, 128), DataSet.array(...), nn.ClassNLLCriterion(), batch_size=
   128).set_optim_method(Adam(1e-3)).set_precision("bf16").optimize()`
   on learnable token data, 2 warm-up + 10 timed steps (kernel launches
   counted from zero: 10 forward, 10 backward; losses finite and
   falling; samples/s), an inference pass under torch.no_grad() over 4
   batches (4 no-residual forward launches; accuracy), and the 2-layer
   LSTM LM through the same loop (2 launches a step each way);
   `--profile` adds a torch.profiler breakdown of one BiLSTM step;
13. gru    — the persistent-GRU kernels (forward with and without
   residuals, backward; one direction a launch) against their plain
   versions on GRU_CASES: the BiGRU trainer's shape (N = T = H = 128),
   T = 1, a ragged batch of 37 rows, H = 100 and H = 512; fp32 (forward
   <= 2e-5 abs: ys, zr, cand; gradients <= 1e-4 relative: dzg, dzc,
   dW_g, dW_c) and bf16 element by element against the plain versions
   that round where the kernels round: driven by the kernel's own
   stored carries (<= 4 ulps, <= 2% off), free-running and summed in
   fp64 (<= 8% off; the unrounded control must exceed 8% wherever
   T > 1), bf16 dW also held to the plain backward's dW
   (RNN_BF16_DW_TOL relative); the inference variant's ys bitwise the
   training variant's; two backward runs bitwise equal; kernel and
   plain times at the trainer's shape, with cuDNN's torch.nn.GRU timed
   as a yardstick of a different function;
14. gru_model — one fp32 loss-and-grad step of the full-width BiGRU
   classifier (LookupTable(20000, 128) -> BiRecurrent(GRU(128, 128)) ->
   Mean(2) -> Linear(256, 2) -> LogSoftMax, batch 128 x 128) through
   the kernels against the same step through the plain versions (2
   forward and 2 backward launches);
15. gru_trainer — the slice's main path: `Optimizer(bigru, DataSet.
   array(...), nn.ClassNLLCriterion(), batch_size=128).set_optim_method(
   Adam(1e-3)).set_precision("bf16").set_validation(Trigger.
   several_iteration(6), held-out data, [Top1Accuracy(), Loss(...)])
   .optimize()`, 2 warm-up + 10 timed steps (launches counted from
   zero: 2 training forwards and 2 backwards a step, 2 inference
   forwards a validation batch; validation time kept apart from the
   step time), then `Predictor.predict` over 4 batches (2 inference
   forwards a batch) and `predict_class`, then one step under
   torch.profiler (device busy share, where the step's time goes);
16. cnn_layers — the CNN slice's layers (BASELINE configs 1 and 2; no
   TPU kernel lies on this path: convolutions run on cuDNN): every
   ported conv (grouped, dilated, transposed, SAME, the s2d stem's
   asymmetric (2, 1) pads, temporal), pooling (ceil mode,
   count_include_pad=False, SAME, window sums), batch-norm, LRN and norm
   layer and every table container and table op on the card against
   the same module on the CPU, fp32, seeded variables with random
   batch-norm gammas (forward and new running statistics <= 1e-5 of
   each output's largest entry, gradients <= 1e-4 of each gradient's);
17. resnet_model — a full-width ResNet-50 (build_imagenet(50, 1000),
   seed 0, seeded batch-norm gammas) training step at batch 2 on the
   card against the port's CPU route: in fp32 the loss <= 1e-4 relative
   and the new running statistics <= 1e-3 of each leaf's largest entry;
   every gradient <= 1e-3 of its leaf's largest entry in fp64 (fp32
   gradients, discontinuous at their rounding level, are reported);
18. lenet_trainer — BASELINE config 1: LeNet-5 through `Optimizer(...)
   .set_validation(Trigger.every_epoch(), ...).optimize()` on
   synthetic_mnist(512), batch 64, Adam(2e-3), 3 epochs, then
   `Evaluator` over synthetic_mnist(128, seed=9): top-1 > 0.9; each
   epoch's wall time;
19. lenet_guard — the anomaly guard's three policies on BASELINE
   config 1 (the LM's integer tokens cannot carry a NaN batch): LeNet-5,
   batch 64, Adam(2e-3), cuDNN's deterministic algorithms; skip_step
   with "nan@3" (the params after step 3 equal those before it bit for
   bit, one skip, nupdates == neval - 1), rollback with a checkpoint
   every 2 steps and "nan@5" (final params equal a clean run's bit for
   bit, one rollback), halt (raises AnomalyError);
20. resnet_trainer — BASELINE config 2: `models.perf.run_perf(
   "resnet50", 256, 10, optimizer="sgd", precision="bf16")` (images/s,
   step ms, peak memory, the forward counted from the conv and linear
   shapes and checked against ~4.1 GMAC an image, the model-flops share
   at the dense bf16 peak), then the CIFAR ResNet-20 through Optimizer
   for 12 steps (batch 128, SGD(0.1, momentum 0.9), validation after
   steps 6 and 12): losses finite and falling, running statistics
   changed, validation counts whole; `--profile` adds resnet_profile,
   one ResNet-50 step under torch.profiler (busy share, top device
   operations, copy and relayout kernels);
21. inception_trainer — BASELINE config 3: `models.perf.run_perf(
   "inception-v1", 256, 10, optimizer="sgd", precision="bf16")` (the
   resnet_trainer fields, the forward checked against ~1.58 GMAC an
   image, and the busy share of one more profiled step), the
   branch-fused `inception.build(fused_branches=True)` (nn.Graph
   layers) forward on the card against the CPU, fp32, batch 2 (<= 1e-4
   of the largest log-probability), and one short run_perf of AlexNet
   and of Inception-v2; `--profile` adds inception_profile, the LRN and
   concat share of a step's device time;
22. vgg_estimator — BASELINE config 5: run_perf("vgg16", 128, 10, bf16)
   as above (~15.47 GMAC), then VGG-16's body with the weights that run
   trained under a new 10-class head, fit by `ml.DLClassifier` over a
   dict-of-lists frame of seeded 224 x 224 x 3 images (batch 128, 3
   steps, fp32) and `transform`ed: the body starts from the trained
   weights, losses finite, predictions in [0, 10), one a row;
23. treelstm_trainer — BASELINE config 4's TreeLSTM half at
   bench_treelstm's widths (vocab 20000, d 300, h 150, 5 classes, batch
   128, 64 nodes, Adam(3e-3), bf16) through `Optimizer(...)
   .set_validation(..., [TreeNNAccuracy(), Loss(...)]).optimize()` on
   the wavefront schedule, 2 warm-up + 10 timed steps (samples/s, busy
   share of one more profiled step): losses finite and falling,
   validation counts whole; then one batch in fp32 through both
   schedules, the wavefront's loss and gradients against the slot
   scan's (rtol 1e-5, atol 1e-6), and each schedule's bf16 loss and
   backward time;
24. text_lm — raw text to the LSTM LM (K6/K7): a generated corpus of
   20000 sentences of 10-80 words, Zipf over 12000 words (PTB's size),
   `Dictionary(..., vocab_size=9999)` and `DataSet.array(texts) >>
   (SentenceTokenizer() >> SentenceBiPadding() >>
   TextToLabeledSentence(d) >> LabeledSentenceToSample(64))` into
   `Optimizer(rnn.lstm_lm(10000, 128, 128, num_layers=2), ...,
   TimeDistributedCriterion(ClassNLLCriterion()), batch 32)` in bf16,
   2 + 30 steps, `Loss` over 512 held-out sentences after the last:
   K6 and K7 exactly 2 launches a step each, the first batch the card
   got equal to a host run of the pipeline bit for bit, the first step's
   loss and gradients equal to the plain recurrences' (fp32 1e-4 /
   1e-3; bf16 2e-2), losses falling; tokens/s, the pipeline's host ms a
   batch and share of the step, the busy share;
25. records_trainer — disk to ResNet-20: 50000 32 x 32 x 3 images in 8
   BDLS shards (153.8 MB) through `RecordFileDataSet(batch 128,
   mean/std, pad=4, hflip=True)` into `Optimizer(resnet.build_cifar(20,
   10), SGD(0.1, momentum 0.9))` for 5 + 200 steps, `Evaluator` over the
   shards, the same steps fed from `DataSet.array`, and 1024 of the
   images through `write_image_examples` and `TFRecordDataSet` for 4
   steps: eval batches equal the in-memory normalisation bit for bit,
   the loss falls; images/s from disk and memory, the host ms a batch of
   the file prefetcher and of the TFRecord read, the busy share;
26. lbfgs — `optim.LBFGS` on Rosenbrock (fp32) and on LeNet-5 over one
   batch of 1024 synthetic MNIST images (20 iterations, history 10,
   strong Wolfe; fp32 timed, fp64 card vs CPU within 1e-6); ms and
   fevals an iteration;
27. criterions — all 21 criterions, forward and gradient, card vs CPU,
   fp32 (1e-5 of max(1, |CPU value|));
28. eager_facade — LeNet-5 and ResNet-20 built on the card: the eager
   forward in training mode stores `apply`'s new state, `evaluate()`'s
   forward equals `apply(..., training=False)`, `get_parameters()` has
   the parameter count;
29. mha — `nn.MultiHeadAttention` on the flash kernels at the 43M LM's
   attention widths (E = 512, 8 heads of 64, batch 8 x 2048): one fp32
   causal self-attention layer, forward and backward, kernels against
   `impl="torch"` from the same weights (output and every parameter
   gradient within the flash gates; the key bias's gradient, zero in
   exact arithmetic, below the gradient gate in both), 1 forward and
   2 backward launches; cross-attention over 512 encoder rows; 8 heads
   of 80 (D padded to 128 by the wrapper); a Sequential of 4 causal
   layers trained by Optimizer in bf16 with MSECriterion for 2 + 10
   steps (loss falls, flash launches 40 / 80 in the timed steps;
   tokens/s; with --profile one more step's busy share and flash ms);
   fp32 incremental decode (a 512-token prompt, 64 `apply_decode`
   steps) row for row `apply`'s within 1e-5, with NaN key and value
   rows past one row's clock leaving every output finite;
30. nn_extra — PReLU, SReLU, RReLU, CMul, CAdd, Bilinear, Cosine,
   Euclidean, MM, MV, DotProduct, CosineDistance, the upsampling and
   volumetric layers (a C3D clip: 8 x 16 x 112 x 112 x 3) and the sparse
   layers (1,000,000 columns, capacity 64, batch 4096) on the card
   against the CPU, as cnn_layers; RReLU's training slopes in bounds;
   SparseTensor products card vs CPU;
31. quantized — LeNet-5 from lenet_trainer quantized: held-out top-1 of
   int8 within 1 point of fp32; ResNet-50 (224 x 224, batch 64, seeded)
   int8 against fp32: top-1 agreement, logits' relative error,
   images/s and weight bytes of both; int32 accumulators card vs CPU
   bit for bit;
32. ncf_textcls — NeuralCF at MovieLens-1M's sizes for one epoch
   (batch 2048, validated on the held-out 10%), the TextClassifier at
   news20's from a GloVe-shaped embedding and the autoencoder on MNIST
   through Optimizer: losses falling, step ms, samples/s and the busy
   share of one profiled step each;
33. native_plane, distri_cli, distri_parity, convlstm (PR 16) — the
   C++ data plane, ResNet-50 through the training CLI's `--mesh data=1`
   under NCCL, DistriOptimizer against LocalOptimizer (LeNet-5 and the
   LM under ZeRO-2), ConvLSTMPeephole card vs CPU;
34. moe_lm — the MoE-FFN LM at the 43M LM's widths (8 experts, top-2,
   capacity 1.25, bf16) through `Optimizer(...).optimize()`: 2 warm-up
   and 10 timed steps, K2/K3 exactly 8 / 16 a step, one profiled step
   (busy share); first batch through the kernels vs plain attention
   (loss within 2e-2, the first layer's routing 98% alike); the MoE
   layer alone in fp32,
   card vs CPU; tokens/s, step ms, peak memory, dropped share a layer;
35. parallel_w1 — one NCCL rank, every mesh axis 1, fp32 full
   log-softmax: the dp x tp step and the pipeline step (4 microbatches)
   against LocalOptimizer (loss, params after a step), Ulysses against
   ops.flash_attention, the expert-parallel step against moe_lm's loss;
   launches and ms a step;
36. sharded_ckpt — the 43M LM under DistriOptimizer(zero=2) with async
   sharded checkpoints, preempted and resumed from another seed's
   weights: masters bit for bit the uninterrupted run's; save stalls,
   resume seconds;
37. tp_serve (after engine_spill_handoff) — the engine's timed wave
   through `InferenceEngine(model, tp_mesh=mesh)` on a one-rank NCCL
   mesh {model: 1} (serving/tp.py): tokens and statuses bitwise the
   engine phase's, K1 launches exact, gather_serving_params ->
   shard_serving_params -> gather bitwise; decode ms a step and
   tokens/s beside the unsharded engine's;
37a. fleet (after tp_serve) — an EngineRouter over two engines with a
   TenancyController (a steady and a flooding tenant), an Autoscaler
   (max_engines=3), a MetricsSampler and an AlertEngine on a p99
   objective, a ScrapeServer on port 0 and a FlightRecorder, on one
   virtual clock: 32 shared-prompt requests (256 tokens, 90% shared,
   greedy and seeded) and a trickle; serve_slow trips engine e0's
   0.5 s watchdog and its requests fail over. Gates: one terminal a
   request, served tokens bitwise a single engine's, no lost journey
   hop, the alert fires and resolves, /metrics is render_prometheus()'s
   bytes, one engine_degraded bundle, K1 launches = decode steps x 8;
   router host ms a round;
37b. spec — row bits: 8 rows decoded alone bitwise their copies among
   the 32 of a verify-shaped call (fp32 and bf16 pools; 8-row tiles,
   as the engine runs the step; untiled, the control, reported); a
   SpeculativeEngine (k = 3; the 43M target with planted
   predictability, a 64-wide 2-layer draft) on the same burst: tokens
   bitwise the target-only engine's, K1 once a layer a round over 32
   verify rows, a draft watchdog trip falling back with the tokens
   unchanged; accept rate and tokens/s against target-only;
37c. distill — the spec setup's target-only streams distilled into the
   draft (serving/distill.py: ZeRO-2 on a one-rank mesh, K2-K5 counted
   exactly), two distills bitwise equal, the draft hot-swapped into a
   live adaptive SpeculativeEngine serving a second burst: tokens
   bitwise target-only, K1 exact; accept rates (seeded, greedy) and
   tokens/s before and after the swap;
37d. vision_fleet — a `model_tag="vision"` group of LeNet-5
   VisionEngines beside the fleet's LM pool under one EngineRouter, one
   mixed burst: classes equal Predictor.predict_class, LM tokens
   bitwise the LM-only fleet's, none lost, K1 exact; images/s, router
   host ms a round, forward builds;
37e. sim_calibration — the simulator's card reading (step_study's
   decode and prefill ms a token, card and power limit) written to
   chiprun_out/sim_calibration.json, then one seeded 24-request trace
   through a real one-engine fleet and a SimulatedEngine fleet (per-step
   pacing), both through the scripts' loadgen `replay`: terminal counts
   and goodput equal, K1 exact; latency, TTFT and makespan divergence
   beside the tolerance;
37f. scripts_loadgen — the scripts' load generator
   (bigdl_tpu_torch/scripts/loadgen.py) over the fleet's 43M LM (2
   engines x 8 slots, the autoscaler up to 3, a p99 objective): 64
   seeded requests (greedy bursts, sampled Poisson, shared prefixes)
   replayed twice through K1 (reports byte-identical; events to
   chiprun_out/scripts_loadgen.jsonl) and once on plain-path engines
   (statuses and greedy tokens equal), K1 exact; then its CLI twice at
   once (the tiny LM, K1 at D=16): byte-identical reports;
37g. scripts_report — obs_report and ops_console over that JSONL, twice
   each (byte-identical, every section present), and ops_console's
   `--url` frame against an obs.ScrapeServer;
37h. scripts_drill — the fault drill (scripts/fault_drill.py) in this
   process: every serving leg and the six single-process training
   legs on the card, each ok but spec_adapt (its resume gate fails on
   the JAX package too: reported); with one card the two tensor-
   parallel legs skip, with their reason; K1 launched at D=8 and 16;
38. keras — at config 4's widths: `keras.Sequential([Embedding,
   Bidirectional(LSTM), Dense])`, a keras GRU model and a two-input
   functional `Model` (BiLSTM and GRU branches merged by concat),
   compiled with Adam, fit 2 epochs in bf16, evaluated and predicted:
   first step kernels vs plain in fp32, K8/K9 and K10/K11 launches
   exact (fit, evaluate, predict each counted from 0), held-out loss
   falls; samples/s beside rnn_trainer's;
39. module_io — save_module/load_module of ResNet-50 and of the trained
   keras model, save_t7/load_t7 of LeNet-5 (reloaded outputs bitwise),
   `from_torch` of a torch conv/BN/pool/Linear Sequential against its
   own output (fp32, 1e-5); save/load seconds and file sizes;
40. model_import — VGG-16 (config 5, 138.4M parameters, seeded) through
   Caffe (the VGG_ILSVRC_16 form: the loader's flatten idiom, SoftMax)
   and through a TensorFlow GraphDef (`vgg.build(16)` as it is), each
   saved and reloaded on the card by the port's own protobuf codec:
   reloaded variables bitwise, the fp32 forward at 128 x 224 x 224 x 3
   within 1e-5 of max(1, |output|), 10 bf16 SGD steps at 128 of the
   built model and then of the import (images/s beside vgg_estimator's
   native step); Engine's device count and kind, a profiler.trace of
   two import steps holding conv kernels, debug_nans on a card NaN;
41. lm2h — the trainer's 43M LM at two heads (head dim 256, the D = 256
   kernels): one fp32 loss-and-grad step, kernels vs plain, at the
   trainer's tolerances; 2 + 10 bf16 steps through
   `Optimizer.optimize()` (flash launches exact, the loss falls); then
   8 greedy requests served from the trained weights through
   `InferenceEngine` at the engine's knobs (K1 launches exact), tokens
   equal to a plain-attention engine's;
41a. lm1h — the same at one head (head dim 512: the column-split flash
   kernels and the paged-decode kernel's 512 tier);
42. multihost — `bigdl_tpu_torch/scripts/multihost_smoke.py`'s
   kill_resume and zero2_resume legs at one NCCL process on the card:
   the sole training process SIGKILLed once checkpoint-3 publishes and
   restarted with --resume, its params' sha256 equal to the
   uninterrupted run's;
43. examples — 14 of the 15 `bigdl_tpu_torch/examples/` (all but the
   4-stage pipeline_parallel_lm) through their `main(["--device",
   "cuda"])` in this process, each gated on the accuracy, losses,
   outputs or tokens it prints (NCF's metrics and the UDF's classes
   against the example's plain CPU run) and on the launches of the
   kernels its model reaches;
44. lint — `python -m bigdl_tpu_torch.analysis` over the port's tree
   (no JAX on this machine): clean against its baseline;
45. kernels — one JSON line per the port's kernel table, the D = 256,
   16, 8 and 512 instantiations in rows of their own.

Every phase prints one JSON line (`at_s`: the script's seconds when
it ended); any failed check raises and the script exits non-zero. The
last lines are the `nvidia-smi` name/power limit and `{"ok": true,
"device": {...}}`. Full results, with the
compiler's register report, go to chiprun_out/chip_smoke.json.
TF32 is off for matmuls and cuDNN, so fp32 means fp32 throughout.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet), for the roofline bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# the serving benchmark's 43M LM (bench.py bench_lm_decode_batched)
VOCAB, DIM, HEADS, LAYERS = 32000, 512, 8, 8
CONTEXT, NEW_TOKENS, SLOTS, BLOCK = 512, 64, 8, 16
MAX_LEN = CONTEXT + NEW_TOKENS + 8
MAX_LEN += (-MAX_LEN) % BLOCK                       # 592
PROMPT_LENS = (CONTEXT, CONTEXT // 2 - 3, CONTEXT - 17, CONTEXT // 3)
ENGINE_KNOBS = dict(slots=SLOTS, prefill_buckets=(CONTEXT // 2, CONTEXT))

KERNEL_TOL = 2e-5
LOGIT_TOL = 1e-4
# paged-decode cases: (name, B, H, blocks, block size, D, clocks or None
# for ragged clocks with 0 and S - 1). "engine" is the engine's shape,
# timed; "one_key" a table of one block with clock 0; "long" a 4096-key
# extent at D = 128 with clocks 0, 2047 and 4095, so that ranks of a
# cluster see no key; "heads2" the engine's shape for the LM at two
# heads (D = 256, the lm2h phase's serving path), timed; "d16" and "d8"
# the scripts' tiny serving LMs (bigdl_tpu_torch/scripts/: the target,
# 2 heads of 16, 4 slots over a 96-token cache; the speculative draft,
# 2 heads of 8, 2 slots over 64), timed; "heads1" the engine's shape for
# the LM at one head (D = 512, the lm1h phase's serving path), timed;
# "d20", "d48", "d80" head dims between the kernel's tiers and "d320"
# one above 256 (run at the tiers 32, 64, 96 and 384, the pools read at
# their own row stride; a bf16 row of D = 20 is 40 bytes, so its rows
# are copied element by element), and "d1100" one above the largest
# tier (the row-split kernel), timed. Every case has the NaN scratch
# block and NaN rows past each clock inside its last page.
DECODE_CASES = (
    ("engine", SLOTS, HEADS, MAX_LEN // BLOCK, BLOCK, DIM // HEADS, None),
    ("one_key", 1, HEADS, 1, BLOCK, DIM // HEADS, (0,)),
    ("long", 3, HEADS, 4096 // BLOCK, BLOCK, 128, (0, 2047, 4095)),
    ("heads2", SLOTS, 2, MAX_LEN // BLOCK, BLOCK, DIM // 2, None),
    ("d16", 4, 2, 96 // BLOCK, BLOCK, 16, None),
    ("d8", 2, 2, 64 // BLOCK, BLOCK, 8, None),
    ("heads1", SLOTS, 1, MAX_LEN // BLOCK, BLOCK, DIM, None),
    ("d20", 4, 2, 96 // BLOCK, BLOCK, 20, None),
    ("d48", 4, 2, 96 // BLOCK, BLOCK, 48, None),
    ("d80", 4, 2, 96 // BLOCK, BLOCK, 80, None),
    ("d320", 4, 2, 96 // BLOCK, BLOCK, 320, None),
    ("d1100", 4, 2, 96 // BLOCK, BLOCK, 1100, None),
)
DECODE_TIMED = ("engine", "heads2", "d16", "d8", "heads1", "d20", "d48",
                "d80", "d320", "d1100")
# the design of the K1 row of the kernels line
DECODE_DESIGN = ("S split over a thread-block cluster (split_plan: <= 8 "
                 "CTAs a (row, head), by the table extent alone), pages "
                 "through a 4-stage cp.async ring, 16-byte shared-memory "
                 "reads by groups of threads, one online-softmax sweep over "
                 "K and V, groups combined in order, ranks combined by rank "
                 "0 through distributed shared memory; no atomics")

KERNEL_SOURCES = ("paged_decode", "flash_attention", "fused_rnn")
BF16_FLOPS_PER_S = 989e12       # dense tensor-core bf16 peak (data sheet)

# flash-attention cases: (name, BH, Sq, Sk, D, causal, sm_scale or None).
# "train" is the trainer's shape (B=8 x H=8, S=2048, D=64); "long" a long
# sequence, the JAX package's split-backward route; the rest ragged
# lengths (not multiples of the 64-row tile), Sq > Sk with fully masked
# rows, D = 32/128, no causal mask, sm_scale == 0, one query over two kv
# tiles (the second holding one key), and one row and one key past the
# 128-row tile of the bf16 forward's CTA at D = 128; then D = 256: the
# trainer's shape with two heads (the lm2h phase's, B=8 x H=2, S=2048),
# ragged lengths, and D = 160, which the wrapper pads to 256, ragged
# and causal; then above 256, on the column-split kernels: the trainer's
# shape at one head (the lm1h phase's, B=8 x H=1, S=2048, D = 512),
# D = 320 (padded to 384) ragged, and D = 512 with fully masked rows.
FLASH_CASES = (
    ("train", 64, 2048, 2048, 64, True, None),
    ("long", 8, 8192, 8192, 64, True, None),
    ("ragged", 6, 1000, 1500, 128, True, None),
    ("masked_rows", 4, 1500, 1000, 32, True, None),
    ("noncausal", 4, 777, 777, 64, False, None),
    ("zero_scale", 2, 300, 300, 64, True, 0.0),
    ("one_query", 3, 1, 65, 64, True, None),
    ("tile_edge", 5, 129, 129, 128, True, None),
    ("train_h2", 16, 2048, 2048, 256, True, None),
    ("ragged_d256", 3, 1000, 1500, 256, True, None),
    ("pad_d160", 4, 777, 900, 160, True, None),
    ("train_h1", 8, 2048, 2048, 512, True, None),
    ("ragged_d320", 3, 1000, 1500, 320, True, None),
    ("masked_d512", 2, 700, 500, 512, True, None),
)
FLASH_TIMED = ("train", "long", "train_h2", "pad_d160", "train_h1",
               "ragged_d320")
# the designs of the K2 and K3 rows of the kernels line
FLASH_DESIGN = {
    "fwd": "bf16: wgmma (S = Q.K^T from shared memory, P.V with P from "
           "registers), 2-stage cp.async K/V ring, CTA of 2 warpgroups x "
           "64 query rows, mask on edge tiles only, exp2f; fp32: SIMT",
    "bwd": "bf16: dk/dv + dq kernels, wgmma (S, dP from shared memory; "
           "dV, dK, dQ with P / dS from registers; p taken while dP "
           "computes), 2-stage cp.async ring, no atomics; fp32: SIMT"}
# the D = 256 instantiations' layouts (rows of their own in the kernels
# line): a thread holds at most 255 registers, and ptxas must report no
# spill
FLASH_D256_DESIGN = {
    "fwd": "bf16: as at D = 128, a CTA of 2 warpgroups x 64 query rows "
           "(O alone 128 registers a thread); fp32: SIMT, 64-row tiles",
    "bwd": "bf16: dk/dv 2 warpgroups x two 64-column slices of dK and "
           "dV, p and ds taken before dV and dK are issued; dq 2 "
           "warpgroups x 128 columns, each computing S and dP; fp32: "
           "SIMT, the kernels' own tiles 32 rows (shared memory)"}
# kernel vs plain: forward out (max abs), lse (fp32, max abs), backward
# (max abs relative to each gradient's max)
FLASH_TOL = {"fp32": {"out": 2e-5, "lse": 2e-5, "grad": 1e-4},
             "bf16": {"out": 2e-2, "lse": 2e-5, "grad": 5e-2}}
# bf16, element by element: the kernels against the tiled plain versions
# that round where the kernels round (ops.flash_attention.
# flash_forward_tiled / flash_backward_tiled, fp32 results). At most
# BF16_MISMATCH_TOL of the elements may differ from the plain value
# rounded once to bf16, and every element lies within BF16_ULP_TOL bf16
# ulps of it. The ulp is that of max(|value|, its largest term, its
# row's RMS, 2^-8 of the tensor's RMS) — the largest term of out[i, d]
# is max_j |p_ij v_jd|, of dq max_j |ds_ij k_jd|, of dk max_i |ds_ij
# q_id|, of dv max_i |p_ij do_id| (`_largest_terms`): a rounding error
# in a sum scales with its terms, not with the sum, so near-zero
# elements of a row that cancels, and rows that are zero in exact
# arithmetic (dq of a query that sees one key), are measured on a scale
# their fp32 noise cannot reach. A p or ds that the two fp32 sums round
# to neighbouring bf16 values moves an element by one ulp of that
# operand times its other factor: up to two ulps of the element's
# largest term, many more of a value its other terms cancel (and, on
# the row's scale alone, 4.04 in dk of pad_d160; the reading is
# reported as max_ulps_row). The control is the same plain versions
# without the roundings: wherever a rounding changes a value (every
# case but zero_scale) its mismatch share must exceed
# BF16_MISMATCH_TOL, or the check could not see a rounding left out.
BF16_ULP_TOL, BF16_MISMATCH_TOL = 4.0, 0.02
# fp32 gradients through both outputs of flash_attention_with_lse,
# kernels vs plain, relative to each gradient's max (FLASH_TOL "grad")
WITH_LSE_CASES = ("ragged", "masked_rows")

# above D = 256 (rows of their own in the kernels line): the output's
# columns split over CTAs, 128 a slice, each CTA computing the scores
# over the full D; every slice writes its lse row, held bitwise equal
FLASH_WIDE_DESIGN = {
    "fwd": "D padded to a multiple of 128, one CTA a 128-column slice of "
           "O (grid.z); S over the full D in 128-column chunks through a "
           "2-stage cp.async ring. bf16: one warpgroup x 64 rows on wgmma; "
           "fp32: SIMT, 64-row tiles",
    "bwd": "as the forward: one CTA a 128-column slice of dK and dV (or "
           "dQ), S and dP over the full D in chunks, its own slice's "
           "chunk last; bf16: wgmma, p and ds before dV and dK; fp32: "
           "SIMT, dQ 32-row tiles"}

# the trainer: the repository's 43M training benchmark configuration
# (bench.py bench_lm(512, 8, 8, 8, 2048, ..., "43m")) — batch 8 x 2048
# tokens, remat "attn_saved", Adam(3e-4), ChunkedSoftmaxCE, bf16 compute
TRAIN_CONFIG = dict(vocab_size=VOCAB, max_len=2048, dim=DIM,
                    num_heads=HEADS, num_layers=LAYERS, remat=True,
                    remat_policy="attn_saved")
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# fp32 full-model step, kernels vs plain: |loss diff| and the largest
# gradient difference relative to that gradient's max
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_GRAD_FLOOR = 1e-3

# the persistent-LSTM kernels (ops/csrc/fused_rnn.cu). Cases: (name, N, T,
# H, directions). "train_bi" is the BiLSTM trainer's shape (bench.py
# bench_bilstm: batch 128 x 128 tokens, hidden 128), "train_uni" one
# direction of it; "lm_uni" the LSTM LM trainer's shape (LM_BATCH x
# LM_SEQ, one direction: where the main path launches K6/K7); then a
# ragged batch (37 rows, not a tile multiple), T = 1 (init and emit in
# one step), the hidden-size cap H = 512, H = 200 (not a multiple of
# 128) and H = 100 (not a multiple of 8: the kernels' by-element copies).
# fp32 and bf16 each.
RNN_CASES = (
    ("train_bi", 128, 128, 128, 2),
    ("train_uni", 128, 128, 128, 1),
    ("lm_uni", 32, 64, 128, 1),
    ("ragged", 37, 50, 128, 2),
    ("t1", 16, 1, 64, 2),
    ("h512", 32, 16, 512, 2),
    ("h200", 24, 20, 200, 1),
    ("h100", 24, 20, 100, 2),
)
RNN_TIMED = ("train_bi", "train_uni", "lm_uni")
# kernel vs plain in fp32: forward max abs (ys, c, gates), gradients max
# abs relative to each gradient's max; bf16 element by element as the
# flash phase (BF16_ULP_TOL, BF16_MISMATCH_TOL), against the plain
# versions that round where the kernels round, with the unrounded
# control required to fail wherever a rounding changes a value (T > 1)
RNN_TOL = {"fwd": 2e-5, "grad": 1e-4}
# bf16 dW against the plain backward's dW (lstm_backward_reference from
# the kernel's residuals), max abs difference relative to its max. The
# element check holds dW to the plain product of the kernel's own dzx;
# this one holds the whole dW path to an independent backward. On an
# H100 the kernels read 1.4e-4 to 5.9e-4 over RNN_CASES, and the same
# check against the unrounded plain backward 1.25e-3 to 1.54e-3.
RNN_BF16_DW_TOL = 1e-3

# the BiLSTM trainer: BASELINE config 4 at bench.py's shape
# (bench_bilstm, called with batch 128 x seq 128 on the chip): vocab
# 20000, embed 128, hidden 128, Adam(1e-3), ClassNLLCriterion, bf16
# compute with fp32 masters
RNN_VOCAB, RNN_EMBED, RNN_HIDDEN = 20000, 128, 128
RNN_BATCH, RNN_SEQ = 128, 128
RNN_INFER_BATCHES = 4
SENTIMENT_TOKENS = 64           # token ids per class in the trainer's data
# the LSTM language model (the PTB vocabulary), 2 layers, batch 32 x 64
LM_VOCAB, LM_LAYERS, LM_BATCH, LM_SEQ = 10000, 2, 32, 64
LM_WARMUP, LM_STEPS = 2, 4

# the persistent-GRU kernels (ops/csrc/fused_rnn.cu), one direction a
# launch. Cases: (name, N, T, H). "train" is the BiGRU trainer's shape
# (batch 128 x 128 tokens, hidden 128: each direction of
# BiRecurrent(GRU)); then T = 1 (init and emit in one step), a ragged
# batch (37 rows, not a tile multiple), H = 100 (not a multiple of 32)
# and the hidden-size cap H = 512. fp32 and bf16 each, held as the LSTM
# kernels are (RNN_TOL, BF16_ULP_TOL, BF16_MISMATCH_TOL,
# RNN_BF16_DW_TOL).
GRU_CASES = (
    ("train", 128, 128, 128),
    ("t1", 16, 1, 64),
    ("ragged", 37, 50, 128),
    ("h100", 24, 20, 100),
    ("h512", 32, 16, 512),
)
GRU_TIMED = ("train",)
# the design of the K11 row of the kernels line
GRU_BWD_DESIGN = ("sweep: bf16 step products on mma.sync m16n8k16 (M = "
                  "units, N = 4 rows + 4 zero rows, A = W as stored, in "
                  "registers at H <= 128, streamed from L2 above), each "
                  "thread owning its (row, unit) pairs' carries, residuals "
                  "prefetched two steps ahead with cp.async, 2 barriers a "
                  "step; fp32 SIMT products. dW: one GEMM over all (t, row) "
                  "pairs after the sweep (bf16 mma.sync with ldmatrix, fp32 "
                  "SIMT), split over a cluster, reduced in rank order "
                  "through distributed shared memory; no atomics")
# the designs of the K7/K9 and K10 rows of the kernels line
LSTM_BWD_DESIGN = ("sweep: bf16 step product dh^T = W . dz^T on mma.sync "
                   "m16n8k16 (M = units, N = 4 rows + 4 zero rows, K = 4H, "
                   "A = W as stored, in registers at H <= 128, streamed "
                   "from L2 above), each thread owning its (row, unit) "
                   "pairs' dc carry and gate-derivative chain, dz double-"
                   "buffered (one barrier a step), residuals prefetched two "
                   "steps ahead with cp.async, dzx out in 16-byte pieces; "
                   "fp32 SIMT products. dW: one GEMM over all (t, row) "
                   "pairs of each direction after the sweep (rnn_dw_kernel, "
                   "shared with K11), split over a cluster, reduced in rank "
                   "order through distributed shared memory; no atomics")
LSTM_FWD_DESIGN = ("bf16: step product z^T = W^T . h^T on mma.sync m16n8k16 "
                   "(M = 4H gate columns, a warp's 4 M tiles the 4 gates of "
                   "its 16 units, N = 4 rows + 4 zero rows, W in registers "
                   "at H <= 128 from a shared-memory copy by "
                   "ldmatrix.trans, streamed from L2 above), the gate math "
                   "as its epilogue with the c carry in registers (the zero "
                   "rows' lanes take over half the entries), h double-"
                   "buffered (one barrier a step), zx prefetched two steps "
                   "ahead with cp.async, ys/c/gates out in 16-byte pieces; "
                   "fp32: SIMT over a 4-CTA cluster a tile (units split, "
                   "each CTA's columns of W in shared memory), K in 4 parts "
                   "summed across lanes in a fixed order, h sent to every "
                   "CTA by st.async and awaited on an mbarrier")
GRU_FWD_DESIGN = ("bf16: both step products on mma.sync m16n8k16 with W_g "
                  "and W_c in registers at H <= 128 (streamed from L2 "
                  "above), W_g's columns ordered so a lane holds z and r of "
                  "its units, r h and the h update register-local (h carry "
                  "fp32 per owned (row, unit) pair), zg/zc prefetched two "
                  "steps ahead with cp.async, ys/zr/cand out in 16-byte "
                  "pieces, 2 barriers a step; fp32: SIMT products, zg/zc "
                  "prefetched")
# kernels the build phase must find in the fused_rnn report (none may
# spill), and those of them that must have tensor-core instructions
RNN_BUILT_KERNELS = (
    "lstm_fwd_mma_kernel<1,true>", "lstm_fwd_mma_kernel<1,false>",
    "lstm_fwd_mma_kernel<4,true>", "lstm_fwd_mma_kernel<4,false>",
    "lstm_fwd_simt_kernel<true,true>", "lstm_fwd_simt_kernel<true,false>",
    "lstm_fwd_simt_kernel<false,true>", "lstm_fwd_simt_kernel<false,false>",
    "lstm_bwd_mma_kernel<1>", "lstm_bwd_mma_kernel<4>",
    "lstm_bwd_simt_kernel<float>",
    "gru_fwd_mma_kernel<1,true>", "gru_fwd_mma_kernel<1,false>",
    "gru_fwd_mma_kernel<4,true>", "gru_fwd_mma_kernel<4,false>",
    "gru_fwd_simt_kernel<float,true>", "gru_fwd_simt_kernel<float,false>",
    "gru_bwd_mma_kernel<1>", "gru_bwd_mma_kernel<4>",
    "gru_bwd_simt_kernel<float>", "rnn_dw_kernel<bf16>",
    "rnn_dw_kernel<float>")
RNN_TENSOR_CORE_KERNELS = ("lstm_fwd_mma_kernel", "lstm_bwd_mma_kernel",
                           "gru_fwd_mma_kernel",
                           "gru_bwd_mma_kernel", "rnn_dw_kernel<bf16")
# The GRU's bf16 outputs are also held to the free-running plain
# versions, which carry their own state: there a one-ulp difference in a
# stored value feeds the next step, so the order of a product's sums
# alone moves the readings, most over the H = 512 reversed sweep. On an
# H100 (700 W) the kernels read at most 3.9% of the elements mismatched
# there (dzg) and the unrounded control at least 14.5% (ys); the limit
# lies between, and the control must fail it too. The same outputs
# against an fp64 rendering of the plain versions (the same roundings,
# products summed in fp64) are held to this limit as well, and the fp32
# plain versions' own distance from it is reported beside the kernel's.
GRU_BF16_FREE_MISMATCH_TOL = 0.08
# the BiGRU trainer (the BiLSTM trainer's configuration with a GRU cell)
# validates every GRU_VALID_EVERY steps over GRU_VALID_BATCHES batches
GRU_VALID_EVERY, GRU_VALID_BATCHES = 6, 2

# cuda_ms's device-side spin before each timed call, in clock cycles
# (~0.3 ms at the H100's clocks): longer than a wrapper's host work
HOST_COVER_CYCLES = 500_000

RESULTS: dict = {}
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """Record and print a phase's result line; `at_s` is the script's
    seconds when the phase ended (a phase's seconds: the difference to
    the line before)."""
    fields["at_s"] = time.perf_counter() - _T0
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around it, with
    the 50 MB L2 flushed (a 256 MB write) before every call — between
    two launches of one layer the engine streams the other layers'
    pools and weights, so the real caller finds L2 cold. A device-side
    spin (HOST_COVER_CYCLES) follows the flush, so that the call's host
    work (argument checks, allocation, the launch) is done before the
    start event fires and only device time lies between the events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phases
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f")


def _kernel_label(mangled: str) -> str:
    """`fa_fwd_bf16_kernel<64>`, `rnn_dw_kernel<bf16>`,
    `paged_decode_kernel<float,64>`, `fa_fwd_wide_kernel` from a
    kernel's mangled name (other names pass through)."""
    m = re.search(r"\d+((?:fa|gru|lstm|paged|rnn)_\w*?kernel)(I\w+|E)",
                  mangled)
    if not m:
        return mangled
    if m.group(2) == "E":                    # not a template
        return m.group(1)
    args, rest = [], m.group(2)[1:]
    while rest and rest[0] != "E":
        t = _TEMPLATE_ARG.match(rest)
        if not t:
            return mangled
        args.append(t.group(1) or {"1": "true", "0": "false"}.get(
            t.group(2)) or ("bf16" if t.group(0) != "f" else "float"))
        rest = rest[t.end():]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each kernel in
    an `nvcc -Xptxas -v` log. ptxas reports the out-of-line device
    functions a kernel calls after the kernel itself, before the next
    "Compiling entry function" line; their spills are added to the
    kernel's, so a spill in a callee fails the kernel's gate."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_label(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_bytes"] = (out[name].get("spill_bytes", 0) +
                                        int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _tensor_core_counts(so: Path) -> dict:
    """Tensor-core instructions of each kernel in a built library, from
    its SASS (`cuobjdump -sass`): HGMMA is wgmma, HMMA mma.sync."""
    from bigdl_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = _kernel_label(m.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name and "HGMMA" in ln:
            out[name]["HGMMA"] += 1
        elif name and "HMMA" in ln:
            out[name]["HMMA"] += 1
    return out


def phase_build():
    """Build every kernel source; report ptxas registers and spills, and
    for the flash, paged-decode, LSTM and GRU kernels their tensor-core
    instructions. Fails if one of those kernels spills, or a bf16 flash
    kernel, bf16 LSTM or GRU sweep (backward, and the GRU forward) or bf16
    dW kernel has no tensor-core instruction."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import paged_decode as pd
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)             # one nvcc per source, together
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOG.get(
        name, "").splitlines() if "registers" in ln or "spill" in ln]
        for name in KERNEL_SOURCES}
    regs = _ptxas_report(_build.BUILD_LOG["flash_attention"])
    flash = {name: {**regs.get(name, {}), **tc} for name, tc in
             _tensor_core_counts(_build.library_path("flash_attention"))
             .items() if name.startswith("fa_")}
    for kind in ("fwd", "dkdv", "dq"):
        for dtype in ("", "_bf16"):
            for d in fa.HEAD_DIMS:
                label = f"fa_{kind}{dtype}_kernel<{d}"
                check(any(n.startswith(label) for n in flash),
                      f"no {label}...> in the library's SASS")
            label = f"fa_{kind}{dtype}_wide_kernel"   # D > 256
            check(label in flash, f"no {label} in the library's SASS")
    for name, r in flash.items():
        check(r.get("spill_bytes") == 0,
              f"{name} spills ({r.get('spill_bytes')} bytes) or has no "
              f"ptxas report")
        if "bf16" in name:
            check(r["HGMMA"] + r["HMMA"] > 0,
                  f"{name} has no tensor-core instruction")
    # the paged-decode and recurrent kernels: no spills; the bf16 LSTM
    # backward and GRU sweeps and the bf16 dW GEMM on the tensor cores
    others = {}
    for src, prefix in (("paged_decode", ("paged_decode_",)),
                        ("fused_rnn", ("gru_", "lstm_", "rnn_"))):
        tc = _tensor_core_counts(_build.library_path(src))
        others.update({name: {**r, **tc.get(name, {})} for name, r in
                       _ptxas_report(_build.BUILD_LOG[src]).items()
                       if name.startswith(prefix)})
    for name in (*(f"paged_decode_kernel<{t},{d}>" for t in ("float", "bf16")
                   for d in pd.HEAD_DIMS),
                 "paged_decode_wide_kernel<float>",
                 "paged_decode_wide_kernel<bf16>", *RNN_BUILT_KERNELS):
        check(name in others, f"no {name} in the ptxas report")
    for name, r in others.items():
        check(r.get("spill_bytes") == 0,
              f"{name} spills ({r.get('spill_bytes')} bytes) or has no "
              f"ptxas report")
        if name.startswith(RNN_TENSOR_CORE_KERNELS):
            check(r.get("HGMMA", 0) + r.get("HMMA", 0) > 0,
                  f"{name} has no tensor-core instruction")
    RESULTS["build_log"] = _build.BUILD_LOG
    emit("build", seconds=seconds, kernels=list(KERNEL_SOURCES),
         ptxas={name: lines[:8] for name, lines in ptxas.items()},
         flash_kernels=flash, decode_and_gru_kernels=others)


def _decode_case(pool_dtype, dev, B=SLOTS, H=HEADS, nb=MAX_LEN // BLOCK,
                 bs=BLOCK, D=DIM // HEADS, clocks=None, seed=0):
    """Paged-decode inputs on the card: every row's table a shuffled
    chain of pool blocks, entries past the row's clock pointing at the
    NaN scratch block 0, and NaN in the rows past each clock inside its
    last page (a poisoned former occupant); `clocks`, or ragged clocks
    with 0 and S - 1 among them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = B * nb + 1
    k = torch.randn(n, H, bs, D, generator=g)
    v = torch.randn(n, H, bs, D, generator=g)
    k[0] = float("nan")
    v[0] = float("nan")
    table = (torch.randperm(n - 1, generator=g)[:B * nb] + 1).reshape(B, nb)
    seq = nb * bs
    if clocks is None:
        pos = torch.randint(0, seq, (B,), generator=g)
        pos[0], pos[1] = 0, seq - 1
    else:
        pos = torch.tensor(clocks)
    for r in range(B):
        last, off = int(pos[r]) // bs, int(pos[r]) % bs
        k[table[r, last], :, off + 1:] = float("nan")
        v[table[r, last], :, off + 1:] = float("nan")
        table[r, last + 1:] = 0
    q = torch.randn(B, H, 1, D, generator=g)
    return (q.to(dev), k.to(dev, pool_dtype), v.to(dev, pool_dtype),
            table.to(dev, torch.int32), pos.to(dev, torch.int32))


def _bound(q, k, table, pos):
    """Least time for the work these inputs need: q, table, clocks and
    the output once, and the K and V rows j <= pos once; 4 flops per
    K/V element read plus one exp per score."""
    b, h, _, d = q.shape
    seq = table.shape[1] * k.shape[2]
    keys = int((pos.clamp(max=seq - 1) + 1).sum())
    nbytes = (2 * q.numel() * 4 + table.numel() * 4 + pos.numel() * 4
              + 2 * keys * h * d * k.element_size())
    flops = keys * h * (4 * d + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    full = (2 * q.numel() * 4 + table.numel() * 4 + pos.numel() * 4
            + 2 * b * seq * h * d * k.element_size())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "full_extent_bytes": full,
            "full_extent_bound_us": full / HBM_BYTES_PER_S * 1e6}


def phase_kernel(flush):
    """The paged-decode kernel against its plain version on DECODE_CASES,
    fp32 and bf16 pools: finite, max abs err <= KERNEL_TOL, each row of a
    launch bitwise the same row launched alone; kernel, plain and SDPA
    (library yardstick) times at the DECODE_TIMED shapes (the engine's
    shape keyed by dtype, the others by case/dtype)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops.kv_cache import gather_block_cache
    from bigdl_tpu_torch.ops.paged_decode import (kernel_head_dim,
                                                  paged_decode_attention,
                                                  split_plan, vector_rows)

    out, cases = {}, {}
    for case, B, H, nb, bs, D, clocks in DECODE_CASES:
        for name, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            where = f"paged_decode {case} {name}"
            q, k, v, table, pos = _decode_case(dtype, flush.device, B=B,
                                               H=H, nb=nb, bs=bs, D=D,
                                               clocks=clocks)
            got = paged_decode_attention(q, k, v, table, pos, impl="cuda")
            ref = paged_decode_attention(q, k, v, table, pos, impl="torch")
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{where}: kernel output not finite")
            err = float((got - ref).abs().max())
            check(err <= KERNEL_TOL, f"{where}: max abs err {err} > "
                  f"{KERNEL_TOL}")
            for r in range(q.shape[0]):
                alone = paged_decode_attention(
                    q[r:r + 1], k, v, table[r:r + 1].contiguous(),
                    pos[r:r + 1].contiguous(), impl="cuda")
                check(torch.equal(alone, got[r:r + 1]),
                      f"{where}: row {r} alone differs from the B={B} "
                      "launch")
            cases[f"{case}/{name}"] = {
                "B": B, "H": H, "nb": nb, "bs": bs, "D": D,
                "split_plan": split_plan(nb, bs), "max_abs_err": err,
                "tier": kernel_head_dim(D),
                "vector_rows": vector_rows(D, k.element_size(), k, v),
                "row_alone_bitwise": True,
                "clocks": [int(x) for x in pos.tolist()]}
            if case not in DECODE_TIMED:
                continue
            kc = gather_block_cache(k, table).float()
            vc = gather_block_cache(v, table).float()
            seq = kc.shape[-2]
            mask = (torch.arange(seq, device=q.device)[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            res = {
                "max_abs_err": err, "row_alone_bitwise": True,
                "kernel_ms": cuda_ms(lambda: paged_decode_attention(
                    q, k, v, table, pos, impl="cuda"), flush),
                "torch_ms": cuda_ms(lambda: paged_decode_attention(
                    q, k, v, table, pos, impl="torch"), flush),
                # yardstick only, never called by the port: SDPA over the
                # cache gathered beforehand (the gather is not timed)
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask), flush),
                "clocks": [int(x) for x in pos.tolist()],
            }
            res.update(_bound(q, k, table, pos))
            res["bound_us"] = res["bound_ms"] * 1e3
            out[name if case == "engine" else f"{case}/{name}"] = res
    emit("kernel", shape={"B": SLOTS, "H": HEADS, "nb": MAX_LEN // BLOCK,
                          "bs": BLOCK, "D": DIM // HEADS},
         tolerance=KERNEL_TOL, cases=cases, **out)
    return out


def _visible_pairs(seq_q: int, seq_k: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves visible, per batch-head."""
    if not causal:
        return seq_q * seq_k
    off = seq_k - seq_q
    return sum(min(max(i + off + 1, 0), seq_k) for i in range(seq_q))


def _flash_bound(bh, seq_q, seq_k, d, causal, itemsize, backward):
    """Least time for the work: each input read once, each output
    written once; the products over the visible pairs only (2 flops a
    multiply-add: QK and PV forward; QK, dO.V, P^T.dO, dS^T.Q and dS.K
    backward) at the fp32 SIMT peak, or the dense bf16 tensor-core peak
    for bf16."""
    rows_q, rows_k = bh * seq_q * d, bh * seq_k * d
    if backward:   # q, k, v, o, do, lse in; dq, dk, dv out
        nbytes = (3 * rows_q + 2 * rows_k) * itemsize + bh * seq_q * 4 \
            + (rows_q + 2 * rows_k) * itemsize
        flops = 10 * d * bh * _visible_pairs(seq_q, seq_k, causal)
    else:          # q, k, v in; out, lse out
        nbytes = (2 * rows_q + 2 * rows_k) * itemsize + bh * seq_q * 4
        flops = 4 * d * bh * _visible_pairs(seq_q, seq_k, causal)
    peak = FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _rel_err(got, ref) -> float:
    scale = float(ref.float().abs().max())
    return float((got.float() - ref.float()).abs().max()) / max(scale,
                                                                 1e-30)


def _ulp_stats(got, ref, term=None) -> dict:
    """got (bf16) against ref (fp32): the largest error in bf16 ulps of
    max(|ref|, the RMS of ref's row, 2^-8 of ref's RMS), and the share
    of elements unequal to ref rounded to bf16. With `term` (each
    element's largest term) the ulp is that of max(that scale, term),
    and the reading on the scale without it is `max_ulps_row`."""
    import torch

    def max_ulps(mag):
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        return float(((got.float() - r).abs() / ulp).max())

    r = ref.float()
    mag = torch.maximum(r.abs(), r.pow(2).mean(-1, keepdim=True).sqrt())
    mag = torch.maximum(mag, 2.0 ** -8 * r.pow(2).mean().sqrt())
    out = {"max_ulps": max_ulps(mag),
           "mismatch": float((got != r.to(got.dtype)).float().mean())}
    if term is not None:
        out["max_ulps_row"] = out["max_ulps"]
        out["max_ulps"] = max_ulps(torch.maximum(mag, term))
    return out


def _max_product(a, b, budget=2 ** 27):
    """max_k |a[n, i, k]| |b[n, k, d]| for a (N, I, K), b (N, K, D): a
    matrix product with max in place of the sum, over chunks of rows
    of at most `budget` elements."""
    import torch

    a, b = a.abs(), b.abs()
    n, rows, kk = a.shape
    step = max(1, budget // (n * kk * b.shape[-1]))
    return torch.cat([(a[:, i:i + step, :, None] * b[:, None]).amax(2)
                      for i in range(0, rows, step)], 1)


def _largest_terms(fa, q, k, v, o, lse, do, causal, scale):
    """Each element's largest term, fp32, for out, dq, dk and dv, with
    p and ds formed as `flash_backward_tiled` forms them (before their
    bf16 rounding, which moves no term by more than its own ulp), over
    tiles of KERNEL_BLOCK_K keys."""
    import torch

    seq_q, seq_k = q.shape[1], k.shape[1]
    q32, do32 = q.float(), do.float()
    delta = ((do32 * o.float()).sum(-1) * scale)[..., None]
    out_t, dq_t = torch.zeros_like(q32), torch.zeros_like(q32)
    dk_t = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv_t = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for j0 in range(0, seq_k, fa.KERNEL_BLOCK_K):
        kb = k[:, j0:j0 + fa.KERNEL_BLOCK_K].float()
        vb = v[:, j0:j0 + fa.KERNEL_BLOCK_K].float()
        p = torch.exp(torch.matmul(q32, kb.transpose(1, 2)) * scale
                      - lse[..., None])
        if causal:
            p = torch.where(fa._visible(j0, kb.shape[1], seq_q, seq_k,
                                        q.device), p, 0.0)
        ds = p * (torch.matmul(do32 * scale, vb.transpose(1, 2)) - delta)
        out_t = torch.maximum(out_t, _max_product(p, vb))
        dq_t = torch.maximum(dq_t, _max_product(ds, kb))
        dk_t[:, j0:j0 + fa.KERNEL_BLOCK_K] = _max_product(
            ds.transpose(1, 2), q32)
        dv_t[:, j0:j0 + fa.KERNEL_BLOCK_K] = _max_product(
            p.transpose(1, 2), do32)
    return out_t, dq_t, dk_t, dv_t


def _bf16_rounding(fa, where, q, k, v, o, lse, do, grads, causal, scale,
                   gate_control: bool) -> dict:
    """The bf16 kernels' out and dq/dk/dv against the tiled plain
    versions with the kernels' roundings ("matched") and without them
    ("control"), on the same inputs (the backward's o and lse are the
    kernel's), each element on the scale of its largest term too."""
    res = {}
    terms = _largest_terms(fa, q, k, v, o, lse, do, causal, scale)
    for label, rounded in (("matched", True), ("control", False)):
        fo, _ = fa.flash_forward_tiled(q, k, v, causal, scale,
                                       round_operands=rounded)
        fg = fa.flash_backward_tiled(q, k, v, o, lse, do, causal, scale,
                                     round_operands=rounded)
        res[label] = {n: _ulp_stats(a, b, t) for n, a, b, t in zip(
            ("out", "dq", "dk", "dv"), (o, *grads), (fo, *fg), terms)}
    for n, st in res["matched"].items():
        check(st["max_ulps"] <= BF16_ULP_TOL,
              f"{where}: {n} {st['max_ulps']} bf16 ulps from the plain "
              f"version with the kernel's roundings")
        check(st["mismatch"] <= BF16_MISMATCH_TOL,
              f"{where}: {n} differs from the plain version with the "
              f"kernel's roundings in a share {st['mismatch']}")
    if gate_control:
        for names in (("out",), ("dq", "dk", "dv")):
            worst = max(res["control"][n]["mismatch"] for n in names)
            check(worst > BF16_MISMATCH_TOL,
                  f"{where}: the control without the kernel's roundings "
                  f"passes the mismatch limit ({names}: {worst})")
    return res


def _with_lse_grads(fa, q, k, v, causal, scale) -> dict:
    """Gradients of a loss on both outputs of flash_attention_with_lse,
    kernels ("cuda") against the plain path ("torch"), relative to each
    gradient's max; fully masked rows (LSE -1e30) stay out of the
    loss."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(11)
    wo = torch.randn(q.shape, device="cuda", generator=g)
    wl = torch.randn(q.shape[:2], device="cuda", generator=g)
    out = {}
    for impl in ("cuda", "torch"):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o, lse = fa.flash_attention_with_lse(*leaves, causal=causal,
                                             sm_scale=scale, impl=impl)
        live = torch.where(lse > fa.NEG_INF / 2, lse, 0.0)
        loss = (o.float() * wo).sum() + (live * wl).sum()
        out[impl] = torch.autograd.grad(loss, leaves)
    return {n: _rel_err(a, b) for n, a, b in zip(
        ("dq", "dk", "dv"), out["cuda"], out["torch"])}


def phase_flash(flush):
    """The flash-attention kernels against their plain versions on every
    case of FLASH_CASES, fp32 and bf16; in bf16 also element by element
    against the plain versions that round where the kernels round, with
    the unrounded control; two backward runs bitwise equal; fully
    masked rows exactly zero with LSE -1e30; gradients through
    flash_attention_with_lse on WITH_LSE_CASES; times of the cases in
    FLASH_TIMED (kernel, plain version, and SDPA as the library
    yardstick: its forward, and its backward alone through
    `torch.autograd.grad` on a saved graph)."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    out = {}
    for name, bh, sq, sk, d, causal, scale in FLASH_CASES:
        scale = 1.0 / math.sqrt(d) if scale is None else scale
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
            q, do = (torch.randn(bh, sq, d, device="cuda", generator=g,
                                 dtype=dtype) for _ in range(2))
            k, v = (torch.randn(bh, sk, d, device="cuda", generator=g,
                                dtype=dtype) for _ in range(2))
            o, lse, slices = fa.flash_fwd_cuda(q, k, v, causal, scale,
                                               return_lse_slices=True)
            ro, rlse = fa.attention_reference(q, k, v, causal, scale,
                                              return_lse=True)
            grads = fa.flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
            again = fa.flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
            refs = fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal, scale)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            res = {
                "out_max_abs_err": float((o.float() - ro.float()).abs()
                                         .max()),
                "lse_max_abs_err": float((lse - rlse).abs().max()),
                "grad_rel_err": {n: _rel_err(a, b) for n, a, b in zip(
                    ("dq", "dk", "dv"), grads, refs)},
                "grad_max_abs_err": max(float((a.float() - b.float())
                                              .abs().max())
                                        for a, b in zip(grads, refs)),
            }
            where = f"flash {name} {dname}"
            check(all(bool(torch.isfinite(t).all())
                      for t in (o, lse, *grads)), f"{where}: not finite")
            check(res["out_max_abs_err"] <= tol["out"],
                  f"{where}: out err {res['out_max_abs_err']}")
            if "lse" in tol:
                check(res["lse_max_abs_err"] <= tol["lse"],
                      f"{where}: lse err {res['lse_max_abs_err']}")
            for n, e in res["grad_rel_err"].items():
                check(e <= tol["grad"], f"{where}: {n} rel err {e}")
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"{where}: two backward runs differ")
            masked = max(sq - sk, 0) if causal else 0
            if masked:
                check(bool((o[:, :masked] == 0).all())
                      and bool((lse[:, :masked] == fa.NEG_INF).all())
                      and bool((grads[0][:, :masked] == 0).all()),
                      f"{where}: fully masked rows not zero / -1e30")
            res["fully_masked_rows"] = masked
            # above D = 256 every column slice computes the same scores
            # in the same order: its lse row must be the first's bits
            res["lse_slices"] = slices.shape[0]
            check(all(torch.equal(t, lse) for t in slices),
                  f"{where}: the column slices' lse rows differ")
            if dname == "bf16":
                res["rounding"] = _bf16_rounding(
                    fa, where, q, k, v, o, lse, do, grads, causal, scale,
                    gate_control=name != "zero_scale")
            elif name in WITH_LSE_CASES:
                res["with_lse_grad_rel_err"] = _with_lse_grads(
                    fa, q, k, v, causal, scale)
                for n, e in res["with_lse_grad_rel_err"].items():
                    check(e <= tol["grad"],
                          f"{where}: with_lse {n} rel err {e}")
            if name in FLASH_TIMED:
                res.update(_flash_times(fa, F, flush, q, k, v, o, lse, do,
                                        causal, scale))
                res["fwd"] = _flash_bound(bh, sq, sk, d, causal,
                                          q.element_size(), False)
                res["bwd"] = _flash_bound(bh, sq, sk, d, causal,
                                          q.element_size(), True)
            out[f"{name}/{dname}"] = res
            del q, k, v, do, o, lse, slices, ro, rlse, grads, again, refs
    torch.cuda.empty_cache()
    summary = {key: {k: r[k] for k in (
        "out_max_abs_err", "lse_max_abs_err", "lse_slices", "grad_rel_err",
        "with_lse_grad_rel_err", "fwd_ms", "bwd_ms", "plain_fwd_ms",
        "plain_bwd_ms", "sdpa_fwd_ms", "sdpa_bwd_ms") if k in r}
        for key, r in out.items()}
    for key, r in out.items():
        if "rounding" in r:      # the worst tensor of each reading
            summary[key]["rounding"] = {
                label: {st: max(x[st] for x in r["rounding"][label]
                                .values())
                        for st in ("max_ulps", "max_ulps_row", "mismatch")}
                for label in ("matched", "control")}
    emit("flash", cases={c[0]: dict(zip(("BH", "Sq", "Sk", "D", "causal"),
                                        c[1:6])) for c in FLASH_CASES},
         tolerance=FLASH_TOL, bitwise_backward=True,
         lse_slices_bitwise=True,
         bf16_rounding_tolerance={"max_ulps": BF16_ULP_TOL,
                                  "mismatch": BF16_MISMATCH_TOL},
         summary=summary)
    RESULTS["flash_detail"] = out
    return out


def _flash_times(fa, F, flush, q, k, v, o, lse, do, causal, scale):
    import torch

    bh, sq, d = q.shape
    heads = 8 if bh % 8 == 0 else 1
    q4, k4, v4 = (t.reshape(bh // heads, heads, t.shape[1], d).detach()
                  .requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                        scale=scale)
    do4 = do.reshape(q4.shape)
    reps = dict(reps=10, warmup=2)
    return {
        "fwd_ms": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale),
                          flush, **reps),
        "bwd_ms": cuda_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, o, lse, do, causal, scale), flush, **reps),
        "plain_fwd_ms": cuda_ms(lambda: fa.attention_reference(
            q, k, v, causal, scale, return_lse=True), flush, **reps),
        "plain_bwd_ms": cuda_ms(
            lambda: fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal, scale), flush, **reps),
        # yardstick only, never called by the port
        "sdpa_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), flush, **reps),
        "sdpa_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
            so, (q4, k4, v4), do4, retain_graph=True), flush, **reps),
    }


def _model():
    import torch

    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    cfg = TransformerConfig(vocab_size=VOCAB, max_len=MAX_LEN, dim=DIM,
                            num_heads=HEADS, num_layers=LAYERS)
    model = TransformerLM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    return model, params


def phase_model(model, params):
    import torch

    from bigdl_tpu_torch.ops import paged_decode

    sp = model.serving_params(params)
    nb = MAX_LEN // BLOCK
    pools = model.init_block_pool(SLOTS * nb + 1, BLOCK)
    dev = model.device
    table = (1 + torch.arange(SLOTS * nb, dtype=torch.int32)).reshape(
        SLOTS, nb).to(dev)
    g = torch.Generator().manual_seed(1)
    lens = [512, 253, 495, 170, 100, 300, 20, 400]
    for r, n in enumerate(lens):
        bucket = 256 if n <= 256 else 512
        toks = torch.zeros(1, bucket, dtype=torch.int32)
        toks[0, :n] = torch.randint(1, VOCAB, (n,), generator=g)
        model.prefill_paged(sp, toks.to(dev), pools, table[r:r + 1],
                            table[r, :bucket // BLOCK], 0)
    clone = [{k: t.clone() for k, t in layer.items()} for layer in pools]
    tok = torch.randint(1, VOCAB, (SLOTS,), generator=g).int().to(dev)
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                       device=dev)
    diffs = []
    launches0 = paged_decode.launches
    for _ in range(8):
        lc, _ = model.decode_step_paged(sp, tok, pos, pools, table,
                                        attn_impl="cuda")
        lt, _ = model.decode_step_paged(sp, tok, pos, clone, table,
                                        attn_impl="torch")
        check(bool(torch.isfinite(lc).all()), "model logits not finite")
        diffs.append(float((lc - lt).abs().max()))
        tok = lt.argmax(-1).int()
        pos = pos + 1
    torch.cuda.synchronize()
    check(max(diffs) <= LOGIT_TOL,
          f"decode logits differ by {max(diffs)} > {LOGIT_TOL}")
    check(paged_decode.launches - launches0 == 8 * LAYERS,
          "decode_step_paged(attn_impl='cuda') did not launch the "
          "kernel once per layer")
    emit("model", steps=8, logits_max_abs_diff=max(diffs),
         per_step=diffs, tolerance=LOGIT_TOL,
         params=int(sum(t.numel() for t in _leaves(params))))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _wave(seed: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = (list(PROMPT_LENS) * (2 * SLOTS))[:2 * SLOTS]
    return [dict(prompt=[int(t) for t in rng.randint(1, VOCAB, n)],
                 max_new_tokens=NEW_TOKENS, seed=seed + i)
            for i, n in enumerate(lens)]


def _timed_run(eng, reqs):
    """(results, seconds, decode steps, K1 launches) of one wave; the
    launch count is set to 0 just before and read just after."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import Request

    torch.cuda.synchronize()
    steps0 = eng.stats["decode_steps"]
    paged_decode.launches = 0
    t0 = time.perf_counter()
    res = eng.run([Request(**r) for r in reqs])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = paged_decode.launches
    return res, dt, eng.stats["decode_steps"] - steps0, launches


def _check_launches(where, launches, steps):
    check(launches > 0 and launches == steps * LAYERS,
          f"{where}: kernel launches {launches} != decode steps {steps} "
          f"x {LAYERS} layers")


def phase_engine(model, params):
    from bigdl_tpu_torch.serving import InferenceEngine, Request

    knobs = ENGINE_KNOBS
    eng = InferenceEngine(model, params, **knobs)
    check(eng.attn_impl == "cuda", "engine default attn_impl is not cuda")
    eng.run([Request(**r) for r in _wave(0)])              # warm-up
    timed = _wave(100)
    hits0 = eng.stats["prefix_hits"]
    res, dt, steps, launches = _timed_run(eng, timed)     # the main path
    _check_launches("engine", launches, steps)
    for r in res:
        check(r.status == "done" and len(r.tokens) == NEW_TOKENS
              and r.finish_reason == "max_tokens",
              f"request {r.id}: {r.status}/{r.finish_reason}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < VOCAB for t in r.tokens),
              f"request {r.id}: token out of range")
    n_tok = sum(len(r.tokens) for r in res)

    plain = InferenceEngine(model, params, attn_impl="torch", **knobs)
    ref = plain.run([Request(**r) for r in timed])
    same = sum(a.tokens == b.tokens for a, b in zip(res, ref))
    agree = []
    for a, b in zip(res, ref):
        k = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), len(a.tokens))
        agree.append(k / len(a.tokens))

    # warm == cold on the card: the same prompt cold, then through a
    # prefix-cache hit beside a stranger
    wc = InferenceEngine(model, params, **knobs)
    a = _wave(7)[1]
    a["prompt"] = a["prompt"][:200] + _wave(8)[0]["prompt"][:100]
    cold = wc.run([Request(**a)])[0]
    warm, _ = wc.run([Request(**a), Request(**_wave(9)[3])])
    check(wc.stats["prefix_hits"] == 1, "warm admission missed the cache")
    emit("engine", requests=len(res), new_tokens=n_tok, seconds=dt,
         tokens_per_sec=n_tok / dt, decode_steps=steps,
         step_ms=dt / steps * 1e3, kernel_launches=launches,
         layers=LAYERS, prefix_hits=eng.stats["prefix_hits"] - hits0,
         prefill_calls=eng.stats["prefill_calls"],
         torch_engine_same_requests=f"{same}/{len(res)}",
         torch_engine_agreed_prefix_mean=sum(agree) / len(agree),
         warm_equals_cold=(warm.tokens == cold.tokens),
         warm_cold_agreed_prefix=next(
             (i for i, (x, y) in enumerate(zip(warm.tokens, cold.tokens))
              if x != y), len(cold.tokens)))
    return launches, [r.tokens for r in res]


def phase_profile(model, params):
    """Where a steady decode step's time goes (`--profile` only): 32
    steps with all 8 slots decoding (no admissions), once timed on the
    host clock, once under torch.profiler for the device kernel time by
    kernel. The busy share is device kernel time over the unprofiled
    wall time of the same kind of window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serving import InferenceEngine, Request

    eng = InferenceEngine(model, params, **ENGINE_KNOBS)
    eng.run([Request(**r) for r in _wave(0)])              # warm-up
    steps = 32

    def window(seed, prof=None):
        for r in _wave(seed):
            eng.submit(Request(**r))
        for _ in range(4):              # the 8 admissions land in step 1
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is None:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        else:
            with prof:
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        eng.run()                                         # drain
        return dt

    wall = window(300)
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    wall_prof = window(301, prof)
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "decode_trace.json"))
    if not rows:
        emit("profile", steps=steps, wall_ms_per_step=wall / steps * 1e3,
             device_ms_per_step="not measured")
        return
    pd_us = sum(r[0] for r in rows if "paged_decode" in r[2])
    emit("profile", steps=steps, wall_ms_per_step=wall / steps * 1e3,
         profiled_wall_ms_per_step=wall_prof / steps * 1e3,
         device_ms_per_step=dev_ms / steps,
         device_busy_share=dev_ms / (wall * 1e3),
         paged_decode_ms_per_step=pd_us / 1e3 / steps,
         kernels_per_step=sum(r[1] for r in rows) / steps,
         top=[{"name": k[:80], "calls_per_step": c / steps,
               "ms_per_step": us / 1e3 / steps}
              for us, c, k in rows[:10]])


# --------------------------------------------- the engine's reliability slice
# the agreed-prefix floors of the layouts phase: a bf16 engine through the
# kernel against the plain bf16 engine (the same bf16 pools, fp32 math);
# a lossy layout against fp32 — the JAX package's contract
# (tests/test_quant_serving.py: agreed-prefix share >= 0.25; its 43M row,
# bench.py lmdecode_quant: first tokens agree on >= 0.6 of the requests)
BF16_KERNEL_AGREE = 0.9
LOSSY_AGREE, LOSSY_FIRST = 0.25, 0.6
WATCHDOG_S = 0.5                # the faults phase's real step budget
FAULT_STEP = 5                  # the decode step each fault plan hits
# the spill phase's pool: the default size, 8 x 37 blocks + scratch, holds
# 8 slots at once (<= 37 blocks each) but not the 344 blocks of prefix the
# 16 prompts of a wave leave in the tree
SPILL_POOL_BLOCKS = SLOTS * (MAX_LEN // BLOCK) + 1


class _Clock:
    """An injected engine clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _agreement(got, ref):
    """(share of the horizon inside each request's agreed prefix,
    share of requests whose first tokens agree) of two token lists."""
    agreed = sum(next((i for i, (a, b) in enumerate(zip(g, r)) if a != b),
                      min(len(g), len(r))) for g, r in zip(got, ref))
    first = sum(bool(g and r and g[0] == r[0]) for g, r in zip(got, ref))
    return agreed / sum(len(r) for r in ref), first / len(ref)


def _with_plan(spec: str, fn):
    """Run fn() under the fault plan `spec`; restore the plan found."""
    from bigdl_tpu_torch.utils import faults

    found = faults.get_plan()
    faults.set_plan(faults.FaultPlan(spec))
    try:
        return fn()
    finally:
        faults.set_plan(found)


def _lifecycle_script(eng, clock):
    """The lifecycle wave on one engine (8 slots, max_queue 4,
    shed-lowest-priority), driven on an injected clock that moves 1.0
    a step. R0-R7 fill the slots; R2-R5 carry a 30 s deadline that runs
    out mid-decode; R8 and R9 a 3 s queue wait that runs out while the
    slots are full; R10 is cancelled while queued; R11 (priority -1) is
    the victim R12 (priority 1) sheds from the full queue; R1 is
    cancelled in flight at step 10; R13-R15 arrive at step 6. Returns
    the results in request order."""
    from bigdl_tpu_torch.serving import Request

    wave = _wave(200)
    for i in (2, 3, 4, 5):
        wave[i]["deadline_s"] = 30.0
    for i in (8, 9):
        wave[i]["max_queue_wait_s"] = 3.0
    wave[11]["priority"] = -1
    wave[12]["priority"] = 1
    ids = [None] * len(wave)
    done = {}

    def submit(i):
        ids[i] = eng.submit(Request(**wave[i]))

    def step():
        for r in eng.step():
            done[r.id] = r
        clock.t += 1.0

    for i in range(4):
        submit(i)
    step()
    for i in range(4, 8):
        submit(i)
    step()
    for i in range(8, 13):          # R12 sheds R11 from the full queue
        submit(i)
    done[ids[10]] = eng.cancel(ids[10])
    n = 2
    while not eng.idle:
        if n == 6:
            for i in range(13, 16):
                submit(i)
        if n == 10:
            done[ids[1]] = eng.cancel(ids[1])
        step()
        n += 1
    done.update(eng.completed)
    eng.completed.clear()
    return [done[i] for i in ids]


LIFECYCLE_EXPECTED = (["done", "shed"] + ["expired"] * 4 + ["done"] * 2
                      + ["expired"] * 2 + ["shed"] * 2 + ["done"] * 4)


def phase_engine_lifecycle(model, params):
    """Deadlines, queue-wait TTLs, cancellation and shed-lowest-priority
    on the card: the scripted wave through the kernel engine and the
    plain-attention engine; every status, reason, clock-derived time and
    the done requests' tokens must agree; K1 launches == steps x 8."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import InferenceEngine

    knobs = dict(ENGINE_KNOBS, max_queue=4,
                 overload_policy="shed-lowest-priority")
    runs = {}
    for impl in ("cuda", "torch"):
        clock = _Clock()
        eng = InferenceEngine(model, params, attn_impl=impl, clock=clock,
                              **knobs)
        torch.cuda.synchronize()
        steps0 = eng.stats["decode_steps"]
        paged_decode.launches = 0                 # main path starts here
        t0 = time.perf_counter()
        res = _lifecycle_script(eng, clock)
        torch.cuda.synchronize()
        runs[impl] = dict(res=res, seconds=time.perf_counter() - t0,
                          launches=paged_decode.launches,
                          steps=eng.stats["decode_steps"] - steps0,
                          stats=eng.stats)
    k, p = runs["cuda"], runs["torch"]
    _check_launches("engine_lifecycle", k["launches"], k["steps"])
    check(p["launches"] == 0, "the plain engine launched the kernel")
    statuses = [r.status for r in k["res"]]
    check(statuses == LIFECYCLE_EXPECTED,
          f"engine_lifecycle statuses {statuses}")
    check(k["res"][11].finish_reason == "shed"
          and k["res"][10].finish_reason == "cancelled"
          and k["res"][1].finish_reason == "cancelled",
          "engine_lifecycle: shed victim or cancellations misreported")
    for a, b in zip(k["res"], p["res"]):
        check((a.status, a.finish_reason, a.ttft_s, a.latency_s)
              == (b.status, b.finish_reason, b.ttft_s, b.latency_s),
              f"request {a.id}: {a.status}/{a.finish_reason} "
              f"({a.ttft_s}, {a.latency_s}) against the plain engine's "
              f"{b.status}/{b.finish_reason} ({b.ttft_s}, {b.latency_s})")
        if a.status == "done":
            check(a.tokens == b.tokens,
                  f"request {a.id}: done tokens differ from the plain "
                  "engine's")
    for key in ("shed", "deadline_misses", "cancelled", "requests_done"):
        check(k["stats"][key] == p["stats"][key],
              f"engine_lifecycle stats[{key}] differ")
    expired_tokens = [len(r.tokens) for r in k["res"]
                      if r.status == "expired"]
    emit("engine_lifecycle", requests=len(statuses), statuses=statuses,
         expired_tokens=expired_tokens,
         expired_tokens_equal_plain=[
             a.tokens == b.tokens for a, b in zip(k["res"], p["res"])
             if a.status == "expired"],
         decode_steps=k["steps"], kernel_launches=k["launches"],
         seconds=k["seconds"], plain_seconds=p["seconds"],
         stats={key: k["stats"][key] for key in (
             "shed", "deadline_misses", "cancelled", "requests_done",
             "prefill_calls")})
    return k["launches"]


def phase_engine_faults(model, params):
    """The serving fault plans on the card: serve_nan poisons the lowest
    slot and spares its co-batch bit for bit; serve_err is retried once
    (tokens unchanged) or, twice, degrades the engine; serve_slow trips
    a real step watchdog armed at construction (kernel warm); drain()
    mid-wave finishes the accepted work. Prints health()'s p50/p95."""
    import threading

    import torch

    from bigdl_tpu_torch.serving import (EngineDegraded, EngineDraining,
                                         InferenceEngine, Request)

    wave = _wave(300)

    def engine(**kw):
        return InferenceEngine(model, params, retry_backoff_s=0.0,
                               **ENGINE_KNOBS, **kw)

    clean_eng = engine()
    clean, dt, steps, launches = _timed_run(clean_eng, wave)
    _check_launches("engine_faults clean", launches, steps)
    ref = [r.tokens for r in clean]
    health = clean_eng.health()
    out = {"clean_seconds": dt, "decode_steps": steps,
           "kernel_launches": launches,
           "decode_p50_ms": health["decode_p50_ms"],
           "decode_p95_ms": health["decode_p95_ms"],
           "decode_p99_ms": health["metrics"]["decode_step_seconds"][
               "p99_ms"]}

    eng = engine()
    res = _with_plan(f"serve_nan@{FAULT_STEP}",
                     lambda: _timed_run(eng, wave))[0]
    check(res[0].status == "poisoned" and eng.stats["poisoned"] == 1,
          "serve_nan: the lowest slot was not poisoned")
    check(res[0].tokens == ref[0][:FAULT_STEP],
          "serve_nan: the poisoned request lost its earlier tokens")
    check(all(r.status == "done" and r.tokens == t
              for r, t in zip(res[1:], ref[1:])),
          "serve_nan: a co-batched request differs from the clean run")

    eng = engine(step_retries=1)
    res = _with_plan(f"serve_err@{FAULT_STEP}",
                     lambda: _timed_run(eng, wave))[0]
    check(eng.stats["retries"] == 1 and eng.degraded is None,
          f"serve_err: retries {eng.stats['retries']}, degraded "
          f"{eng.degraded}")
    check([r.tokens for r in res] == ref,
          "serve_err: a retried step changed the tokens")

    eng = engine(step_retries=1)
    res = _with_plan(f"serve_err@{FAULT_STEP}x2",
                     lambda: _timed_run(eng, wave))[0]
    check(eng.degraded is not None
          and all(r.status == "failed" for r in res),
          "serve_err twice: the engine did not degrade and fail all")
    try:
        eng.submit(Request(**wave[0]))
        check(False, "submit on a degraded engine did not raise")
    except EngineDegraded:
        pass

    t0 = time.perf_counter()
    eng = engine(step_timeout_s=WATCHDOG_S)
    out["watchdog_construct_seconds"] = time.perf_counter() - t0
    check(eng.stats["watchdog_trips"] == 0, "the watchdog tripped at "
          "construction")
    res = _with_plan(f"serve_slow@{FAULT_STEP}",
                     lambda: _timed_run(eng, wave))[0]
    h = eng.health()
    check(eng.stats["watchdog_trips"] == 1
          and eng.stats["decode_steps"] == FAULT_STEP
          and h["state"] == "degraded"
          and all(r.status == "failed" for r in res),
          f"serve_slow: trips {eng.stats['watchdog_trips']} at step "
          f"{eng.stats['decode_steps']}, state {h['state']}")
    check(all(r.tokens == t[:FAULT_STEP] for r, t in
              zip(res[:SLOTS], ref[:SLOTS])),
          "serve_slow: tokens before the trip differ from the clean run")
    for th in threading.enumerate():     # the abandoned step sleeps out
        if th.name == "bigdl-serving-step":
            th.join(WATCHDOG_S * 10)
            check(not th.is_alive(), "an abandoned step never returned")
    out["watchdog_degraded_reason"] = h["degraded_reason"]

    eng = engine()
    ids = [eng.submit(Request(**r)) for r in wave]
    for _ in range(3):
        eng.step()
    eng.drain()
    states = [eng.health()["state"]]
    try:
        eng.submit(Request(**wave[0]))
        check(False, "submit on a draining engine did not raise")
    except EngineDraining:
        pass
    while not eng.idle:
        for r in eng.step():
            eng.completed[r.id] = r
    torch.cuda.synchronize()
    states.append(eng.health()["state"])
    res = [eng.completed.pop(i) for i in ids]
    check(states == ["draining", "drained"], f"drain states {states}")
    check([r.tokens for r in res] == ref
          and all(r.status == "done" for r in res),
          "drain: accepted requests did not finish as in the clean run")
    emit("engine_faults", fault_step=FAULT_STEP, watchdog_s=WATCHDOG_S,
         poisoned_slot=0, retries=1, drain_states=states, **out)


LAYOUTS = (("fp32/float32", "fp32", "float32"),
           ("fp32/bfloat16", "fp32", "bfloat16"),
           ("int8/bfloat16", "int8", "bfloat16"))


def _device_ms_per_step(eng, seed, steps=16):
    """Device kernel time a decode step, from torch.profiler over
    `steps` steps with all slots decoding (the wave's admissions done
    first); None when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serving import Request

    for r in _wave(seed):
        eng.submit(Request(**r))
    for _ in range(4):                  # the 8 admissions land in step 1
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()                                             # drain
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / steps if us > 0 else None


def phase_engine_layouts(model, params, fp32_tokens):
    """The timed wave under fp32/float32, fp32/bfloat16 and
    int8/bfloat16 through the kernel (bf16 pools run K1's bf16
    instantiation), in turns (each layout, then each again in reverse
    order, on waves 100 and 101): launches exact, each bf16 engine
    against the plain bf16 engine, each lossy layout against fp32 at the
    contract's floors; tokens/s, step ms, device ms a step, pool GiB,
    weight bytes. Then swap_params to the same weights mid-wave: tokens
    bitwise unchanged."""
    import torch

    from bigdl_tpu_torch.serving import (InferenceEngine, Request,
                                         params_bytes)

    engines, out, tokens, launches_by = {}, {}, {}, {}
    for family, wdt, cdt in LAYOUTS:
        eng = InferenceEngine(model, params, weight_dtype=wdt,
                              cache_dtype=getattr(torch, cdt),
                              **ENGINE_KNOBS)
        check(eng.layout_family == family and eng.attn_impl == "cuda",
              f"{family}: layout {eng.layout_family}, {eng.attn_impl}")
        eng.run([Request(**r) for r in _wave(0)])          # warm-up
        engines[family] = eng
        out[family] = {"tokens_per_sec": [], "step_ms": [],
                       "decode_steps": [], "kernel_launches": []}
    order = [f for f, _, _ in LAYOUTS]
    for seed, family in zip([100] * 3 + [101] * 3, order + order[::-1]):
        eng, row = engines[family], out[family]
        res, dt, steps, launches = _timed_run(eng, _wave(seed))
        _check_launches(f"engine_layouts {family}", launches, steps)
        check(all(r.status == "done" and len(r.tokens) == NEW_TOKENS
                  for r in res), f"{family}: a request did not finish")
        n_tok = sum(len(r.tokens) for r in res)
        row["tokens_per_sec"].append(n_tok / dt)
        row["step_ms"].append(dt / steps * 1e3)
        row["decode_steps"].append(steps)
        row["kernel_launches"].append(launches)
        if seed == 100:
            tokens[family] = [r.tokens for r in res]
            launches_by[family] = launches
    for family, wdt, cdt in LAYOUTS:
        eng, row = engines[family], out[family]
        toks = tokens[family]
        wbytes = params_bytes(eng._params)
        row.update(
            pool_gib=sum(t.numel() * t.element_size() for layer in eng.pool
                         for t in layer.values()) / 2**30,
            weight_bytes=wbytes,
            weight_bytes_per_token=wbytes * row["decode_steps"][0]
            / sum(len(t) for t in toks),
            device_ms_per_step=_device_ms_per_step(eng, 500))
        if row["device_ms_per_step"] is not None:
            row["device_busy_share"] = row["device_ms_per_step"] \
                / statistics.median(row["step_ms"])
        if cdt == "bfloat16":
            plain = InferenceEngine(model, params, attn_impl="torch",
                                    weight_dtype=wdt,
                                    cache_dtype=torch.bfloat16,
                                    **ENGINE_KNOBS)
            ref = [r.tokens for r in plain.run(
                [Request(**r) for r in _wave(100)])]
            agree, _ = _agreement(toks, ref)
            check(agree >= BF16_KERNEL_AGREE,
                  f"{family}: the kernel engine agrees with the plain "
                  f"bf16 engine over {agree:.3f} < {BF16_KERNEL_AGREE}")
            row.update(plain_agreed_prefix=agree,
                       plain_same_requests=sum(a == b for a, b in
                                               zip(toks, ref)))
            del plain
        if family != "fp32/float32":
            agree, first = _agreement(toks, tokens["fp32/float32"])
            check(agree >= LOSSY_AGREE and first >= LOSSY_FIRST,
                  f"{family}: against fp32 agreed prefix {agree:.3f} "
                  f"(floor {LOSSY_AGREE}), first tokens {first:.3f} "
                  f"(floor {LOSSY_FIRST})")
            row.update(fp32_agreed_prefix=agree, fp32_first_token=first)
    del engines
    torch.cuda.empty_cache()
    check(tokens["fp32/float32"] == fp32_tokens,
          "fp32/float32 layout tokens differ from the engine phase's")

    eng = InferenceEngine(model, params, **ENGINE_KNOBS)
    ids = [eng.submit(Request(**r)) for r in _wave(100)]
    for _ in range(10):
        for r in eng.step():
            eng.completed[r.id] = r
    eng.swap_params(params)
    res = eng.run()
    got = {r.id: r.tokens for r in res}
    check([got[i] for i in ids] == tokens["fp32/float32"]
          and eng.stats["weight_swaps"] == 1,
          "swap_params to the same weights changed the tokens")
    emit("engine_layouts", layouts=out, order=order + order[::-1],
         bf16_kernel_floor=BF16_KERNEL_AGREE,
         lossy_floors={"agreed_prefix": LOSSY_AGREE,
                       "first_token": LOSSY_FIRST},
         swap_tokens_unchanged=True)
    return launches_by


def _timed_method(eng, name, log, counter=None):
    """Wrap eng.<name> to log (seconds, how far stats[counter] moved) of
    each call, the card synchronised around it."""
    import torch

    real = getattr(eng, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        n0 = eng.stats[counter] if counter else 0
        t0 = time.perf_counter()
        r = real(*a, **k)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0,
                    (eng.stats[counter] if counter else 0) - n0))
        return r

    setattr(eng, name, timed)


def phase_engine_spill_handoff(model, params, fp32_tokens):
    """The host spill tier, disaggregated prefill and tree migration on
    the card, fp32 (bitwise contracts): a second wave of the first
    wave's prompts through a 297-block pool spills and re-admits and its
    tokens equal the cold wave's bit for bit; a prefill-role engine hands
    every request of the timed wave to a decode-role engine with tokens
    bit for bit the one-engine run's; export_tree into a fresh engine
    gives prefix hits. Seconds per spill, readmission, export and
    import."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import InferenceEngine, Request

    block_mib = (2 * LAYERS * HEADS * BLOCK * (DIM // HEADS) * 4) / 2**20
    wave = [dict(r, temperature=0.8, top_k=50) for r in _wave(400)]
    eng = InferenceEngine(model, params, spill=True,
                          pool_blocks=SPILL_POOL_BLOCKS, **ENGINE_KNOBS)
    spills, readmits = [], []
    _timed_method(eng, "_spill_blocks", spills, "kv_spill_blocks")
    _timed_method(eng, "_readmit_chain", readmits, "kv_readmit_blocks")
    cold, _, steps_c, launches_c = _timed_run(eng, wave)
    _check_launches("engine_spill cold", launches_c, steps_c)
    spilled_cold = eng.stats["kv_spill_blocks"]
    readmits.clear()            # (the cold wave re-admits nothing)
    warm, dt, steps, launches = _timed_run(eng, wave)
    _check_launches("engine_spill warm", launches, steps)
    s = eng.stats
    check(s["kv_spill_blocks"] > 0 and s["kv_readmit_blocks"] > 0,
          f"spill: spilled {s['kv_spill_blocks']}, re-admitted "
          f"{s['kv_readmit_blocks']}")
    check([r.tokens for r in warm] == [r.tokens for r in cold],
          "spill: warm tokens differ from the cold run")
    spill_calls = [(t, n) for t, n in spills if n]
    readmit_calls = [(t, n) for t, n in readmits if n]
    spill = {
        "pool_blocks": SPILL_POOL_BLOCKS, "block_mib": block_mib,
        "spilled_cold_wave": spilled_cold,
        "spilled": s["kv_spill_blocks"], "readmitted":
            s["kv_readmit_blocks"], "host_evictions":
            s["kv_host_evictions"], "prefix_hits": s["prefix_hits"],
        "spill_calls": len(spill_calls),
        "spill_ms_per_call": 1e3 * sum(t for t, _ in spill_calls)
        / max(len(spill_calls), 1),
        "spill_ms_per_mib": 1e3 * sum(t for t, _ in spill_calls)
        / max(sum(n for _, n in spill_calls) * block_mib, 1e-9),
        "readmit_calls": len(readmit_calls),
        "readmit_ms_per_call": 1e3 * sum(t for t, _ in readmit_calls)
        / max(len(readmit_calls), 1),
        "readmit_ms_per_mib": 1e3 * sum(t for t, _ in readmit_calls)
        / max(sum(n for _, n in readmit_calls) * block_mib, 1e-9),
        "warm_tokens_per_sec": sum(len(r.tokens) for r in warm) / dt,
        "warm_equals_cold": True}

    t0 = time.perf_counter()
    entries = eng.export_tree()
    export_s = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    fresh = InferenceEngine(model, params, spill=True,
                            host_blocks=len(entries), **ENGINE_KNOBS)
    t0 = time.perf_counter()
    grafted = fresh.import_tree(entries)
    import_s = time.perf_counter() - t0
    moved, _, steps_m, launches_m = _timed_run(fresh, wave)
    _check_launches("engine_tree", launches_m, steps_m)
    check(grafted > 0 and fresh.stats["prefix_hits"] > 0
          and fresh.stats["kv_readmit_blocks"] > 0,
          f"import_tree: grafted {grafted}, hits "
          f"{fresh.stats['prefix_hits']}")
    check([r.tokens for r in moved] == [r.tokens for r in cold],
          "import_tree: migrated-prefix tokens differ from the cold run")
    tree = {"entries": len(entries), "grafted": grafted,
            "export_seconds": export_s, "import_seconds": import_s,
            "prefix_hits": fresh.stats["prefix_hits"],
            "readmitted": fresh.stats["kv_readmit_blocks"]}
    del fresh
    torch.cuda.empty_cache()

    timed = _wave(100)
    pre = InferenceEngine(model, params, role="prefill", **ENGINE_KNOBS)
    dec = InferenceEngine(model, params, role="decode", **ENGINE_KNOBS)
    exports, imports = [], []
    _timed_method(pre, "_export_handoff", exports)
    _timed_method(dec, "import_handoff", imports)
    ids = [pre.submit(Request(**r)) for r in timed]
    while not pre.idle:
        pre.step()
    pkgs = pre.take_handoffs()
    torch.cuda.synchronize()
    steps0 = dec.stats["decode_steps"]
    paged_decode.launches = 0
    while pkgs or not dec.idle:
        while pkgs and dec.import_handoff(pkgs[0]):
            pkgs.pop(0)
        for r in dec.step():
            dec.completed[r.id] = r
    torch.cuda.synchronize()
    launches_h = paged_decode.launches
    _check_launches("engine_handoff", launches_h,
                    dec.stats["decode_steps"] - steps0)
    res = [dec.completed.pop(i) for i in ids]
    check([r.tokens for r in res] == fp32_tokens,
          "handoff: tokens differ from the one-engine run")
    handoff = {"requests": len(res), "handoffs_out":
               pre.stats["handoffs_out"], "handoffs_in":
               dec.stats["handoffs_in"],
               "export_ms_per_request": 1e3 * sum(t for t, _ in exports)
               / len(exports),
               "import_ms_per_request": 1e3 * sum(t for t, _ in imports)
               / len(imports),
               "kernel_launches": launches_h}
    emit("engine_spill_handoff", spill=spill, tree=tree, handoff=handoff)
    return {"spill": launches, "tree": launches_m, "handoff": launches_h}


def _train_model(attn_impl=None, config=None):
    """The trainer's 43M LM (`config`, default TRAIN_CONFIG) on the
    card."""
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    return TransformerLM(TransformerConfig(**(config or TRAIN_CONFIG)),
                         attn_impl=attn_impl)


def phase_train_model():
    """One fp32 loss-and-grad step of the full-width LM through the
    flash kernels against the same step through the plain versions,
    from the same params and batch (FULL_PRECISION, TF32 off)."""
    emit("train_model", **_kernel_step_check("train-model", TRAIN_CONFIG))


def _kernel_step_check(where: str, config: dict) -> dict:
    """phase_train_model's check of the LM built from `config`: loss
    within TRAIN_LOSS_TOL, every gradient within TRAIN_GRAD_TOL of the
    plain step's, one forward and BWD_LAUNCHES backward launches a
    layer; returns the fields to emit."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.models.convert import (tree_leaves,
                                                tree_leaves_with_path,
                                                tree_map)
    from bigdl_tpu_torch.nn import ChunkedSoftmaxCE
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import FULL_PRECISION

    batch = synthetic_next_token(TRAIN_BATCH, VOCAB, TRAIN_SEQ, seed=3)
    x = torch.as_tensor(np.stack([b.feature for b in batch])).cuda()
    y = torch.as_tensor(np.stack([b.label for b in batch])).cuda()
    params = None
    out = {}
    for impl in ("cuda", "torch"):
        model = _train_model(impl, config)
        if params is None:
            params = model.init_params(torch.Generator().manual_seed(0))
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss_call = build_train_loss(model, ChunkedSoftmaxCE(),
                                     FULL_PRECISION)
        f0, b0 = fa.fwd_launches, fa.bwd_launches
        loss, _ = loss_call(p, {}, x, y, None)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        out[impl] = (float(loss.detach()), grads,
                     fa.fwd_launches - f0, fa.bwd_launches - b0)
    dloss = abs(out["cuda"][0] - out["torch"][0])
    # each leaf's difference relative to its own max, floored at
    # TRAIN_GRAD_FLOOR of the largest gradient: the key bias's gradient
    # is zero in exact arithmetic (softmax is shift-invariant), so both
    # paths return rounding noise there
    top = max(float(b.abs().max()) for b in out["torch"][1])
    rels = {".".join(map(str, path)): float((a - b).abs().max()) / max(
        float(b.abs().max()), TRAIN_GRAD_FLOOR * top)
        for (path, _), a, b in zip(tree_leaves_with_path(params),
                                   out["cuda"][1], out["torch"][1])}
    rel = max(rels.values())
    check(math.isfinite(out["cuda"][0]), f"{where} loss not finite")
    check(dloss <= TRAIN_LOSS_TOL, f"{where} |dloss| {dloss}")
    check(rel <= TRAIN_GRAD_TOL, f"{where} grad rel diff {rel}")
    layers = config["num_layers"]
    check(out["cuda"][2:] == (layers, layers * fa.BWD_LAUNCHES),
          f"{where} cuda step launched {out['cuda'][2:]} kernels")
    check(out["torch"][2:] == (0, 0), "the plain step launched kernels")
    return dict(loss_cuda=out["cuda"][0], loss_torch=out["torch"][0],
                loss_abs_diff=dloss, grad_max_rel_diff=rel,
                tolerance={"loss": TRAIN_LOSS_TOL,
                           "grad_rel": TRAIN_GRAD_TOL},
                grad_rel_diff_by_leaf=rels, grad_floor=TRAIN_GRAD_FLOOR,
                launches={"fwd": out["cuda"][2], "bwd": out["cuda"][3]},
                params=int(sum(t.numel() for t in tree_leaves(params))))


def _trainer(steps: int, watch, config=None):
    """The main path: Optimizer(...).optimize() on the bench
    configuration (or `config`) for `steps` steps
    (Trigger.max_iteration); `watch(train_state)` sees the state before
    every step and at the end."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    model = _train_model(config=config)
    model.build(torch.Generator().manual_seed(0))
    samples = synthetic_next_token(TRAIN_BATCH * steps, VOCAB, TRAIN_SEQ)
    stop = Trigger.max_iteration(steps)

    def end_when(state):
        watch(state)
        return stop(state)

    Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
              batch_size=TRAIN_BATCH).set_optim_method(Adam(3e-4)) \
        .set_precision("bf16").set_end_when(Trigger(end_when)).optimize()
    return model


def phase_trainer():
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed steps whose flash
    launches are counted from zero; losses read after the run."""
    fwd, bwd, _ = _timed_trainer("trainer", TRAIN_CONFIG, TRAIN_WARMUP,
                                 TRAIN_STEPS)
    return fwd, bwd


def _timed_trainer(phase: str, config: dict, warmup: int, steps: int):
    """phase_trainer's run of the LM built from `config`: `warmup`
    steps, then `steps` timed steps whose flash launches are counted
    from zero, the loss gated to fall; emits `phase` and returns the
    (forward, backward) launches and the trained model."""
    import torch

    from bigdl_tpu_torch.models.transformer import (
        TransformerConfig, lm_train_matmul_flops_per_token)
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    losses, marks = [], {}

    def on_step(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        n = state["neval"]
        if n == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.fwd_launches = fa.bwd_launches = 0  # main path starts here
            marks["t0"] = time.perf_counter()
        elif n == warmup + steps:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = (fa.fwd_launches,  # main path ends here
                                 fa.bwd_launches)

    model = _trainer(warmup + steps, on_step, config)
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"]
    fwd, bwd = marks["launches"]
    layers = config["num_layers"]
    check(len(losses) == warmup + steps
          and all(math.isfinite(v) for v in losses),
          f"{phase} losses not all finite: {losses}")
    check(losses[-1] < losses[0], f"{phase} loss did not fall: {losses}")
    check(fwd == steps * layers,
          f"forward launches {fwd} != {steps} steps x {layers}")
    check(bwd == steps * layers * fa.BWD_LAUNCHES,
          f"backward launches {bwd} != {steps} x {layers} x "
          f"{fa.BWD_LAUNCHES}")
    tokens = steps * TRAIN_BATCH * TRAIN_SEQ
    flops = lm_train_matmul_flops_per_token(
        TransformerConfig(**config)) * tokens
    emit(phase, steps=steps, warmup_steps=warmup,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, heads=config["num_heads"],
         seconds=dt, step_ms=dt / steps * 1e3,
         tokens_per_sec=tokens / dt,
         model_flops_share=flops / dt / BF16_FLOPS_PER_S,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches={"fwd": fwd, "bwd": bwd}, losses=losses)
    return fwd, bwd, model


def phase_train_profile():
    """Where a training step's device time goes (`--profile` only): two
    steps after two warm-up steps under torch.profiler; the flash
    kernels' share of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    marks = {}

    def on_step(state):
        if state["neval"] == 2:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif state["neval"] == 4:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.stop()

    _trainer(4, on_step)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "train_trace.json"))
    if not rows:
        emit("train_profile", device_ms_per_step="not measured")
        return
    dev_ms = sum(r[0] for r in rows) / 1e3 / 2
    # fa_{fwd,dkdv,dq}_kernel (fp32) and fa_{fwd,dkdv,dq}_bf16_kernel
    flash = re.compile(r"fa_(fwd|dkdv|dq)_(bf16_)?kernel")
    flash_ms = sum(r[0] for r in rows if flash.search(r[2])) / 1e3 / 2
    wall_ms = (marks["t1"] - marks["t0"]) / 2 * 1e3
    emit("train_profile", steps=2,
         profiled_wall_ms_per_step=wall_ms,
         device_ms_per_step=dev_ms, busy_share=dev_ms / wall_ms,
         flash_ms_per_step=flash_ms,
         flash_share_of_device=flash_ms / dev_ms,
         flash_launches_per_step=sum(r[1] for r in rows
                                     if flash.search(r[2])) / 2,
         flash_ms_by_kernel={flash.search(k).group(0): us / 1e3 / 2
                             for us, _, k in rows if flash.search(k)},
         kernels_per_step=sum(r[1] for r in rows) / 2,
         top=[{"name": k[:80], "calls_per_step": c / 2,
               "ms_per_step": us / 1e3 / 2} for us, c, k in rows[:12]])


# ----------------------------------------- checkpoint, resume, the guard
# lm_resume: the trainer's LM with accumulation 2 (RESUME_MICRO micro-
# steps, RESUME_MICRO / 2 updates); the checkpointed run R1 saves every
# RESUME_CKPT_EVERY micro-steps in the background and dies under
# RESUME_PLAN (checkpoint 6 published, then damaged; preempted before
# micro-step 7); R2 resumes from checkpoint 3, the mid-cycle one
RESUME_MICRO, RESUME_ACCUM, RESUME_CKPT_EVERY = 8, 2, 3
RESUME_PLAN = "ckpt_corrupt@6,preempt@7"
RESUME_TIMED_FROM = 2           # U's micro-steps timed from here to the end
GUARD_WARMUP, GUARD_STEPS = 2, 6


def _lm_optimizer(samples, micro, seed=0, accum=RESUME_ACCUM, watch=None):
    """The trainer's configuration (TRAIN_CONFIG, batch 8 x 2048, bf16,
    Adam(3e-4)) on a model built from `seed`, ending after `micro`
    micro-steps; `watch(train_state)` sees the state before every
    micro-step and at the end."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    model = _train_model()
    model.build(torch.Generator().manual_seed(seed))
    stop = Trigger.max_iteration(micro)

    def end_when(state):
        if watch is not None:
            watch(state)
        return stop(state)

    o = Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
                  batch_size=TRAIN_BATCH).set_optim_method(Adam(3e-4)) \
        .set_precision("bf16").set_end_when(Trigger(end_when))
    if accum > 1:
        o.set_gradient_accumulation(accum)
    return o


def _timed_saves(ck, out: list) -> None:
    """Record the loop's stall in each `Checkpoint.save` call: the host
    snapshot, plus the write itself when it is synchronous, plus the
    drain of the previous write when it is not."""
    import torch

    save = ck.save

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        out.append({"step": args[0], "s": time.perf_counter() - t0})
        return path

    ck.save = timed


def _flash_counts():
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    return fa.fwd_launches, fa.bwd_launches


def _zero_flash_counts() -> None:
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    fa.fwd_launches = fa.bwd_launches = 0


def _check_flash_counts(run: str, micro: int) -> dict:
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    layers = TRAIN_CONFIG["num_layers"]
    fwd, bwd = _flash_counts()
    check((fwd, bwd) == (micro * layers, micro * layers * fa.BWD_LAUNCHES),
          f"lm_resume {run}: flash launches {(fwd, bwd)} != {micro} "
          f"micro-steps x {layers} layers (x {fa.BWD_LAUNCHES} backward)")
    return {"fwd": fwd, "bwd": bwd, "micro_steps": micro}


def _dir_gib(d: Path) -> float:
    return sum(f.stat().st_size for f in d.iterdir()) / 2 ** 30


def _first_difference(a_params, b_params, a_losses, b_losses) -> str:
    """Where two runs of one configuration part: the first micro-step
    whose loss differs, the differing leaves, and whether the flash
    kernels repeat themselves bit for bit at the trainer's shape."""
    import torch

    from bigdl_tpu_torch.models.convert import tree_leaves_with_path
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    step = next((i + 1 for i, (x, y) in enumerate(zip(a_losses, b_losses))
                 if x != y), None)
    leaves = [".".join(map(str, p)) for (p, x), (_, y) in zip(
        tree_leaves_with_path(a_params), tree_leaves_with_path(b_params))
        if not torch.equal(x, y)]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(TRAIN_BATCH, HEADS, TRAIN_SEQ, DIM // HEADS,
                               generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    outs = []
    for _ in range(2):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv, causal=True, impl="cuda")
        outs.append((o.detach(), *torch.autograd.grad(o, (qq, kk, vv), do)))
    same = [torch.equal(x, y) for x, y in zip(*outs)]
    return (f"first loss difference at micro-step {step}; leaves "
            f"{leaves[:6]} ({len(leaves)} differ); flash forward repeats "
            f"bitwise: {same[0]}, backward dq/dk/dv: {same[1:]}")


def phase_lm_resume():
    """Checkpoint and resume through the flash kernels: the 43M LM
    (TRAIN_CONFIG, batch 8 x 2048, bf16, Adam(3e-4),
    set_gradient_accumulation(2)) through Optimizer(...).optimize(), four
    runs from the same seeded weights and samples:
    U (RESUME_MICRO micro-steps, no checkpoint), U' (U again: the card
    must repeat its own run bit for bit), R1 (U with an async checkpoint
    every RESUME_CKPT_EVERY micro-steps, a train summary and the fault
    plan RESUME_PLAN: checkpoint 3 is mid-cycle, 6 is published and
    then damaged, R1 dies preempted before micro-step 7) and R2 (a
    model from another seed, resume_from_checkpoint(), synchronous
    checkpoints, to RESUME_MICRO: it skips the damaged checkpoint,
    resumes from 3 with its accumulator). Gates: every leaf of R2's and
    U''s params equal to U's, R2 ends at neval 8 and nupdates 4, the
    flash launches of each run exact, R1's Loss scalars finite at steps
    1-6. Then the trainer's configuration without accumulation,
    GUARD_WARMUP + GUARD_STEPS steps unguarded, guarded (skip_step, no
    fault), guarded, unguarded: what the guard's per-step read costs."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.visualization import TrainSummary

    samples = synthetic_next_token(TRAIN_BATCH * RESUME_MICRO, VOCAB,
                                   TRAIN_SEQ)
    tmp = Path(tempfile.mkdtemp(prefix="lm_resume_"))
    out: dict = {"micro_steps": RESUME_MICRO, "accum": RESUME_ACCUM,
                 "checkpoint_every": RESUME_CKPT_EVERY, "plan": RESUME_PLAN}
    try:
        # U and U': the uninterrupted run, twice
        runs = {}
        for name in ("U", "U'"):
            losses, marks = [], {}

            def watch(state, losses=losses, marks=marks):
                if state["loss"] is not None:
                    losses.append(state["loss"])
                if state["neval"] in (RESUME_TIMED_FROM, RESUME_MICRO):
                    torch.cuda.synchronize()
                    marks[state["neval"]] = time.perf_counter()

            o = _lm_optimizer(samples, RESUME_MICRO, watch=watch)
            _zero_flash_counts()                # main path starts here
            o.optimize()
            out[f"launches_{name}"] = _check_flash_counts(name,
                                                          RESUME_MICRO)
            runs[name] = (o.model.variables["params"],
                          [float(v) for v in losses])
            out[f"micro_step_ms_{name}"] = (
                marks[RESUME_MICRO] - marks[RESUME_TIMED_FROM]) / (
                RESUME_MICRO - RESUME_TIMED_FROM) * 1e3
            del o
        u_params, u_losses = runs["U"]
        check(all(math.isfinite(v) for v in u_losses)
              and len(u_losses) == RESUME_MICRO,
              f"lm_resume U losses {u_losses}")
        if not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(u_params), tree_leaves(runs["U'"][0]))):
            check(False, "lm_resume: the card did not repeat its own run "
                         "(U' != U): " + _first_difference(
                             u_params, runs["U'"][0], u_losses,
                             runs["U'"][1]))
        del runs["U'"]
        torch.cuda.empty_cache()

        # R1: async checkpoints and a summary; damaged, then preempted
        r1_saves = []
        summary = TrainSummary(str(tmp / "logs"), "lm_resume")
        o = _lm_optimizer(samples, RESUME_MICRO)
        o.set_checkpoint(str(tmp / "ckpt"),
                         Trigger.several_iteration(RESUME_CKPT_EVERY),
                         async_save=True).set_train_summary(summary)
        _timed_saves(o.checkpoint, r1_saves)
        faults.set_plan(faults.FaultPlan(RESUME_PLAN))
        preempted = None
        _zero_flash_counts()
        try:
            o.optimize()
        except faults.Preempted as e:           # the planned death
            preempted = str(e)
        finally:
            faults.set_plan(faults.FaultPlan(""))
        check(preempted is not None, "lm_resume R1 was not preempted")
        out["launches_R1"] = _check_flash_counts("R1", 7)
        ck3, ck6 = (tmp / "ckpt" / f"checkpoint-{n}" for n in (3, 6))
        check((ck3 / "accum.json").exists()
              and not (ck6 / "accum.json").exists(),
              "lm_resume: checkpoint 3 must hold the accumulator, 6 not")
        out["checkpoint_gib"] = _dir_gib(ck3)
        out["async_save_stall_s"] = r1_saves
        scalars = summary.read_scalar("Loss")
        check([s for _, _, s in scalars] == list(range(1, 7))
              and all(math.isfinite(v) for _, v, _ in scalars),
              f"lm_resume R1 summary Loss scalars {scalars}")
        out["summary_loss"] = [v for _, v, _ in scalars]
        summary.close()
        del o
        torch.cuda.empty_cache()

        # R2: a fresh model and Optimizer resume past the damage
        r2_saves, states, marks = [], [], {}

        def watch2(state):
            if not states:
                marks["first"] = time.perf_counter()
            states.append({k: state[k] for k in ("neval", "nupdates")})

        o = _lm_optimizer(samples, RESUME_MICRO, seed=1, watch=watch2)
        o.set_checkpoint(str(tmp / "ckpt"),
                         Trigger.several_iteration(RESUME_CKPT_EVERY)) \
            .resume_from_checkpoint()
        _timed_saves(o.checkpoint, r2_saves)
        _zero_flash_counts()
        t0 = time.perf_counter()
        o.optimize()
        out["launches_R2"] = _check_flash_counts("R2", RESUME_MICRO - 3)
        out["load_and_fast_forward_s"] = marks["first"] - t0
        out["sync_save_stall_s"] = r2_saves
        check(o.checkpoint.corrupt_skipped == [str(ck6)]
              and o.checkpoint._last_loaded == str(ck3),
              f"lm_resume R2 loaded {o.checkpoint._last_loaded}, skipped "
              f"{o.checkpoint.corrupt_skipped}")
        check(states[0] == {"neval": 3, "nupdates": 1}
              and states[-1] == {"neval": RESUME_MICRO,
                                 "nupdates": RESUME_MICRO // RESUME_ACCUM},
              f"lm_resume R2 clocks {states}")
        r2 = tree_leaves(o.model.variables["params"])
        differ = [i for i, (a, b) in enumerate(zip(tree_leaves(u_params),
                                                   r2))
                  if not torch.equal(a, b)]
        check(not differ, f"lm_resume: R2's params differ from U's in "
                          f"leaves {differ}")
        out["r2_equals_u"] = True
        out["checkpoint_gib_boundary"] = _dir_gib(ck6)  # R2's own save
        out["r2_states"] = [states[0], states[-1]]
        del o, u_params, runs
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the guard's cost: the trainer's configuration without accumulation,
    # unguarded and guarded (skip_step, no fault) in turns
    for name, guard in (("unguarded", None), ("guarded", "skip_step"),
                        ("guarded", "skip_step"), ("unguarded", None)):
        losses, marks = [], {}

        def watch3(state, losses=losses, marks=marks):
            if state["loss"] is not None:
                losses.append(state["loss"])
            if state["neval"] in (GUARD_WARMUP, GUARD_WARMUP + GUARD_STEPS):
                torch.cuda.synchronize()
                marks[state["neval"]] = time.perf_counter()

        o = _lm_optimizer(samples, GUARD_WARMUP + GUARD_STEPS, accum=1,
                          watch=watch3)
        if guard is not None:
            o.set_anomaly_guard(guard)
        o.optimize()
        check(all(math.isfinite(float(v)) for v in losses),
              f"lm_resume {name} losses")
        if guard is not None:
            check(o.anomaly_guard.anomalies == 0,
                  f"lm_resume: the guard saw {o.anomaly_guard.stats()}")
        out.setdefault(f"{name}_step_ms", []).append(
            (marks[GUARD_WARMUP + GUARD_STEPS] - marks[GUARD_WARMUP])
            / GUARD_STEPS * 1e3)
        del o
        torch.cuda.empty_cache()
    out["trainer_step_ms"] = RESULTS.get("trainer", {}).get("step_ms")
    emit("lm_resume", **out)


# ------------------------------------------------------ persistent LSTM
def _rnn_bound(n, t, h, ndir, itemsize, kind, cell="lstm"):
    """Least time for one launch's work: each input read once, each
    output written once; the recurrent products (2 flops a multiply-add:
    h . W forward; dz . W^T and h_prev^T . dz backward) at the fp32 SIMT
    peak, or the dense bf16 tensor-core peak for bf16. The backward
    writes one fp32 dW a direction, summed over the batch by its dW
    GEMM (the Pallas kernels wrote one partial a batch tile). A GRU
    (`cell="gru"`) has W_g (H, 2H) and W_c (H, H): 6 N T H^2 flops
    forward, 12 backward."""
    seq = n * t * h
    if cell == "gru":
        w = 3 * h * h
        if kind == "bwd":   # W_g, W_c, zr, cand, ys, dy in; dzg, dzc, dW out
            nbytes = ndir * ((w + 5 * seq + 3 * seq) * itemsize + w * 4)
            flops = ndir * 12 * n * t * h * h
        else:               # zg, zc, W in; ys (+ zr, cand training) out
            out = seq + (3 * seq if kind == "train" else 0)
            nbytes = ndir * (3 * seq + w + out) * itemsize
            flops = ndir * 6 * n * t * h * h
    elif kind == "bwd":  # W, ys, c, gates, dy in; dzx and one fp32 dW out
        seq4, w = 4 * seq, h * 4 * h
        nbytes = ndir * ((w + 3 * seq + seq4 + seq4) * itemsize + w * 4)
        flops = ndir * 2 * 2 * n * t * w
    else:               # zx, W in; ys (+ c, gates when training) out
        seq4, w = 4 * seq, h * 4 * h
        out = seq + (seq + seq4 if kind == "train" else 0)
        nbytes = ndir * (seq4 + w + out) * itemsize
        flops = ndir * 2 * n * t * w
    peak = FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _rnn_inputs(n, t, h, ndir, dtype, seed):
    import torch

    # the scales the models give: W_hh the recurrent half of an LSTM
    # cell's Xavier-uniform (D + H, 4H) weight with D = H, zx = x . W_x
    # of unit-variance inputs (std sqrt(D) times W's)
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = (6.0 / (6 * h)) ** 0.5
    zxs = [(torch.randn(n, t, 4 * h, device="cuda", generator=g)
            * (h / 3) ** 0.5 * a).to(dtype) for _ in range(ndir)]
    ws = [((torch.rand(h, 4 * h, device="cuda", generator=g) * 2 - 1) * a)
          .to(dtype) for _ in range(ndir)]
    dys = [torch.randn(n, t, h, device="cuda", generator=g).to(dtype)
           for _ in range(ndir)]
    return zxs, ws, dys, [d == 1 for d in range(ndir)]


def phase_rnn(flush):
    """The persistent-LSTM kernels against their plain versions on every
    case of RNN_CASES, fp32 and bf16: forward (training variant: ys, c,
    gates; the inference variant's ys bitwise the training variant's)
    and backward (dzx, and dW summed over the batch) from the kernel's
    own residuals; two backward runs bitwise equal; in bf16 element by
    element against the plain versions that round where the kernels
    round, with the unrounded control, and bf16 dW against the plain
    backward's dW; times at RNN_TIMED (kernel, plain, cuDNN's
    torch.nn.LSTM as the library yardstick)."""
    import torch

    from bigdl_tpu_torch.ops import fused_rnn as fr

    out = {}
    for name, n, t, h, ndir in RNN_CASES:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            where = f"rnn {name} {dname}"
            zxs, ws, dys, revs = _rnn_inputs(n, t, h, ndir, dtype,
                                             n * 31 + t + h)
            res = fr.lstm_fwd_cuda(zxs, ws, revs, save=True)
            infer = fr.lstm_fwd_cuda(zxs, ws, revs, save=False)
            dzx, dw = fr.lstm_bwd_cuda(ws, res, dys, revs)
            dzx2, dw2 = fr.lstm_bwd_cuda(ws, res, dys, revs)
            torch.cuda.synchronize()
            plain_f = [fr.lstm_forward_reference(z, w, r)
                       for z, w, r in zip(zxs, ws, revs)]
            plain_b = [fr.lstm_backward_reference(w, *rk, dy, r)
                       for w, rk, dy, r in zip(ws, res, dys, revs)]
            check(all(bool(torch.isfinite(x).all()) for r in res for x in r)
                  and all(bool(torch.isfinite(x).all())
                          for x in (*dzx, *dw)), f"{where}: not finite")
            check(all(torch.equal(a[0], b[0]) for a, b in zip(res, infer)),
                  f"{where}: inference ys differ from the training ys")
            check(all(torch.equal(a, b) for a, b in zip(dzx, dzx2))
                  and all(torch.equal(a, b) for a, b in zip(dw2, dw)),
                  f"{where}: two backward runs differ")
            r = {
                "fwd_max_abs_err": max(float((a.float() - b.float()).abs()
                                             .max())
                                       for rk, rp in zip(res, plain_f)
                                       for a, b in zip(rk, rp)),
                "grad_rel_err": {
                    "dzx": max(_rel_err(a, b[0])
                               for a, b in zip(dzx, plain_b)),
                    "dw": max(_rel_err(a, b[1])
                              for a, b in zip(dw, plain_b))},
                "grad_max_abs_err": max(
                    max(float((a.float() - b[0].float()).abs().max()),
                        float((c - b[1]).abs().max()))
                    for a, c, b in zip(dzx, dw, plain_b)),
            }
            if dname == "fp32":
                check(r["fwd_max_abs_err"] <= RNN_TOL["fwd"],
                      f"{where}: forward err {r['fwd_max_abs_err']}")
                for k, e in r["grad_rel_err"].items():
                    check(e <= RNN_TOL["grad"], f"{where}: {k} rel err {e}")
            else:
                r["rounding"] = _rnn_rounding(fr, where, zxs, ws, dys, revs,
                                              res, dzx, dw, gate=t > 1)
            if name in RNN_TIMED:
                r.update(_rnn_times(fr, flush, zxs, ws, dys, revs, res))
                for kind in ("train", "infer", "bwd"):
                    r[f"{kind}_bound"] = _rnn_bound(n, t, h, ndir,
                                                    zxs[0].element_size(),
                                                    kind)
            out[f"{name}/{dname}"] = r
            del zxs, ws, dys, res, infer, dzx, dw, dzx2, dw2, plain_f, \
                plain_b
    torch.cuda.empty_cache()
    summary = {key: {k: v for k, v in r.items()
                     if k not in ("rounding",) and not k.endswith("_bound")}
               for key, r in out.items()}
    for key, r in out.items():
        if "rounding" in r:
            summary[key]["rounding"] = {
                label: {st: max(x[st] for x in r["rounding"][label]
                                .values()) for st in ("max_ulps",
                                                      "mismatch")}
                for label in ("matched", "control")}
            summary[key]["dw_rel_err"] = r["rounding"]["dw_rel_err"]
    emit("rnn", cases={c[0]: dict(zip(("N", "T", "H", "dirs"), c[1:]))
                       for c in RNN_CASES},
         tolerance=RNN_TOL, block_n=fr.BLOCK_N, bitwise_backward=True,
         bf16_rounding_tolerance={"max_ulps": BF16_ULP_TOL,
                                  "mismatch": BF16_MISMATCH_TOL},
         bf16_dw_rel_tolerance=RNN_BF16_DW_TOL,
         summary=summary)
    RESULTS["rnn_detail"] = out
    return out


def _dw_of(dzx, ys, reverse):
    """dW = sum over (row, t) of h_prev^T . dz in fp32, from given dz and
    the stored h sequence (h_prev zero at the direction's first step)."""
    import torch

    hp = torch.zeros_like(ys, dtype=torch.float32)
    if reverse:
        hp[:, :-1] = ys[:, 1:].float()
    else:
        hp[:, 1:] = ys[:, :-1].float()
    return torch.einsum("ntk,ntj->kj", hp, dzx.float())


def _rnn_rounding(fr, where, zxs, ws, dys, revs, res, dzx, dw, gate):
    """bf16 kernel outputs against the plain versions with the kernels'
    roundings ("matched") and without them ("control"); the backward's
    references start from the kernel's residuals. dW sums N x T products,
    so the one-ulp dz flips that the dh recurrence carries (within the
    dzx limit) move it by more than summation order does: it is held to
    the plain product of the kernel's own dzx instead, rounded once; and
    as a whole, relative to its max, to the plain backward's dW
    (RNN_BF16_DW_TOL; the control's reading is reported beside it)."""
    out, dw_rel = {}, {}
    for label, rounded in (("matched", True), ("control", False)):
        st = {}
        for d, (z, w, dy, rev) in enumerate(zip(zxs, ws, dys, revs)):
            pf = fr.lstm_forward_reference(z, w, rev,
                                           round_operands=rounded)
            pdz, pdw_ref = fr.lstm_backward_reference(
                w, *res[d], dy, rev, round_operands=rounded)
            pdw = _dw_of(dzx[d] if rounded else pdz, res[d][0], rev)
            for nm, a, b in zip(("ys", "c", "gates", "dzx", "dw"),
                                (*res[d], dzx[d], dw[d].to(w.dtype)),
                                (*pf, pdz, pdw)):
                st[f"{nm}{d}"] = _ulp_stats(a, b)
            dw_rel[label] = max(dw_rel.get(label, 0.0),
                                _rel_err(dw[d], pdw_ref))
        out[label] = st
    out["dw_rel_err"] = dw_rel
    check(dw_rel["matched"] <= RNN_BF16_DW_TOL,
          f"{where}: dW {dw_rel['matched']} relative from the plain "
          f"backward's dW")
    for nm, s in out["matched"].items():
        check(s["max_ulps"] <= BF16_ULP_TOL,
              f"{where}: {nm} {s['max_ulps']} bf16 ulps from the plain "
              "version with the kernel's roundings")
        check(s["mismatch"] <= BF16_MISMATCH_TOL,
              f"{where}: {nm} differs from the plain version with the "
              f"kernel's roundings in a share {s['mismatch']}")
    if gate:
        for names in (("ys",), ("dzx",)):
            worst = max(s["mismatch"] for nm, s in out["control"].items()
                        if nm.rstrip("01") in names)
            check(worst > BF16_MISMATCH_TOL,
                  f"{where}: the control without the kernel's roundings "
                  f"passes the mismatch limit ({names}: {worst})")
    return out


def _rnn_times(fr, flush, zxs, ws, dys, revs, res):
    """Kernel and plain times at a timed case, and cuDNN's LSTM over the
    same batch (its input projection included) as the yardstick."""
    import torch

    reps = dict(reps=10, warmup=2)
    times = {
        "fwd_ms": cuda_ms(lambda: fr.lstm_fwd_cuda(zxs, ws, revs, True),
                          flush, **reps),
        "infer_ms": cuda_ms(lambda: fr.lstm_fwd_cuda(zxs, ws, revs, False),
                            flush, **reps),
        "bwd_ms": cuda_ms(lambda: fr.lstm_bwd_cuda(ws, res, dys, revs),
                          flush, **reps),
        "plain_fwd_ms": cuda_ms(lambda: [fr.lstm_forward_reference(z, w, r)
                                         for z, w, r in zip(zxs, ws, revs)],
                                flush, reps=5, warmup=1),
        "plain_bwd_ms": cuda_ms(
            lambda: [fr.lstm_backward_reference(w, *rk, dy, r)
                     for w, rk, dy, r in zip(ws, res, dys, revs)],
            flush, reps=5, warmup=1),
    }
    n, t, h4 = zxs[0].shape
    h = h4 // 4
    lib = {}
    for dtype in dict.fromkeys((zxs[0].dtype, torch.float32)):
        name = str(dtype).replace("torch.", "")
        try:        # yardstick only, never called by the port
            lstm = torch.nn.LSTM(h, h, batch_first=True,
                                 bidirectional=len(zxs) == 2).cuda().to(
                                     dtype)
            lstm.flatten_parameters()
            x = torch.randn(n, t, h, device="cuda", dtype=dtype,
                            requires_grad=True)
            y, _ = lstm(x)
            dy = torch.randn_like(y)
            params = [x, *lstm.parameters()]
            torch.autograd.grad(y, params, dy, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError as err:   # cuDNN without this dtype
            lib[name] = {"refused": str(err)[:120]}
            continue

        def fwd_bwd():
            yy, _ = lstm(x)
            torch.autograd.grad(yy, params, dy)

        lib[name] = {"fwd_ms": cuda_ms(lambda: lstm(x), flush, **reps),
                     "bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                         y, params, dy, retain_graph=True), flush, **reps),
                     "fwd_bwd_ms": cuda_ms(fwd_bwd, flush, **reps),
                     "kernels": _device_kernels(fwd_bwd)}
        lib[name]["runs"] = _lstm_library_label(lib[name]["kernels"])
    same = lib.get(str(zxs[0].dtype).replace("torch.", ""), {})
    times.update({f"cudnn_{k}_ms": same.get(f"{k}_ms")
                  for k in ("fwd", "bwd", "fwd_bwd")})
    times["library"] = lib
    return times


def _device_kernels(fn) -> list:
    """The CUDA kernels one call of `fn` launches, from a torch.profiler
    pass (a second one if the first saw none, as a process that profiled
    before sometimes does): name (cut to 90 characters), launches, device
    us; the largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        if rows:
            break
    return [{"name": k[:90], "calls": c, "us": us} for us, c, k in rows]


def _lstm_library_label(kernels) -> str:
    """What torch.nn.LSTM ran, from its kernels' names: cuDNN's
    persistent RNN kernel, cuDNN's per-step path (a gemm and an
    element-wise cell kernel each step), or ATen's fallback (a gemm and
    the fused LSTM cell kernel each step)."""
    names = " ".join(k["name"] for k in kernels)
    if not names:
        return "not measured: the profiler saw no kernel"
    if "lstm_cell" in names:
        return "ATen per-step fallback (gemm + lstm_cell kernels each step)"
    if "RNN_blockPersist" in names:
        return "cuDNN persistent RNN kernels"
    if "elemWiseRNNcell" in names or "LSTM_elementWise" in names:
        return "cuDNN per-step path (gemm + element-wise cell each step)"
    return "not recognised: see the kernel names"


def _rnn_model(key, impl):
    """The full-width BiLSTM classifier ("bilstm") or the 2-layer LSTM
    LM ("lstm_lm") on the card, recurrences forced to `impl` ("cuda" or
    "torch")."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import rnn

    if key == "bilstm":
        return rnn.bilstm_sentiment(RNN_VOCAB, RNN_EMBED, RNN_HIDDEN,
                                    fused=impl)
    lm = rnn.lstm_lm(LM_VOCAB, RNN_EMBED, RNN_HIDDEN, num_layers=LM_LAYERS)
    for layer in lm:
        if isinstance(layer, nn.Recurrent):
            layer.fused = impl
    return lm


def phase_rnn_model():
    """One fp32 loss-and-grad step of the full-width BiLSTM classifier
    (batch 128 x 128) and of the 2-layer LSTM LM (batch 32 x 64) through
    the kernels against the same step through the plain versions, from
    the same params and batch."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import (tree_leaves,
                                                tree_leaves_with_path,
                                                tree_map)
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import FULL_PRECISION

    rng = np.random.RandomState(3)
    batches = {
        "bilstm": (rng.randint(0, RNN_VOCAB, (RNN_BATCH, RNN_SEQ)),
                   rng.randint(0, 2, RNN_BATCH)),
        "lstm_lm": (rng.randint(0, LM_VOCAB, (LM_BATCH, LM_SEQ)),
                    rng.randint(0, LM_VOCAB, (LM_BATCH, LM_SEQ)))}
    crits = {"bilstm": nn.ClassNLLCriterion(),
             "lstm_lm": nn.TimeDistributedCriterion(
                 nn.ClassNLLCriterion(), size_average=True)}
    report = {}
    for key in ("bilstm", "lstm_lm"):
        x, y = (torch.as_tensor(a.astype(np.int32)).cuda()
                for a in batches[key])
        params, out = None, {}
        for impl in ("cuda", "torch"):
            model = _rnn_model(key, impl)
            if params is None:
                params = model.init(torch.Generator().manual_seed(0))[
                    "params"]
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss_call = build_train_loss(model, crits[key], FULL_PRECISION)
            counts0 = (fr.fwd_train_launches, fr.bwd_launches)
            loss, _ = loss_call(p, model.init_state(), x, y, None)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
            out[impl] = (float(loss.detach()), grads,
                         (fr.fwd_train_launches - counts0[0],
                          fr.bwd_launches - counts0[1]))
        dloss = abs(out["cuda"][0] - out["torch"][0])
        top = max(float(b.abs().max()) for b in out["torch"][1])
        rels = {".".join(map(str, path)): float((a - b).abs().max()) / max(
            float(b.abs().max()), TRAIN_GRAD_FLOOR * top)
            for (path, _), a, b in zip(tree_leaves_with_path(params),
                                       out["cuda"][1], out["torch"][1])}
        rel = max(rels.values())
        where = f"rnn_model {key}"
        launches = 1 if key == "bilstm" else LM_LAYERS
        check(math.isfinite(out["cuda"][0]), f"{where}: loss not finite")
        check(dloss <= TRAIN_LOSS_TOL, f"{where}: |dloss| {dloss}")
        check(rel <= TRAIN_GRAD_TOL, f"{where}: grad rel diff {rel}")
        check(out["cuda"][2] == (launches, launches),
              f"{where}: the kernel step launched {out['cuda'][2]}")
        check(out["torch"][2] == (0, 0), f"{where}: the plain step launched "
              "kernels")
        report[key] = dict(
            loss_cuda=out["cuda"][0], loss_torch=out["torch"][0],
            loss_abs_diff=dloss, grad_max_rel_diff=rel,
            grad_rel_diff_by_leaf=rels,
            launches={"fwd": out["cuda"][2][0], "bwd": out["cuda"][2][1]},
            params=int(sum(t.numel() for t in tree_leaves(params))))
        del params, out
        torch.cuda.empty_cache()
    emit("rnn_model", tolerance={"loss": TRAIN_LOSS_TOL,
                                 "grad_rel": TRAIN_GRAD_TOL},
         grad_floor=TRAIN_GRAD_FLOOR,
         shapes={"bilstm": [RNN_BATCH, RNN_SEQ], "lstm_lm": [LM_BATCH,
                                                             LM_SEQ]},
         **report)


def _sentiment_samples(n, seed):
    """Learnable sentiment data in the style of models/train.py: class y
    draws its RNN_SEQ tokens from its own block of SENTIMENT_TOKENS ids
    (of the full vocabulary), so a few steps already separate them."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.RandomState(seed)
    k = SENTIMENT_TOKENS
    return [Sample(rng.randint(y * k, (y + 1) * k,
                               RNN_SEQ).astype(np.int32), np.int32(y))
            for y in rng.randint(0, 2, n)]


def _rnn_trainer(model, samples, criterion, batch, steps, watch):
    """Optimizer(...).optimize() with Adam(1e-3) in bf16 for `steps`
    steps; `watch(train_state)` sees the state before every step."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    stop = Trigger.max_iteration(steps)

    def end_when(state):
        watch(state)
        return stop(state)

    Optimizer(model, DataSet.array(samples), criterion,
              batch_size=batch).set_optim_method(Adam(1e-3)) \
        .set_precision("bf16").set_end_when(Trigger(end_when)).optimize()
    return model


def _timed_watch(losses, marks, warmup, steps, counters):
    """A watch that zeroes the kernels' counts after `warmup` steps and
    reads them after `steps` more (the main path's window)."""
    import torch

    from bigdl_tpu_torch.ops import fused_rnn as fr

    def on_step(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:                  # main path starts here
                setattr(fr, c, 0)
            marks["t0"] = time.perf_counter()
        elif state["neval"] == warmup + steps:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = {c: getattr(fr, c)   # main path ends here
                                 for c in counters}
    return on_step


def phase_rnn_trainer():
    """The slice's main path: the BiLSTM classifier (BASELINE config 4)
    trained through Optimizer(...).optimize() at the bench shape for
    TRAIN_WARMUP + TRAIN_STEPS steps, launches counted over the timed
    steps; then an inference pass over RNN_INFER_BATCHES batches under
    torch.no_grad() (the no-residual kernel); then the 2-layer LSTM LM
    through the same loop (one direction: the K6/K7 launches)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import rnn
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    counters = ("fwd_train_launches", "fwd_infer_launches", "bwd_launches")
    losses, marks = [], {}
    model = rnn.bilstm_sentiment(RNN_VOCAB, RNN_EMBED, RNN_HIDDEN)
    model.build(torch.Generator().manual_seed(0))
    steps = TRAIN_WARMUP + TRAIN_STEPS
    _rnn_trainer(model, _sentiment_samples(RNN_BATCH * steps, 11),
                 nn.ClassNLLCriterion(), RNN_BATCH, steps,
                 _timed_watch(losses, marks, TRAIN_WARMUP, TRAIN_STEPS,
                              counters))
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"]
    launches = marks["launches"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"rnn trainer losses not all finite: {losses}")
    check(losses[-1] < losses[0], f"rnn trainer loss did not fall: {losses}")
    check(launches["fwd_train_launches"] == TRAIN_STEPS
          and launches["bwd_launches"] == TRAIN_STEPS
          and launches["fwd_infer_launches"] == 0,
          f"rnn trainer launches {launches} != {TRAIN_STEPS} forward and "
          f"{TRAIN_STEPS} backward")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # inference: the trained weights in the compute dtype, no autograd
    variables = DEFAULT_MIXED.cast_to_compute(model.variables)
    held_out = _sentiment_samples(RNN_BATCH * RNN_INFER_BATCHES, 12)
    correct = 0
    torch.cuda.synchronize()
    fr.fwd_infer_launches = fr.fwd_train_launches = 0   # inference path
    t_inf = time.perf_counter()
    with torch.no_grad():
        for b in range(RNN_INFER_BATCHES):
            chunk = held_out[b * RNN_BATCH:(b + 1) * RNN_BATCH]
            x = torch.as_tensor(np.stack([s.feature for s in chunk])).cuda()
            y = torch.as_tensor(np.stack([s.label for s in chunk])).cuda()
            logp, _ = model.apply(variables, x)
            correct += int((logp.argmax(-1) == y.long()).sum())
    torch.cuda.synchronize()
    t_inf = time.perf_counter() - t_inf
    infer = (fr.fwd_infer_launches, fr.fwd_train_launches)  # path ends
    check(infer == (RNN_INFER_BATCHES, 0),
          f"inference launches (infer, train) {infer} != "
          f"({RNN_INFER_BATCHES}, 0)")
    accuracy = correct / (RNN_BATCH * RNN_INFER_BATCHES)

    # the LSTM LM: one direction per layer
    lm_losses, lm_marks = [], {}
    lm = rnn.lstm_lm(LM_VOCAB, RNN_EMBED, RNN_HIDDEN, num_layers=LM_LAYERS)
    lm.build(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(13)
    from bigdl_tpu_torch.dataset.sample import Sample

    period = rng.randint(0, LM_VOCAB, 16)         # a learnable sequence
    lm_samples = []
    for _ in range(LM_BATCH * (LM_WARMUP + LM_STEPS)):
        s = rng.randint(0, 16)
        toks = period[(s + np.arange(LM_SEQ + 1)) % 16].astype(np.int32)
        lm_samples.append(Sample(toks[:-1], toks[1:]))
    _rnn_trainer(lm, lm_samples, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), LM_BATCH,
        LM_WARMUP + LM_STEPS,
        _timed_watch(lm_losses, lm_marks, LM_WARMUP, LM_STEPS, counters))
    lm_losses = [float(v) for v in lm_losses]
    lm_launches = lm_marks["launches"]
    check(all(math.isfinite(v) for v in lm_losses)
          and lm_losses[-1] < lm_losses[0],
          f"LM trainer losses not finite and falling: {lm_losses}")
    check(lm_launches["fwd_train_launches"] == LM_STEPS * LM_LAYERS
          and lm_launches["bwd_launches"] == LM_STEPS * LM_LAYERS,
          f"LM trainer launches {lm_launches} != {LM_STEPS} steps x "
          f"{LM_LAYERS} layers")
    lm_dt = lm_marks["t1"] - lm_marks["t0"]
    emit("rnn_trainer", steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
         batch=RNN_BATCH, seq=RNN_SEQ, seconds=dt,
         step_ms=dt / TRAIN_STEPS * 1e3,
         samples_per_sec=TRAIN_STEPS * RNN_BATCH / dt,
         tokens_per_sec=TRAIN_STEPS * RNN_BATCH * RNN_SEQ / dt,
         peak_mem_gib=peak, launches=launches, losses=losses,
         infer={"batches": RNN_INFER_BATCHES, "seconds": t_inf,
                "ms_per_batch": t_inf / RNN_INFER_BATCHES * 1e3,
                "launches": infer[0], "accuracy": accuracy},
         lm={"steps": LM_STEPS, "batch": LM_BATCH, "seq": LM_SEQ,
             "layers": LM_LAYERS, "step_ms": lm_dt / LM_STEPS * 1e3,
             "tokens_per_sec": LM_STEPS * LM_BATCH * LM_SEQ / lm_dt,
             "launches": lm_launches, "losses": lm_losses})
    return {"bi": launches, "infer": infer[0], "uni": lm_launches}


def phase_rnn_profile():
    """Where one BiLSTM trainer step's device time goes (`--profile`
    only): the step after two warm-up steps under torch.profiler; the
    LSTM kernels' share of the device time (the dW GEMM, rnn_dw_kernel,
    included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import rnn

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    marks = {}

    def on_step(state):
        if state["neval"] == 2:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif state["neval"] == 3:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.stop()

    model = rnn.bilstm_sentiment(RNN_VOCAB, RNN_EMBED, RNN_HIDDEN)
    model.build(torch.Generator().manual_seed(0))
    _rnn_trainer(model, _sentiment_samples(RNN_BATCH * 3, 14),
                 nn.ClassNLLCriterion(), RNN_BATCH, 3, on_step)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "rnn_train_trace.json"))
    if not rows:
        emit("rnn_profile", device_ms_per_step="not measured")
        return
    dev_ms = sum(r[0] for r in rows) / 1e3
    lstm_ms = sum(r[0] for r in rows
                  if "lstm_" in r[2] or "rnn_dw_" in r[2]) / 1e3
    wall_ms = (marks["t1"] - marks["t0"]) * 1e3
    emit("rnn_profile", steps=1, profiled_wall_ms_per_step=wall_ms,
         device_ms_per_step=dev_ms, lstm_kernels_ms_per_step=lstm_ms,
         lstm_share_of_device=lstm_ms / dev_ms,
         device_busy_share=dev_ms / wall_ms,
         kernels_per_step=sum(r[1] for r in rows),
         top=[{"name": k[:80], "calls": c, "ms": us / 1e3}
              for us, c, k in rows[:12]])


# ------------------------------------------------------- persistent GRU
def _gru_inputs(n, t, h, dtype, seed):
    import torch

    # the scales the models give: W_g / W_c the recurrent halves of a GRU
    # cell's Xavier-uniform (D + H, 2H) / (D + H, H) weights with D = H,
    # zg / zc = x . W_x of unit-variance inputs (std sqrt(D) times W's)
    g = torch.Generator(device="cuda").manual_seed(seed)
    a_g, a_c = (6.0 / (4 * h)) ** 0.5, (6.0 / (3 * h)) ** 0.5
    zg = (torch.randn(n, t, 2 * h, device="cuda", generator=g)
          * (h / 3) ** 0.5 * a_g).to(dtype)
    zc = (torch.randn(n, t, h, device="cuda", generator=g)
          * (h / 3) ** 0.5 * a_c).to(dtype)
    wg = ((torch.rand(h, 2 * h, device="cuda", generator=g) * 2 - 1)
          * a_g).to(dtype)
    wc = ((torch.rand(h, h, device="cuda", generator=g) * 2 - 1)
          * a_c).to(dtype)
    dy = torch.randn(n, t, h, device="cuda", generator=g).to(dtype)
    return zg, zc, wg, wc, dy


def phase_gru(flush):
    """The persistent-GRU kernels against their plain versions on every
    case of GRU_CASES, fp32 and bf16: forward (training variant: ys, zr,
    cand; the inference variant's ys bitwise the training variant's) and
    backward (dzg, dzc, dW_g and dW_c, which the kernels sum) from the
    kernel's own residuals; two backward runs bitwise equal; in bf16
    element by element against the plain versions that round where the
    kernels round, with the unrounded control, and bf16 dW against the
    plain backward's dW; kernel and plain times at GRU_TIMED."""
    import torch

    from bigdl_tpu_torch.ops import fused_rnn as fr

    out = {}
    for name, n, t, h in GRU_CASES:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            where = f"gru {name} {dname}"
            zg, zc, wg, wc, dy = _gru_inputs(n, t, h, dtype,
                                             n * 37 + t + h)
            res = fr.gru_fwd_cuda(zg, zc, wg, wc, save=True)
            infer = fr.gru_fwd_cuda(zg, zc, wg, wc, save=False)
            grads = fr.gru_bwd_cuda(wg, wc, *res, dy)
            again = fr.gru_bwd_cuda(wg, wc, *res, dy)
            torch.cuda.synchronize()
            check(torch.equal(res[0], infer[0]),
                  f"{where}: inference ys differ from the training ys")
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"{where}: two backward runs differ")
            dzg, dzc, dwg, dwc = grads
            check(all(bool(torch.isfinite(x).all())
                      for x in (*res, dzg, dzc, dwg, dwc)),
                  f"{where}: not finite")
            pf = fr.gru_forward_reference(zg, zc, wg, wc)
            pb = fr.gru_backward_reference(wg, wc, *res, dy)
            r = {
                "fwd_max_abs_err": max(float((a.float() - b.float()).abs()
                                             .max())
                                       for a, b in zip(res, pf)),
                "grad_rel_err": {k: _rel_err(a, b) for k, a, b in zip(
                    ("dzg", "dzc", "dwg", "dwc"), (dzg, dzc, dwg, dwc), pb)},
                "grad_max_abs_err": max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip((dzg, dzc, dwg, dwc), pb)),
            }
            if dname == "fp32":
                check(r["fwd_max_abs_err"] <= RNN_TOL["fwd"],
                      f"{where}: forward err {r['fwd_max_abs_err']}")
                for k, e in r["grad_rel_err"].items():
                    check(e <= RNN_TOL["grad"], f"{where}: {k} rel err {e}")
            else:
                r["rounding"] = _gru_rounding(fr, where, zg, zc, wg, wc, dy,
                                              res, grads, gate=t > 1)
            if name in GRU_TIMED:
                r.update(_gru_times(fr, flush, zg, zc, wg, wc, dy, res))
                for kind in ("train", "infer", "bwd"):
                    r[f"{kind}_bound"] = _rnn_bound(n, t, h, 1,
                                                    zg.element_size(), kind,
                                                    cell="gru")
            out[f"{name}/{dname}"] = r
            del zg, zc, wg, wc, dy, res, infer, grads, again, pf, pb
    torch.cuda.empty_cache()
    summary = {key: {k: v for k, v in r.items()
                     if k != "rounding" and not k.endswith("_bound")}
               for key, r in out.items()}
    for key, r in out.items():
        if "rounding" in r:
            summary[key]["rounding"] = {
                label: {st: max(x[st] for x in r["rounding"][label]
                                .values()) for st in ("max_ulps",
                                                      "mismatch")}
                for label in ("matched", "control", "free_running",
                              "fp64_kernel", "fp64_plain")}
            summary[key]["dw_rel_err"] = r["rounding"]["dw_rel_err"]
    emit("gru", cases={c[0]: dict(zip(("N", "T", "H"), c[1:]))
                       for c in GRU_CASES},
         tolerance=RNN_TOL, block_n=fr.BLOCK_N, bitwise_backward=True,
         bf16_rounding_tolerance={"max_ulps": BF16_ULP_TOL,
                                  "mismatch": BF16_MISMATCH_TOL},
         bf16_dw_rel_tolerance=RNN_BF16_DW_TOL,
         gru_bf16_free_mismatch_tolerance=GRU_BF16_FREE_MISMATCH_TOL,
         summary=summary)
    RESULTS["gru_detail"] = out
    return out


def _gru_dw_of(dzg, dzc, ys, zr, rounded=True):
    """(dW_g, dW_c) = sums over (row, t) of h_prev^T . dzg and (r
    h_prev)^T . dzc in fp32 (r h_prev rounded to ys' dtype when
    `rounded`), from given dzg / dzc and the stored sequences (h_prev
    zero at t = 0)."""
    import torch

    h = ys.shape[-1]
    hp = torch.zeros_like(ys, dtype=torch.float32)
    hp[:, 1:] = ys[:, :-1].float()
    rh = zr[..., h:].float() * hp
    if rounded:
        rh = rh.to(ys.dtype).float()
    return (torch.einsum("ntk,ntj->kj", hp, dzg.float()),
            torch.einsum("ntk,ntj->kj", rh, dzc.float()))


def _gru_fwd_plain(zg, zc, wg, wc, ys_k=None, acc=None):
    """gru_forward_reference's arithmetic with the products and the carry
    in `acc` (fp32 by default), returning (ys, zr, cand) in `acc`. With
    `ys_k`, the kernel's stored ys, the operand of h . W_g is taken from
    it — that operand exactly, h rounded to the weights' dtype — so a
    one-ulp difference in a stored h is not carried on by the
    reference's own recurrence; the carry and r * h stay the
    reference's."""
    import torch

    acc = acc or torch.float32
    n, n_t, h2 = zg.shape
    h = h2 // 2
    wga, wca = wg.to(acc), wc.to(acc)
    carry = torch.zeros(n, h, device=zg.device, dtype=acc)
    out = [torch.empty(n, n_t, k, device=zg.device, dtype=acc)
           for k in (h, h2, h)]
    for t in range(n_t):
        if ys_k is None:
            op = carry.to(wg.dtype).to(acc)
        else:
            op = ys_k[:, t - 1].to(acc) if t > 0 else torch.zeros_like(carry)
        zr = torch.sigmoid(zg[:, t].to(acc) + op @ wga)
        z, r = zr[:, :h], zr[:, h:]
        cand = torch.tanh(zc[:, t].to(acc)
                          + (r * carry).to(wc.dtype).to(acc) @ wca)
        carry = (1.0 - z) * carry + z * cand
        for seq, v in zip(out, (carry, zr, cand)):
            seq[:, t] = v
    return out


def _gru_bwd_plain(wg, wc, ys, zr, cand, dy, carried=None, acc=None):
    """gru_backward_reference's (dzg, dzc) with the products and the dh
    carry in `acc` (fp32 by default), returned in `acc`. With `carried`,
    the kernel's own stored (dzg, dzc), each step's drh and dh carry take
    the kernel's rounded dzr and dcand_pre, so a one-ulp difference in a
    stored value is not carried on by the reference's own sweep and
    every step is held to its own arithmetic."""
    import torch

    acc = acc or torch.float32
    n, n_t, h2 = zr.shape
    h = h2 // 2
    wga, wca = wg.to(acc), wc.to(acc)
    dh_carry = torch.zeros(n, h, device=zr.device, dtype=acc)
    dzg = torch.empty(n, n_t, h2, device=zr.device, dtype=acc)
    dzc = torch.empty(n, n_t, h, device=zr.device, dtype=acc)
    for t in reversed(range(n_t)):
        z, r = zr[:, t, :h].to(acc), zr[:, t, h:].to(acc)
        c = cand[:, t].to(acc)
        hp = ys[:, t - 1].to(acc) if t > 0 else torch.zeros_like(c)
        dh = dy[:, t].to(acc) + dh_carry
        dzc[:, t] = dh * z * (1.0 - c * c)
        dcn = dzc[:, t] if carried is None else carried[1][:, t]
        drh = dcn.to(wc.dtype).to(acc) @ wca.T
        dzg[:, t] = torch.cat([dh * (c - hp) * z * (1.0 - z),
                               drh * hp * r * (1.0 - r)], -1)
        dzr = dzg[:, t] if carried is None else carried[0][:, t]
        dh_carry = dh * (1.0 - z) + drh * r + dzr.to(wg.dtype).to(acc) @ wga.T
    return dzg, dzc


def _gru_rounding(fr, where, zg, zc, wg, wc, dy, res, grads, gate):
    """bf16 kernel outputs against the plain versions with the kernels'
    roundings and without them ("control"); the backward's references
    start from the kernel's residuals. Three matched references:
    "matched", whose carried products take the kernel's own stored
    outputs (the stored ys as the operand of h . W_g; the stored dzc /
    dzg in drh and the dh carry), so each step is held to its own
    arithmetic at the flash phase's limits (BF16_ULP_TOL,
    BF16_MISMATCH_TOL); "free_running", gru_forward_reference /
    gru_backward_reference carrying their own state, and "fp64_kernel",
    the same arithmetic summed in fp64, both held to
    GRU_BF16_FREE_MISMATCH_TOL ("fp64_plain", the fp32 plain versions
    against the fp64 ones, is reported: how far summation alone moves two
    sound versions). Each dW is held element by element to the plain
    product of the kernel's own dzg / dzc, rounded once, and as a whole,
    relative to its max, to the dW of the kernel-driven and of the
    free-running plain backward (RNN_BF16_DW_TOL; the control's reading
    is reported beside them)."""
    import torch

    dws = grads[2:]
    pf = fr.gru_forward_reference(zg, zc, wg, wc)
    pb = fr.gru_backward_reference(wg, wc, *res, dy)
    forced_f = _gru_fwd_plain(zg, zc, wg, wc, ys_k=res[0])
    forced = _gru_bwd_plain(wg, wc, *res, dy, carried=grads[:2])
    f64 = torch.float64
    exact = (*_gru_fwd_plain(zg, zc, wg, wc, acc=f64),
             *_gru_bwd_plain(wg, wc, *res, dy, acc=f64))
    cf = fr.gru_forward_reference(zg, zc, wg, wc, round_operands=False)
    cb = fr.gru_backward_reference(wg, wc, *res, dy, round_operands=False)
    names = ("ys", "zr", "cand", "dzg", "dzc", "dwg", "dwc")
    got = (*res, *grads[:2], *(d.to(wg.dtype) for d in dws))
    out = {
        "matched": {nm: _ulp_stats(a, b) for nm, a, b in zip(
            names, got, (*forced_f, *forced,
                         *_gru_dw_of(*grads[:2], res[0], res[1])))},
        "free_running": {nm: _ulp_stats(a, b) for nm, a, b in zip(
            names[:5], got[:5], (*pf, *pb[:2]))},
        "fp64_kernel": {nm: _ulp_stats(a, b) for nm, a, b in zip(
            names[:5], got[:5], exact)},
        "fp64_plain": {nm: _ulp_stats(a, b) for nm, a, b in zip(
            names[:5], (*pf, *pb[:2]), exact)},
        "control": {nm: _ulp_stats(a, b) for nm, a, b in zip(
            names, got, (*cf, *cb[:2], *_gru_dw_of(
                *cb[:2], res[0], res[1], rounded=False)))},
    }
    forced_dw = _gru_dw_of(*(d.to(wg.dtype) for d in forced),
                           res[0], res[1])
    dw_rel = {label: max(_rel_err(a, b) for a, b in zip(dws, ref))
              for label, ref in (("matched", forced_dw),
                                 ("free_running", pb[2:]),
                                 ("control", cb[2:]))}
    out["dw_rel_err"] = dw_rel
    for label in ("matched", "free_running"):
        check(dw_rel[label] <= RNN_BF16_DW_TOL,
              f"{where}: dW {dw_rel[label]} relative from the dW of the "
              f"{label} plain backward")
    for nm, s in out["matched"].items():
        check(s["max_ulps"] <= BF16_ULP_TOL,
              f"{where}: {nm} {s['max_ulps']} bf16 ulps from the plain "
              "version with the kernel's roundings")
        check(s["mismatch"] <= BF16_MISMATCH_TOL,
              f"{where}: {nm} differs from the plain version with the "
              f"kernel's roundings in a share {s['mismatch']}")
    for label in ("free_running", "fp64_kernel"):
        for nm, s in out[label].items():
            check(s["mismatch"] <= GRU_BF16_FREE_MISMATCH_TOL,
                  f"{where}: {nm} differs from the {label} plain version "
                  f"in a share {s['mismatch']}")
    if gate:
        for names in (("ys",), ("dzg", "dzc")):
            worst = max(out["control"][nm]["mismatch"] for nm in names)
            check(worst > GRU_BF16_FREE_MISMATCH_TOL,
                  f"{where}: the control without the kernel's roundings "
                  f"passes the mismatch limits ({names}: {worst})")
    return out


def _gru_times(fr, flush, zg, zc, wg, wc, dy, res):
    """Kernel and plain times at a timed case; cuDNN's torch.nn.GRU
    over the same batch as a yardstick of a different function (it
    applies r after the recurrent product, BigDL before it)."""
    import torch

    reps = dict(reps=10, warmup=2)
    times = {
        "fwd_ms": cuda_ms(lambda: fr.gru_fwd_cuda(zg, zc, wg, wc, True),
                          flush, **reps),
        "infer_ms": cuda_ms(lambda: fr.gru_fwd_cuda(zg, zc, wg, wc, False),
                            flush, **reps),
        "bwd_ms": cuda_ms(lambda: fr.gru_bwd_cuda(wg, wc, *res, dy),
                          flush, **reps),
        "plain_fwd_ms": cuda_ms(
            lambda: fr.gru_forward_reference(zg, zc, wg, wc), flush,
            reps=5, warmup=1),
        "plain_bwd_ms": cuda_ms(
            lambda: fr.gru_backward_reference(wg, wc, *res, dy), flush,
            reps=5, warmup=1),
    }
    n, t, h = dy.shape
    for dtype in (zg.dtype, torch.float32):
        try:        # yardstick only, never called by the port
            gru = torch.nn.GRU(h, h, batch_first=True).cuda().to(dtype)
            x = torch.randn(n, t, h, device="cuda", dtype=dtype,
                            requires_grad=True)
            params = [x, *gru.parameters()]

            def fwd_bwd():
                y, _ = gru(x)
                torch.autograd.grad(y, params, torch.ones_like(y))

            fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError as err:   # cuDNN without this dtype
            times.setdefault("cudnn_refused", []).append(
                f"{dtype}: {str(err)[:120]}")
            continue
        times["cudnn_gru_other_function"] = {
            "dtype": str(dtype).replace("torch.", ""),
            "fwd_ms": cuda_ms(lambda: gru(x), flush, **reps),
            "fwd_bwd_ms": cuda_ms(fwd_bwd, flush, **reps)}
        break
    return times


def _bigru(impl=None):
    """The BiGRU sentiment classifier at config 4's widths, composed
    from the port's layers as models/rnn.bilstm_sentiment composes the
    BiLSTM; `impl` forces the recurrences' route ("cuda" or "torch")."""
    from bigdl_tpu_torch import nn

    return nn.Sequential(
        nn.LookupTable(RNN_VOCAB, RNN_EMBED).set_name("embedding"),
        nn.BiRecurrent(nn.GRU(RNN_EMBED, RNN_HIDDEN), fused=impl)
        .set_name("bigru"),
        nn.Mean(2),
        nn.Linear(2 * RNN_HIDDEN, 2).set_name("cls"),
        nn.LogSoftMax())


def phase_gru_model():
    """One fp32 loss-and-grad step of the full-width BiGRU classifier
    (batch 128 x 128) through the kernels against the same step through
    the plain versions, from the same params and batch: two training
    forwards and two backwards (one a direction) through the kernels,
    none through the plain versions."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import (tree_leaves,
                                                tree_leaves_with_path,
                                                tree_map)
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import FULL_PRECISION

    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randint(0, RNN_VOCAB, (RNN_BATCH, RNN_SEQ))
                        .astype(np.int32)).cuda()
    y = torch.as_tensor(rng.randint(0, 2, RNN_BATCH).astype(np.int32)).cuda()
    params, out = None, {}
    for impl in ("cuda", "torch"):
        model = _bigru(impl)
        if params is None:
            params = model.init(torch.Generator().manual_seed(0))["params"]
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss_call = build_train_loss(model, nn.ClassNLLCriterion(),
                                     FULL_PRECISION)
        counts0 = (fr.gru_fwd_train_launches, fr.gru_bwd_launches)
        loss, _ = loss_call(p, model.init_state(), x, y, None)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        out[impl] = (float(loss.detach()), grads,
                     (fr.gru_fwd_train_launches - counts0[0],
                      fr.gru_bwd_launches - counts0[1]))
    dloss = abs(out["cuda"][0] - out["torch"][0])
    top = max(float(b.abs().max()) for b in out["torch"][1])
    rels = {".".join(map(str, path)): float((a - b).abs().max()) / max(
        float(b.abs().max()), TRAIN_GRAD_FLOOR * top)
        for (path, _), a, b in zip(tree_leaves_with_path(params),
                                   out["cuda"][1], out["torch"][1])}
    rel = max(rels.values())
    check(math.isfinite(out["cuda"][0]), "gru_model: loss not finite")
    check(dloss <= TRAIN_LOSS_TOL, f"gru_model: |dloss| {dloss}")
    check(rel <= TRAIN_GRAD_TOL, f"gru_model: grad rel diff {rel}")
    check(out["cuda"][2] == (2, 2),
          f"gru_model: the kernel step launched {out['cuda'][2]}")
    check(out["torch"][2] == (0, 0),
          "gru_model: the plain step launched kernels")
    emit("gru_model", tolerance={"loss": TRAIN_LOSS_TOL,
                                 "grad_rel": TRAIN_GRAD_TOL},
         grad_floor=TRAIN_GRAD_FLOOR, shape=[RNN_BATCH, RNN_SEQ],
         loss_cuda=out["cuda"][0], loss_torch=out["torch"][0],
         loss_abs_diff=dloss, grad_max_rel_diff=rel,
         grad_rel_diff_by_leaf=rels,
         launches={"fwd": out["cuda"][2][0], "bwd": out["cuda"][2][1]},
         params=int(sum(t.numel() for t in tree_leaves(params))))


def _profile_gru_step(model, samples):
    """One BiGRU trainer step, after two warm-up steps, under
    torch.profiler: (profiled wall ms, device ms, GRU kernels' ms,
    kernel count, top rows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    marks = {}

    def on_step(state):
        if state["neval"] == 2:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif state["neval"] == 3:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.stop()

    _rnn_trainer(model, samples, nn.ClassNLLCriterion(), RNN_BATCH, 3,
                 on_step)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "gru_train_trace.json"))
    return ((marks["t1"] - marks["t0"]) * 1e3,
            sum(r[0] for r in rows) / 1e3,
            sum(r[0] for r in rows
                if "gru_" in r[2] or "rnn_dw_" in r[2]) / 1e3,
            sum(r[1] for r in rows), rows[:12])


def phase_gru_trainer():
    """The slice's main path: the BiGRU classifier trained through
    Optimizer(...).set_validation(...).optimize() at the bench shape
    (bf16, Adam(1e-3)) for TRAIN_WARMUP + TRAIN_STEPS steps, validating
    (Top1Accuracy, Loss) after every GRU_VALID_EVERY steps over
    GRU_VALID_BATCHES held-out batches, launches counted over the timed
    steps; then Predictor.predict / predict_class over RNN_INFER_BATCHES
    batches; then one profiled step (where the step's time goes, device
    busy share)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.optim import (Adam, Loss, Optimizer, Predictor,
                                       Top1Accuracy, Trigger)

    counters = ("gru_fwd_train_launches", "gru_fwd_infer_launches",
                "gru_bwd_launches")
    steps = TRAIN_WARMUP + TRAIN_STEPS
    losses, marks, validations = [], {"val_s": []}, []
    every = Trigger.several_iteration(GRU_VALID_EVERY)

    def validate_now(state):
        fire = every(state)
        if fire and "t0" in marks and "t1" not in marks:
            torch.cuda.synchronize()        # validation time, kept apart
            marks["v0"] = time.perf_counter()
        return fire

    def end_when(state):
        if "v0" in marks:
            torch.cuda.synchronize()
            marks["val_s"].append(time.perf_counter() - marks.pop("v0"))
        res = state.get("validation")
        if res is not None and res is not marks.get("seen"):
            marks["seen"] = res                 # a validation just ran
            validations.append((state["neval"], {
                k: v.result() for k, v in res.items()}))
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:                  # main path starts here
                setattr(fr, c, 0)
            marks["t0"] = time.perf_counter()
        elif state["neval"] == steps:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = {c: getattr(fr, c)   # main path ends here
                                 for c in counters}
        return state["neval"] >= steps

    model = _bigru()
    model.build(torch.Generator().manual_seed(0))
    held_out = DataSet.array(_sentiment_samples(
        RNN_BATCH * GRU_VALID_BATCHES, 15))
    Optimizer(model, DataSet.array(_sentiment_samples(RNN_BATCH * steps,
                                                      11)),
              nn.ClassNLLCriterion(), batch_size=RNN_BATCH) \
        .set_optim_method(Adam(1e-3)).set_precision("bf16") \
        .set_validation(Trigger(validate_now), held_out,
                        [Top1Accuracy(), Loss(nn.ClassNLLCriterion())]) \
        .set_end_when(Trigger(end_when)).optimize()
    losses = [float(v) for v in losses]
    launches = marks["launches"]
    fired = sum(k % GRU_VALID_EVERY == 0      # validations in the window
                for k in range(TRAIN_WARMUP + 1, steps + 1))
    dt = marks["t1"] - marks["t0"] - sum(marks["val_s"])
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"gru trainer losses not all finite: {losses}")
    check(losses[-1] < losses[0], f"gru trainer loss did not fall: {losses}")
    check(len(validations) == steps // GRU_VALID_EVERY and all(
        math.isfinite(r["Loss"][0]) and r["Top1Accuracy"][1]
        == RNN_BATCH * GRU_VALID_BATCHES for _, r in validations),
        f"gru trainer validations {validations}")
    want = {"gru_fwd_train_launches": 2 * TRAIN_STEPS,
            "gru_bwd_launches": 2 * TRAIN_STEPS,
            "gru_fwd_infer_launches": 2 * GRU_VALID_BATCHES * fired}
    check(launches == want, f"gru trainer launches {launches} != {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # Predictor over held-out batches: the trained fp32 weights, no
    # autograd, the inference variant only
    held = _sentiment_samples(RNN_BATCH * RNN_INFER_BATCHES, 12)
    labels = torch.as_tensor(np.stack([s.label for s in held])).cuda()
    torch.cuda.synchronize()
    for c in counters:                          # predict path starts here
        setattr(fr, c, 0)
    t_pred = time.perf_counter()
    predictor = Predictor(model, batch_size=RNN_BATCH)
    scores = predictor.predict(DataSet.array(held))
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t_pred
    pred_launches = {c: getattr(fr, c) for c in counters}  # path ends
    check(pred_launches == {"gru_fwd_train_launches": 0,
                            "gru_bwd_launches": 0,
                            "gru_fwd_infer_launches": 2 * RNN_INFER_BATCHES},
          f"predict launches {pred_launches}")
    classes = predictor.predict_class(DataSet.array(held))
    check(tuple(scores.shape) == (RNN_BATCH * RNN_INFER_BATCHES, 2)
          and bool(torch.isfinite(scores).all())
          and torch.equal(classes, scores.argmax(-1)),
          "predict: scores not finite or classes not their argmax")
    accuracy = float((classes == labels.long()).float().mean())

    wall, dev, gru_ms, kernels, top = _profile_gru_step(
        _bigru().build(torch.Generator().manual_seed(0)),
        _sentiment_samples(RNN_BATCH * 3, 14))
    emit("gru_trainer", steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
         batch=RNN_BATCH, seq=RNN_SEQ, seconds=dt,
         validation_seconds=marks["val_s"],   # each, in the window
         step_ms=dt / TRAIN_STEPS * 1e3,
         samples_per_sec=TRAIN_STEPS * RNN_BATCH / dt,
         tokens_per_sec=TRAIN_STEPS * RNN_BATCH * RNN_SEQ / dt,
         peak_mem_gib=peak, launches=launches, losses=losses,
         validations=[{"neval": n, **{k: {"value": v, "count": c}
                                     for k, (v, c) in r.items()}}
                      for n, r in validations],
         predict={"batches": RNN_INFER_BATCHES, "seconds": t_pred,
                  "launches": pred_launches, "accuracy": accuracy},
         profile={"profiled_wall_ms": wall, "device_ms": dev,
                  "gru_kernels_ms": gru_ms,
                  "gru_share_of_device": gru_ms / dev if dev else None,
                  "device_busy_share": dev / wall if dev else None,
                  "kernels": kernels,
                  "top": [{"name": k[:80], "calls": c, "ms": us / 1e3}
                          for us, c, k in top]})
    return launches


# ------------------------------------------------------------ CNN slice
# BASELINE configs 1 and 2 (LeNet-5 MNIST, ResNet-50 ImageNet). The JAX
# package runs these layers outside Pallas (lax.conv_general_dilated,
# lax.reduce_window, jnp batch norm), so no kernel of the port's table
# lies on this path: convolutions go to cuDNN through torch.
CNN_FWD_TOL, CNN_GRAD_TOL = 1e-5, 1e-4      # card vs CPU, fp32
RESNET_LOSS_TOL, RESNET_GRAD_TOL = 1e-4, 1e-3
RESNET_MODEL_BATCH = 2
RESNET_PERF = dict(model_name="resnet50", batch_size=256, iterations=10,
                   optimizer="sgd", precision="bf16")
# the canonical ResNet-50 forward: ~4.1 GMAC an image
RESNET50_GMAC = (3.9, 4.2)
CIFAR_BATCH, CIFAR_STEPS, CIFAR_VALID_EVERY = 128, 12, 6
CIFAR_HELD_OUT = 256
LENET_EPOCHS, LENET_BATCH, LENET_MIN_TOP1 = 3, 64, 0.9
# a ResNet-50 profile's device operations by kind, the first match wins:
# convolutions and gemms (cuDNN's xmma/cutlass kernels, cuBLAS's nvjet),
# copies, casts and relayouts (ATen copies, device memcpy, cuDNN layout
# transforms), reductions (batch-norm statistics), pooling, element-wise
PROFILE_KINDS = (
    ("conv_gemm", re.compile(r"xmma|nvjet|cutlass|[Gg]emm|conv|cudnn|"
                             r"nhwcAddPadding")),
    ("copy", re.compile(r"copy|Copy|Memcpy|nchwToNhwc|nhwcToNchw|"
                        r"[Tt]ranspose")),
    ("reduce", re.compile(r"reduce_kernel")),
    ("pool", re.compile(r"pool")),
    ("elementwise", re.compile(r"elementwise|Memset")),
)


def _cnn_cases():
    """(name, module factory, input shapes, table packing, training):
    every ported conv, pooling, batch-norm and table module, at shapes
    big enough for cuDNN's real algorithms."""
    from bigdl_tpu_torch import nn

    return [
        ("conv", lambda: nn.SpatialConvolution(16, 32, 3, 3, 1, 1, 1, 1),
         [(4, 16, 16, 16)], None, False),
        ("conv_strided_rect", lambda: nn.SpatialConvolution(
            16, 24, 3, 5, 2, 1, 1, 2), [(4, 17, 18, 16)], None, False),
        ("conv_grouped", lambda: nn.SpatialConvolution(
            32, 64, 3, 3, 1, 1, 1, 1, n_group=4), [(4, 14, 14, 32)], None,
         False),
        ("conv_same", lambda: nn.SpatialConvolution(16, 32, 4, 4, 2, 2, -1),
         [(4, 17, 18, 16)], None, False),
        ("conv_s2d_stem", lambda: nn.SpatialConvolution(
            12, 64, 4, 4, 1, 1, (2, 1), (2, 1), with_bias=False),
         [(4, 28, 28, 12)], None, False),
        ("conv_share", lambda: nn.SpatialShareConvolution(16, 32, 1, 1),
         [(4, 16, 16, 16)], None, False),
        ("conv_dilated", lambda: nn.SpatialDilatedConvolution(
            16, 16, 3, 3, 1, 1, 2, 2, dilation_w=2), [(4, 16, 16, 16)],
         None, False),
        ("conv_dilated_same", lambda: nn.SpatialDilatedConvolution(
            16, 16, 3, 3, 2, 2, -1, dilation_w=2), [(4, 15, 16, 16)], None,
         False),
        ("conv_transposed", lambda: nn.SpatialFullConvolution(
            16, 8, 3, 3, 2, 2, 1, 1, adj_w=1, adj_h=1), [(4, 9, 9, 16)],
         None, False),
        ("conv_transposed_grouped", lambda: nn.SpatialFullConvolution(
            16, 24, 3, 3, 2, 2, 0, 0, n_group=4, dilation_w=2),
         [(4, 8, 9, 16)], None, False),
        ("conv_temporal", lambda: nn.TemporalConvolution(32, 48, 3, 2),
         [(4, 33, 32)], None, False),
        ("max_pool_stem", lambda: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
         [(4, 32, 32, 16)], None, False),
        ("max_pool_ceil", lambda: nn.SpatialMaxPooling(
            3, 3, 2, 2, ceil_mode=True), [(4, 16, 16, 16)], None, False),
        ("max_pool_same", lambda: nn.SpatialMaxPooling(3, 3, 2, 2, -1),
         [(4, 15, 16, 16)], None, False),
        ("avg_pool_ceil", lambda: nn.SpatialAveragePooling(
            3, 3, 2, 2, ceil_mode=True), [(4, 16, 16, 16)], None, False),
        ("avg_pool_exclude_pad", lambda: nn.SpatialAveragePooling(
            3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False),
         [(4, 16, 16, 16)], None, False),
        ("avg_pool_sum", lambda: nn.SpatialAveragePooling(
            3, 2, 1, 2, 1, 0, divide=False), [(4, 12, 13, 16)], None, False),
        ("avg_pool_global", lambda: nn.SpatialAveragePooling(7, 7, 1, 1),
         [(4, 7, 7, 64)], None, False),
        ("temporal_max_pool", lambda: nn.TemporalMaxPooling(3, 2),
         [(4, 33, 16)], None, False),
        ("batch_norm_train", lambda: nn.BatchNormalization(64),
         [(32, 64)], None, True),
        ("batch_norm_eval", lambda: nn.BatchNormalization(64),
         [(32, 64)], None, False),
        ("spatial_batch_norm_train", lambda: nn.SpatialBatchNormalization(
            32), [(4, 14, 14, 32)], None, True),
        ("spatial_batch_norm_eval", lambda: nn.SpatialBatchNormalization(
            32), [(4, 14, 14, 32)], None, False),
        ("lrn", lambda: nn.SpatialCrossMapLRN(5, 1e-4, 0.75, 1.0),
         [(4, 14, 14, 32)], None, False),
        ("normalize", lambda: nn.Normalize(2.0), [(16, 64)], None, False),
        ("layer_norm", lambda: nn.LayerNorm(64), [(16, 64)], None, False),
        ("rms_norm", lambda: nn.RMSNorm(64), [(16, 64)], None, False),
        # no conv bias before a batch norm: its exact gradient is 0
        ("concat_table", lambda: nn.ConcatTable(
            nn.Sequential(nn.SpatialConvolution(16, 16, 3, 3, 1, 1, 1, 1,
                                                with_bias=False),
                          nn.SpatialBatchNormalization(16)),
            nn.Identity()), [(4, 14, 14, 16)], None, True),
        ("parallel_table", lambda: nn.ParallelTable(
            nn.Linear(32, 16), nn.Linear(8, 16)), [(16, 32), (16, 8)],
         "list", False),
        ("concat", lambda: nn.Concat(4, nn.SpatialConvolution(16, 8, 1, 1),
                                     nn.SpatialMaxPooling(1, 1)),
         [(4, 14, 14, 16)], None, False),
        ("map_table", lambda: nn.MapTable(nn.Linear(32, 16)),
         [(16, 32)] * 3, "list", False),
        ("bottle", lambda: nn.Bottle(nn.Linear(32, 16), 2, 2),
         [(4, 9, 32)], None, False),
        ("cadd_table", lambda: nn.CAddTable(), [(4, 14, 14, 16)] * 3,
         "list", False),
        ("cmul_table", lambda: nn.CMulTable(), [(4, 14, 14, 16)] * 2,
         "list", False),
        ("csub_table", lambda: nn.CSubTable(), [(4, 14, 14, 16)] * 2,
         "list", False),
        ("cdiv_table", lambda: nn.CDivTable(), [(4, 14, 14, 16)] * 2,
         "positive", False),
        ("cmax_table", lambda: nn.CMaxTable(), [(4, 14, 14, 16)] * 3,
         "list", False),
        ("cmin_table", lambda: nn.CMinTable(), [(4, 14, 14, 16)] * 3,
         "list", False),
        ("join_table", lambda: nn.JoinTable(4), [(4, 7, 7, 16)] * 11,
         "table", False),
        ("split_table", lambda: nn.SplitTable(2), [(4, 5, 32)], None, False),
        ("select_table", lambda: nn.SelectTable(10), [(4, 7, 7, 16)] * 11,
         "table", False),
        ("flatten_table", lambda: nn.FlattenTable(), [(4, 32)] * 4,
         "nested", False),
    ]


def _seeded_variables(tree, seed: int):
    """A CPU variable tree with every leaf redrawn from `seed`: running
    variances in [0.5, 1.5), batch-norm gammas (a 1-D 'weight') 1 +
    N(0, 0.5^2), so that no branch is scaled by exactly 0 or 1, weights
    N(0, 2 / fan_in), other 1-D leaves N(0, 0.1^2)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def draw(node, name=""):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if name == "running_var":
            return 0.5 + torch.rand(node.shape, generator=g)
        if node.ndim == 1:
            v = torch.randn(node.shape, generator=g)
            return 1.0 + 0.5 * v if name == "weight" else 0.1 * v
        return torch.randn(node.shape, generator=g) \
            * math.sqrt(2.0 / math.prod(node.shape[:-1]))

    return draw(tree)


def _pack(xs, table):
    """The inputs as the module takes them: one tensor, a list, a Table
    of keys 1..n inserted out of order, or a nested table."""
    import torch

    from bigdl_tpu_torch.utils.table import T, Table

    if table in ("list", "positive"):
        return list(xs)
    if table == "table":
        order = torch.randperm(len(xs),
                               generator=torch.Generator().manual_seed(5))
        return Table({i + 1: xs[i] for i in order.tolist()})
    if table == "nested":
        return [xs[0], T(xs[1], [xs[2], xs[3]])]
    return xs[0]


def _cnn_pass(module, variables, xs, table, training, device, cts=None):
    """The module's forward on `device` with gradients of sum(out * ct)
    with respect to every parameter and float input (`xs` may nest
    tuples): (outputs, new state leaves, gradients, cotangents)."""
    import torch

    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map

    params = tree_map(lambda t: t.to(device).requires_grad_(),
                      variables["params"])
    state = tree_map(lambda t: t.to(device), variables["state"])
    # float inputs are differentiated, integer ones (ids) are not
    xs = tree_map(lambda x: x.to(device).requires_grad_()
                  if x.is_floating_point() else x.to(device), xs)
    out, new_state = module.apply({"params": params, "state": state},
                                  _pack(xs, table), training=training)
    outs = tree_leaves(out)
    if cts is None:
        g = torch.Generator().manual_seed(7)
        cts = [torch.randn(o.shape, generator=g) for o in outs]
    loss = sum((o * c.to(device)).sum() for o, c in zip(outs, cts))
    leaves = tree_leaves(params) + [x for x in tree_leaves(xs)
                                    if x.requires_grad]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(leaves, grads)]
    return ([o.detach().cpu() for o in outs],
            [s.cpu() for s in tree_leaves(new_state)],
            [gr.cpu() for gr in grads], cts)


def phase_cnn_layers():
    """Every ported conv, pooling, batch-norm and table module on the
    card (cuDNN and ATen's CUDA kernels) against the same module on the
    CPU, fp32 with TF32 off, on seeded variables and inputs: forward
    and new running statistics <= CNN_FWD_TOL of each output's largest
    entry, gradients (every parameter and input) <= CNN_GRAD_TOL of
    each gradient's largest entry."""
    import torch

    t0 = time.perf_counter()
    results = {}
    for i, (name, factory, shapes, table, training) in enumerate(
            _cnn_cases()):
        module = factory()
        variables = _seeded_variables(
            module.init(torch.Generator().manual_seed(i), "cpu"), i)
        g = torch.Generator().manual_seed(100 + i)
        xs = [torch.randn(s, generator=g) for s in shapes]
        if table == "positive":
            xs = [x.abs() + 0.5 for x in xs]
        ref_out, ref_state, ref_grads, cts = _cnn_pass(
            module, variables, xs, table, training, "cpu")
        out, state, grads, _ = _cnn_pass(module, variables, xs, table,
                                         training, "cuda", cts)
        fwd = max([_rel_err(a, b) for a, b in zip(out, ref_out)]
                  + [_rel_err(a, b) for a, b in zip(state, ref_state)])
        grad = max(_rel_err(a, b) for a, b in zip(grads, ref_grads))
        results[name] = {"fwd_rel_err": fwd, "grad_rel_err": grad}
        check(len(out) == len(ref_out) and all(
            a.shape == b.shape for a, b in zip(out, ref_out)),
            f"cnn_layers {name}: output shapes differ")
        check(fwd <= CNN_FWD_TOL,
              f"cnn_layers {name}: forward {fwd:.3g} > {CNN_FWD_TOL}")
        check(grad <= CNN_GRAD_TOL,
              f"cnn_layers {name}: gradients {grad:.3g} > {CNN_GRAD_TOL}")
    emit("cnn_layers", cases=len(results), seconds=time.perf_counter() - t0,
         max_fwd_rel_err=max(r["fwd_rel_err"] for r in results.values()),
         max_grad_rel_err=max(r["grad_rel_err"] for r in results.values()),
         results=results)


def phase_resnet_model():
    """Full-width ResNet-50 (build_imagenet(50, 1000), seed 0, seeded
    batch-norm gammas), one training-mode loss-and-grad step at batch
    RESNET_MODEL_BATCH on the card against the port's CPU route on the
    same variables and images. In fp32: the loss <= RESNET_LOSS_TOL
    relative, the new running statistics <= RESNET_GRAD_TOL of each
    leaf's largest entry. The gradients are held in fp64 (batch-norm
    statistics in fp64 too): every gradient <= RESNET_GRAD_TOL of its
    leaf's largest entry. In fp32 the network's gradient is
    discontinuous at its rounding level: a forward difference of ~1e-4
    relative, which fp32 reaches by the last stage (a block's 1/sigma
    with gammas near 1 amplifies it), flips ReLUs whose input sits that
    close to zero, and a flip reaches every earlier leaf. The CPU route
    alone, fp32 against fp64 or at two thread counts, reads 4-12% apart,
    and fp64 with fp32 statistics reads 11% between the card and the
    CPU. So the fp32 gradients are reported beside the CPU's own
    fp32-vs-fp64 distance, not gated."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map

    t0 = time.perf_counter()
    model = resnet.build_imagenet(50, 1000)
    variables = _seeded_variables(
        model.init(torch.Generator().manual_seed(0), "cpu"), 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((RESNET_MODEL_BATCH, 224, 224, 3), generator=g)
    y = torch.randint(0, 1000, (RESNET_MODEL_BATCH,), generator=g)

    def step(device, dtype):
        params = tree_map(lambda t: t.to(device, dtype).requires_grad_(),
                          variables["params"])
        state = tree_map(lambda t: t.to(device), variables["state"])
        out, new_state = model.apply({"params": params, "state": state},
                                     x.to(device, dtype), training=True)
        loss = nn.ClassNLLCriterion()(out, y.to(device))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return (float(loss.detach()), [gr.cpu() for gr in grads],
                [s.cpu() for s in tree_leaves(new_state)])

    ref_loss, ref_grads, ref_state = step("cpu", torch.float32)
    loss, grads, state = step("cuda", torch.float32)
    ref_loss64, ref_grads64, _ = step("cpu", torch.float64)
    loss64, grads64, _ = step("cuda", torch.float64)
    torch.cuda.synchronize()
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    state_err = max(_rel_err(a, b) for a, b in zip(state, ref_state))
    grad_err = max(_rel_err(a, b) for a, b in zip(grads64, ref_grads64))
    fp32_grad_err = max(_rel_err(a, b) for a, b in zip(grads, ref_grads))
    cpu_fp32_vs_fp64 = max(_rel_err(a, b)
                           for a, b in zip(ref_grads, ref_grads64))
    changed = all(not torch.equal(a, b) for a, b in zip(
        state, tree_leaves(variables["state"])))
    check(math.isfinite(loss) and loss_err <= RESNET_LOSS_TOL,
          f"resnet_model: loss {loss} vs {ref_loss} ({loss_err:.3g})")
    check(state_err <= RESNET_GRAD_TOL and changed,
          f"resnet_model: running statistics {state_err:.3g}, "
          f"changed {changed}")
    check(grad_err <= RESNET_GRAD_TOL,
          f"resnet_model: fp64 gradients {grad_err:.3g} > "
          f"{RESNET_GRAD_TOL}")
    emit("resnet_model", batch=RESNET_MODEL_BATCH,
         params=sum(t.numel() for t in tree_leaves(variables["params"])),
         loss=loss, cpu_loss=ref_loss, loss_rel_err=loss_err,
         state_rel_err=state_err, fp64_loss=loss64, fp64_cpu_loss=ref_loss64,
         fp64_grad_rel_err=grad_err, fp32_grad_rel_err=fp32_grad_err,
         cpu_fp32_vs_fp64_grad_rel_err=cpu_fp32_vs_fp64,
         seconds=time.perf_counter() - t0)


def phase_lenet_trainer():
    """BASELINE config 1 as tests/test_training_e2e.py runs it (no
    checkpoints or summaries): LeNet-5 on synthetic_mnist(512, seed=0),
    batch 64, Adam(2e-3), 3 epochs, validated every epoch on
    synthetic_mnist(128, seed=9) with Top1Accuracy; then Evaluator over
    the held-out set: top-1 > LENET_MIN_TOP1. Each epoch's wall time
    (its validation included). Returns the trained model (the quantized
    phase's LeNet-5)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim import (Adam, Evaluator, Optimizer,
                                       Top1Accuracy, Trigger)

    t0 = time.perf_counter()
    train, test = synthetic_mnist(512, seed=0), synthetic_mnist(128, seed=9)
    model = lenet.build(10).build(torch.Generator().manual_seed(7))
    stop = Trigger.max_epoch(LENET_EPOCHS)
    marks = {"epoch": 1, "t": time.perf_counter(), "epoch_s": [],
             "validation": []}

    def end_when(state):
        if state["epoch"] != marks["epoch"]:     # an epoch and its check
            torch.cuda.synchronize()
            now = time.perf_counter()
            marks["epoch_s"].append(now - marks["t"])
            marks["epoch"], marks["t"] = state["epoch"], now
            marks["validation"].append(
                state["validation"]["Top1Accuracy"].result())
        return stop(state)

    trained = Optimizer(model, DataSet.array(train), nn.ClassNLLCriterion(),
                        batch_size=LENET_BATCH) \
        .set_optim_method(Adam(learningrate=2e-3)) \
        .set_end_when(Trigger(end_when)) \
        .set_validation(Trigger.every_epoch(), DataSet.array(test),
                        [Top1Accuracy()], LENET_BATCH).optimize()
    top1, count = Evaluator(trained).test(
        DataSet.array(test), [Top1Accuracy()], LENET_BATCH)[
        "Top1Accuracy"].result()
    check(len(marks["epoch_s"]) == LENET_EPOCHS
          and all(c == len(test) for _, c in marks["validation"]),
          f"lenet_trainer: epochs {marks['epoch_s']}, validations "
          f"{marks['validation']}")
    check(count == len(test) and top1 > LENET_MIN_TOP1,
          f"lenet_trainer: held-out top-1 {top1} ({count})")
    emit("lenet_trainer", epochs=LENET_EPOCHS, batch=LENET_BATCH,
         epoch_seconds=marks["epoch_s"],
         validation_top1=[v for v, _ in marks["validation"]],
         top1=top1, seconds=time.perf_counter() - t0)
    return trained


def _lenet_guarded(train, end, policy, plan="", ckpt=None):
    """BASELINE config 1's LeNet-5 (seed 7, batch 64, Adam(2e-3)) for
    `end` steps under the anomaly guard `policy` and the fault plan
    `plan`, checkpointing every 2 steps under `ckpt`; returns the
    Optimizer and the train states its end trigger saw."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.utils import faults

    states = []
    stop = Trigger.max_iteration(end)

    def end_when(state):
        states.append({k: state[k] for k in ("neval", "nupdates")})
        return stop(state)

    o = Optimizer(lenet.build(10).build(torch.Generator().manual_seed(7)),
                  DataSet.array(train), nn.ClassNLLCriterion(),
                  batch_size=LENET_BATCH) \
        .set_optim_method(Adam(learningrate=2e-3)) \
        .set_end_when(Trigger(end_when)).set_anomaly_guard(policy)
    if ckpt is not None:
        o.set_checkpoint(str(ckpt), Trigger.several_iteration(2))
    faults.set_plan(faults.FaultPlan(plan))
    try:
        o.optimize()
    finally:
        faults.set_plan(faults.FaultPlan(""))
    return o, states


def phase_lenet_guard():
    """The anomaly guard's three policies on the card, on BASELINE
    config 1 (the LM's integer tokens cannot carry a NaN batch):
    skip_step with `nan@3` — the params after step 3 are the params
    before it, bit for bit, one skip, nupdates == neval - 1; rollback
    with a checkpoint every 2 steps and `nan@5` — the final params equal
    a clean run's bit for bit, one rollback; halt raises AnomalyError.
    cuDNN runs its deterministic algorithms here (restored afterwards):
    bitwise replay needs a step that repeats itself."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.utils.anomaly import AnomalyError

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a.model.variables["params"]),
            tree_leaves(b.model.variables["params"])))

    t0 = time.perf_counter()
    train = synthetic_mnist(512, seed=0)
    tmp = Path(tempfile.mkdtemp(prefix="lenet_guard_"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, _ = _lenet_guarded(train, 3, "skip_step")
        got, states = _lenet_guarded(train, 4, "skip_step", "nan@3")
        check(same(got, ref), "lenet_guard skip_step: the params moved")
        check(got.anomaly_guard.skipped == 1
              and states[-1] == {"neval": 4, "nupdates": 3},
              f"lenet_guard skip_step: {got.anomaly_guard.stats()}, "
              f"{states[-1]}")
        clean, _ = _lenet_guarded(train, 8, "rollback", ckpt=tmp / "clean")
        rolled, rstates = _lenet_guarded(train, 8, "rollback", "nan@5",
                                         ckpt=tmp / "faulted")
        check(same(rolled, clean),
              "lenet_guard rollback: params differ from the clean run")
        check(rolled.anomaly_guard.rollbacks == 1
              and rstates.count({"neval": 5, "nupdates": 5}) == 2,
              f"lenet_guard rollback: {rolled.anomaly_guard.stats()}, "
              f"{rstates}")
        halted = None
        try:
            _lenet_guarded(train, 4, "halt", "nan@2")
        except AnomalyError as e:               # the policy's answer
            halted = str(e)
        check(halted is not None, "lenet_guard: halt did not raise")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    emit("lenet_guard", skip_step=got.anomaly_guard.stats(),
         rollback=rolled.anomaly_guard.stats(), rollback_clock=rstates,
         halt=halted, seconds=time.perf_counter() - t0)


def _forward_flops(model, variables, shape) -> float:
    """Forward flops an image of the model's convolutions and linear
    layers, counted from the shapes of a batch-1 forward on the card:
    2·Ho·Wo·Cout·kh·kw·Cin/groups a convolution, 2·in·out a linear."""
    import torch

    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear

    flops = []
    conv_apply, linear_apply = SpatialConvolution.apply, Linear.apply

    def conv(self, v, x, **kw):
        y, s = conv_apply(self, v, x, **kw)
        kh, kw_, cin, cout = v["params"]["weight"].shape
        flops.append(2 * y.shape[1] * y.shape[2] * cout * kh * kw_ * cin)
        return y, s

    def linear(self, v, x, **kw):
        flops.append(2 * math.prod(v["params"]["weight"].shape))
        return linear_apply(self, v, x, **kw)

    SpatialConvolution.apply, Linear.apply = conv, linear
    try:
        with torch.no_grad():
            model.apply(variables, torch.zeros((1,) + shape, device="cuda"))
    finally:
        SpatialConvolution.apply, Linear.apply = conv_apply, linear_apply
    return float(sum(flops))


def phase_resnet_trainer():
    """BASELINE config 2: `perf.run_perf("resnet50", 256, 10,
    optimizer="sgd", precision="bf16")` on the card (images/s, step ms,
    peak memory, the model-flops share: 3 x the forward flops counted
    from the conv and linear shapes, over the step time, over the card's
    dense bf16 peak; the forward checked against ~4.1 GMAC an image);
    then Optimizer for CIFAR_STEPS steps on build_cifar(20, 10) over
    synthetic_cifar10, batch 128, SGD(0.1, momentum 0.9), validated
    after steps 6 and 12. Gates: losses finite, the ResNet-20 loss
    falling (the mean of the last 3 below the first 3), running
    statistics changed, validation counts whole."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.cifar import synthetic_cifar10
    from bigdl_tpu_torch.models import perf, resnet
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, Top1Accuracy,
                                       Trigger)

    t0 = time.perf_counter()
    fmodel = resnet.build_imagenet(50, 1000)
    fwd_flops = _forward_flops(
        fmodel, fmodel.init(torch.Generator().manual_seed(0)), (224, 224, 3))
    gmac = fwd_flops / 2e9
    check(RESNET50_GMAC[0] < gmac < RESNET50_GMAC[1],
          f"resnet_trainer: ResNet-50 forward {gmac:.3f} GMAC an image")
    del fmodel
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = perf.run_perf(**RESNET_PERF)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = res["steady_wall_s"] / res["iterations"]
    share = 3 * fwd_flops * res["batch_size"] / step_s / BF16_FLOPS_PER_S
    check(math.isfinite(res["images_per_sec"]) and res["images_per_sec"] > 0,
          f"resnet_trainer: {res}")
    perf_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    model = resnet.build_cifar(20, 10).build(torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree_leaves(model.variables["state"])]
    losses, validations = [], []

    def end_when(state):
        res_v = state.get("validation")
        if res_v is not None and (not validations
                                  or validations[-1][1] is not res_v):
            validations.append((state["neval"], res_v))
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] >= CIFAR_STEPS

    Optimizer(model, DataSet.array(synthetic_cifar10(
        CIFAR_BATCH * CIFAR_STEPS, seed=0)), nn.ClassNLLCriterion(),
        batch_size=CIFAR_BATCH) \
        .set_optim_method(SGD(learningrate=0.1, momentum=0.9)) \
        .set_validation(Trigger.several_iteration(CIFAR_VALID_EVERY),
                        DataSet.array(synthetic_cifar10(CIFAR_HELD_OUT,
                                                        seed=1)),
                        [Top1Accuracy(), Loss(nn.ClassNLLCriterion())]) \
        .set_end_when(Trigger(end_when)).optimize()
    losses = [float(v) for v in losses]
    vals = [{"neval": n, **{k: {"value": v, "count": c} for k, (v, c) in
                            ((k, r.result()) for k, r in res_v.items())}}
            for n, res_v in validations]
    after = tree_leaves(model.variables["state"])
    check(len(losses) == CIFAR_STEPS
          and all(math.isfinite(v) for v in losses),
          f"resnet_trainer: ResNet-20 losses {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]),
          f"resnet_trainer: ResNet-20 loss did not fall: {losses}")
    check(all(not torch.equal(a, b) for a, b in zip(after, before)),
          "resnet_trainer: running statistics did not change")
    check([v["neval"] for v in vals] == [CIFAR_VALID_EVERY, CIFAR_STEPS]
          and all(v[k]["count"] == CIFAR_HELD_OUT for v in vals
                  for k in ("Top1Accuracy", "Loss")),
          f"resnet_trainer: validations {vals}")
    emit("resnet_trainer", resnet50={
        **res, "step_ms": step_s * 1e3, "peak_mem_gib": peak,
        "forward_gflops_per_image": fwd_flops / 1e9,
        "forward_gmac_per_image": gmac, "model_flops_share": share,
        "seconds": perf_s},
        resnet20={"steps": CIFAR_STEPS, "batch": CIFAR_BATCH,
                  "losses": losses, "validations": vals,
                  "seconds": time.perf_counter() - t1})


def phase_resnet_profile():
    """Where a ResNet-50 step goes (`--profile` only): the resnet_trainer
    step (bf16, batch 256, SGD) once under torch.profiler after one
    warm-up step: device-busy share, the top device operations, and
    the device time and launches by kind (PROFILE_KINDS: convolutions,
    copies and relayouts, reductions, pooling, element-wise), and the
    ATen ops behind the copies (casts, relayouts, clones)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.models import perf

    t0 = time.perf_counter()
    kw = {k: v for k, v in RESNET_PERF.items() if k != "iterations"}
    step = perf.train_step(**kw)
    float(step(0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        float(step(1))
        t_wall = time.perf_counter() - t_wall
    averages = prof.key_averages()
    # where the copies come from: the ATen ops that launch them (dtype
    # casts, relayouts to a memory format, clones), with the device time
    # of what each launched
    copy_ops = {e.key: {"calls": e.count, "device_ms": e.device_time_total
                        / 1e3} for e in averages
                if e.key in ("aten::_to_copy", "aten::contiguous",
                             "aten::clone", "aten::copy_")}
    copies = sorted(((e.self_device_time_total, e.count, e.key)
                     for e in averages
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0
                     and PROFILE_KINDS[1][1].search(e.key)
                     and not PROFILE_KINDS[0][1].search(e.key)),
                    reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "resnet_train_trace.json"))
    emit("resnet_profile", **_profile_rows(prof, t_wall, n_top=15),
         copy_ops=copy_ops,
         copy_top=[{"name": k[:100], "calls": c, "ms": us / 1e3}
                   for us, c, k in copies[:8]],
         seconds=time.perf_counter() - t0)


# ------------------------------------------------- CNN zoo and TreeLSTM
# BASELINE configs 3 (Inception-v1), 5 (VGG-16 transfer learning through
# the estimator) and 4's TreeLSTM half. No Pallas kernel of the JAX
# package lies on these paths: convolutions run on cuDNN, pooling on
# ATen, the TreeLSTM is plain PyTorch.
INCEPTION_PERF = dict(model_name="inception-v1", batch_size=256,
                      iterations=10, optimizer="sgd", precision="bf16")
VGG_PERF = dict(model_name="vgg16", batch_size=128, iterations=10,
                optimizer="sgd", precision="bf16")
# one short run each, so that every entry of perf.py's table runs here
SHORT_PERF = (dict(model_name="alexnet", batch_size=128, iterations=3,
                   optimizer="sgd", precision="bf16"),
              dict(model_name="inception-v2", batch_size=64, iterations=3,
                   optimizer="sgd", precision="bf16"))
# forward MACs an image counted from the conv and linear shapes
# (`_forward_flops`; 1.583 and 15.470 GMAC on the CPU)
INCEPTION_GMAC, VGG16_GMAC = (1.5, 1.65), (15.4, 15.55)
INCEPTION_MODEL_BATCH, INCEPTION_FWD_TOL = 2, 1e-4
VGG_TRANSFER = dict(classes=10, batch=128, steps=3)
# bench.py:602 bench_treelstm's widths
TREE_VOCAB, TREE_EMBED, TREE_HIDDEN, TREE_CLASSES = 20000, 300, 150, 5
TREE_BATCH, TREE_NODES, TREE_LR = 128, 64, 3e-3
TREE_POOL_BATCHES, TREE_HELD_OUT, TREE_VALID_EVERY = 4, 256, 6
TREE_WARMUP, TREE_STEPS = 2, 10
# wavefront vs slot scan on the card: tests/test_torch_treelstm.py's
# SCHEDULE_TOL (the JAX package's own, tests/test_treelstm.py:148-174)
TREE_SCHEDULE_TOL = dict(rtol=1e-5, atol=1e-6)


def _profile_rows(prof, wall_s, n_top=10):
    """Device time of a profiled window: busy share against the
    window's wall time, launches, by kind (PROFILE_KINDS) and the
    `n_top` largest device operations."""
    from torch.autograd import DeviceType

    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        return {"device_ms": "not measured"}
    dev_ms = sum(r[0] for r in rows) / 1e3
    kinds = {}
    for us, c, k in rows:
        kind = next((n for n, rx in PROFILE_KINDS if rx.search(k)), "other")
        calls, ms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (calls + c, ms + us / 1e3)
    return {"profiled_wall_ms": wall_s * 1e3, "device_ms": dev_ms,
            "busy_share": dev_ms / (wall_s * 1e3),
            "kernels": sum(r[1] for r in rows),
            "by_kind": {k: {"calls": c, "ms": ms}
                        for k, (c, ms) in kinds.items()},
            "top": [{"name": k[:100], "calls": c, "ms": us / 1e3}
                    for us, c, k in rows[:n_top]]}


def _profile_call(fn, trace: str) -> dict:
    """One call of `fn` (ending in a host read) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / trace))
    return _profile_rows(prof, t)


def _perf_cell(spec, gmac_range=None, step=None, profile_trace=None):
    """`perf.run_perf(**spec)` on the card (with `step` timed in place
    of a new one): images/s, step ms, peak memory; with `gmac_range`
    the forward counted from the conv and linear shapes, checked, and
    the model-flops share (3 x forward flops a step over the card's
    dense bf16 peak); with `profile_trace` one more step under
    torch.profiler (busy share, device time by kind)."""
    import torch

    from bigdl_tpu_torch.models import perf

    t0 = time.perf_counter()
    out = {}
    if gmac_range is not None:
        fmodel, shape, _ = perf._build_model(spec["model_name"], 1000)
        fwd_flops = _forward_flops(
            fmodel, fmodel.init(torch.Generator().manual_seed(0)), shape)
        gmac = fwd_flops / 2e9
        check(gmac_range[0] < gmac < gmac_range[1],
              f"{spec['model_name']}: forward {gmac:.3f} GMAC an image")
        del fmodel
        out.update(forward_gflops_per_image=fwd_flops / 1e9,
                   forward_gmac_per_image=gmac)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = perf.run_perf(**spec, step=step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = res["steady_wall_s"] / res["iterations"]
    check(math.isfinite(res["images_per_sec"]) and res["images_per_sec"] > 0,
          f"{spec['model_name']}: {res}")
    out.update(res, step_ms=step_s * 1e3, peak_mem_gib=peak)
    if gmac_range is not None:
        out["model_flops_share"] = 3 * out["forward_gflops_per_image"] \
            * 1e9 * res["batch_size"] / step_s / BF16_FLOPS_PER_S
    if profile_trace is not None:
        i = res["iterations"] + 1
        out["profile"] = _profile_call(lambda: float(step(i)),
                                       profile_trace)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_inception_trainer():
    """BASELINE config 3: `perf.run_perf("inception-v1", 256, 10,
    optimizer="sgd", precision="bf16")` at bench.py:2056's batch, 224 x
    224 x 3, 1000 classes (Dropout(0.4) drawing its masks on the card):
    images/s, step ms, peak memory, the forward counted from the conv
    and linear shapes (checked against INCEPTION_GMAC), the model-flops
    share and, from one more step under torch.profiler, the device-busy
    share. Then `build(fused_branches=True)` (its inception layers are
    nn.Graphs) forward in fp32 on the card against the same forward on
    the CPU at batch INCEPTION_MODEL_BATCH (<= INCEPTION_FWD_TOL of the
    largest log-probability); then AlexNet and Inception-v2, one short
    `run_perf` each (SHORT_PERF)."""
    import torch

    from bigdl_tpu_torch.models import inception, perf
    from bigdl_tpu_torch.models.convert import tree_map

    t0 = time.perf_counter()
    kw = {k: v for k, v in INCEPTION_PERF.items() if k != "iterations"}
    step = perf.train_step(**kw)
    v1 = _perf_cell(INCEPTION_PERF, INCEPTION_GMAC, step,
                    "inception_train_trace.json")
    del step
    torch.cuda.empty_cache()

    model = inception.build(1000, fused_branches=True)
    variables = model.init(torch.Generator().manual_seed(3), "cpu")
    x = torch.rand((INCEPTION_MODEL_BATCH, 224, 224, 3),
                   generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref, _ = model.apply(variables, x)
        out, _ = model.apply(tree_map(lambda t: t.cuda(), variables),
                             x.cuda())
    out = out.cpu()
    fused_err = _rel_err(out, ref)
    check(tuple(out.shape) == (INCEPTION_MODEL_BATCH, 1000)
          and bool(torch.isfinite(out).all())
          and fused_err <= INCEPTION_FWD_TOL,
          f"inception_trainer: fused forward {fused_err:.3g}")
    torch.cuda.empty_cache()
    short = {spec["model_name"]: _perf_cell(spec) for spec in SHORT_PERF}
    emit("inception_trainer", inception_v1=v1,
         fused_forward={"batch": INCEPTION_MODEL_BATCH,
                        "graph_layers": sum(
                            type(m).__name__ == "Graph"
                            for m in model.modules_),
                        "rel_err_vs_cpu": fused_err},
         **{k.replace("-", "_"): v for k, v in short.items()},
         seconds=time.perf_counter() - t0)


def _layer_inputs(model, variables, shape, classes) -> dict:
    """{class name: [the input of each call]} for `classes`, recorded
    from a batch-1 forward on the card (inputs detached, on the card)."""
    import torch

    seen = {c.__name__: [] for c in classes}
    applies = {c: c.apply for c in classes}

    def spy(cls):
        def apply(self, v, x, **kw):
            seen[cls.__name__].append(x)
            return applies[cls](self, v, x, **kw)
        return apply

    for c in classes:
        c.apply = spy(c)
    try:
        with torch.no_grad():
            model.apply(variables, torch.zeros((1,) + shape, device="cuda"))
    finally:
        for c in classes:
            c.apply = applies[c]
    return seen


def phase_inception_profile():
    """Inception-v1's LRN and concat share (`--profile` only): the two
    SpatialCrossMapLRN layers and the nine inception Concats (their
    branches' outputs joined by torch.cat), forward and backward at the
    bf16 step's shapes (INCEPTION_PERF's batch), each timed alone with
    CUDA events (`cuda_ms`), against the device time of one profiled
    inception_trainer step."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import perf

    t0 = time.perf_counter()
    kw = {k: v for k, v in INCEPTION_PERF.items() if k != "iterations"}
    step = perf.train_step(**kw)
    float(step(0))
    prof = _profile_call(lambda: float(step(1)), "inception_step_trace.json")
    model = step.model
    del step
    torch.cuda.empty_cache()
    seen = _layer_inputs(model, model.init(torch.Generator().manual_seed(0)),
                         (224, 224, 3), (nn.SpatialCrossMapLRN, nn.Concat))
    b = INCEPTION_PERF["batch_size"]
    lrn = [m for m in model.modules_ if isinstance(m, nn.SpatialCrossMapLRN)]
    concats = [m for m in model.modules_ if isinstance(m, nn.Concat)]
    empty = {"params": {}, "state": {}}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def fwd_bwd(fn, xs):
        xs = [torch.randn((b,) + tuple(x.shape[1:]), device="cuda",
                          dtype=torch.bfloat16, requires_grad=True)
              for x in xs]
        y = fn(xs)
        g = torch.randn_like(y)
        return cuda_ms(lambda: torch.autograd.grad(fn(xs), xs, g), flush,
                       reps=10, warmup=2)

    lrn_ms = [fwd_bwd(lambda xs, m=m: m.apply(empty, xs[0])[0], [x])
              for m, x in zip(lrn, seen["SpatialCrossMapLRN"])]
    # a Concat's inputs: the branches' outputs, recorded by one forward
    cat_shapes = []
    for m, x in zip(concats, seen["Concat"]):
        with torch.no_grad():
            v = m.init(torch.Generator().manual_seed(0))
            cat_shapes.append([c.apply(m._child_vars(v, k), x)[0]
                               for k, c in zip(m._keys, m.modules_)])
    cat_ms = [fwd_bwd(lambda xs: torch.cat(xs, dim=-1), outs)
              for outs in cat_shapes]
    del flush
    dev = prof.get("device_ms")
    share = (lambda ms: sum(ms) / dev) if isinstance(dev, float) \
        else (lambda ms: "not measured")
    torch.cuda.synchronize()
    emit("inception_profile", batch=b, step=prof,
         lrn_ms=lrn_ms, lrn_share_of_step_device=share(lrn_ms),
         concat_ms=cat_ms, concat_share_of_step_device=share(cat_ms),
         seconds=time.perf_counter() - t0)


def _vgg_frame(n, classes, seed):
    """A dict-of-lists DataFrame of seeded synthetic 224 x 224 x 3
    images with labels in [0, classes) (the card's machine has no
    pandas)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    images = rng.rand(n, 224, 224, 3).astype(np.float32)
    return {"features": list(images),
            "label": [int(v) for v in rng.randint(0, classes, n)]}


def phase_vgg_estimator():
    """BASELINE config 5. First `perf.run_perf("vgg16", 128, 10,
    optimizer="sgd", precision="bf16")` at bench.py:2060's batch (the
    same fields as inception_trainer). Then the transfer leg: VGG-16's
    ImageNet body (every layer but the 1000-class Linear and its
    LogSoftMax) with the weights that run trained, a new 10-class
    Linear head, fit by `DLClassifier(...).set_batch_size(128)` over a
    dict-of-lists frame of seeded synthetic images for
    VGG_TRANSFER["steps"] steps (fp32, SGD(1e-2)), then `transform`.
    Gates: the body's weights at the start of the fit are the trained
    ones (and not the perf run's initial ones), losses finite, every
    prediction in [0, 10), as many predictions as rows."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ml import DLClassifier
    from bigdl_tpu_torch.models import perf
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.optim import Trigger

    t0 = time.perf_counter()
    kw = {k: v for k, v in VGG_PERF.items() if k != "iterations"}
    step = perf.train_step(**kw)
    first = "0_SpatialConvolution"
    initial = step.variables()["params"][first]["weight"].detach().clone()
    cell = _perf_cell(VGG_PERF, VGG16_GMAC, step, "vgg_train_trace.json")

    t1 = time.perf_counter()
    trained = step.variables()
    trained_first = trained["params"][first]["weight"].detach().clone()
    body = nn.Sequential(*step.model.modules_[:-2])
    full = nn.Sequential(body, nn.Linear(4096, VGG_TRANSFER["classes"])
                         .set_name("head"), nn.LogSoftMax())
    variables = full.init(torch.Generator().manual_seed(5))
    variables["params"]["0_Sequential"] = {
        k: trained["params"][k] for k in body._keys}
    variables["state"]["0_Sequential"] = {
        k: trained["state"][k] for k in body._keys}
    full.variables = tree_map(lambda t: t.detach(), variables)
    del step, trained, variables
    torch.cuda.empty_cache()
    n = VGG_TRANSFER["batch"] * VGG_TRANSFER["steps"]
    frame = _vgg_frame(n, VGG_TRANSFER["classes"], 6)
    losses, start = [], {}

    def end_when(state):
        if state["neval"] == 0:     # what the fit starts from
            w = full.variables["params"]["0_Sequential"][first]["weight"]
            start["trained"] = torch.equal(w, trained_first)
            start["initial"] = torch.equal(w, initial)
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] >= VGG_TRANSFER["steps"]

    torch.cuda.synchronize()
    t_fit = time.perf_counter()
    fitted = DLClassifier(full, nn.ClassNLLCriterion(), [224, 224, 3]) \
        .set_batch_size(VGG_TRANSFER["batch"]) \
        .set_end_when(Trigger(end_when)).fit(frame)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t_fit
    t_tr = time.perf_counter()
    out = fitted.transform(frame)
    t_tr = time.perf_counter() - t_tr
    losses = [float(v) for v in losses]
    preds = np.asarray(out["prediction"])
    moved = not torch.equal(
        fitted.model.variables["params"]["0_Sequential"][first]["weight"],
        trained_first)
    from_trained = start.get("trained") is True \
        and start.get("initial") is False
    check(from_trained, "vgg_estimator: the body does not start from the "
          "perf run's trained weights")
    check(len(losses) == VGG_TRANSFER["steps"]
          and all(math.isfinite(v) for v in losses),
          f"vgg_estimator: losses {losses}")
    check(len(preds) == n and preds.dtype.kind == "i"
          and bool(((preds >= 0) & (preds < VGG_TRANSFER["classes"])).all()),
          f"vgg_estimator: predictions {preds[:8]} ({len(preds)} of {n})")
    emit("vgg_estimator", vgg16=cell, transfer={
        "rows": n, "batch": VGG_TRANSFER["batch"],
        "steps": VGG_TRANSFER["steps"], "losses": losses,
        "body_from_trained": from_trained, "body_moved_in_fit": moved,
        "fit_s": t_fit, "transform_s": t_tr,
        "prediction_counts": np.bincount(
            preds, minlength=VGG_TRANSFER["classes"]).tolist(),
        "seconds": time.perf_counter() - t1},
        seconds=time.perf_counter() - t0)


def _tree_samples(n, seed):
    """Seeded random trees built as bench.py's bench_treelstm builds them
    ((TREE_NODES + 1) // 2 leaves merged pairwise at random), each as a
    (word, left, right, is_leaf, mask, level) Sample; class y draws its
    leaves from its own block of the vocabulary, so the loss can fall
    in a few steps (the bench's labels are random)."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.treelstm import encode_from_nested

    rng = np.random.RandomState(seed)
    block = TREE_VOCAB // TREE_CLASSES
    keys = ("word", "left", "right", "is_leaf", "mask", "level")
    out, levels = [], 0
    for _ in range(n):
        y = int(rng.randint(0, TREE_CLASSES))
        nodes = [int(rng.randint(y * block, (y + 1) * block))
                 for _ in range((TREE_NODES + 1) // 2)]
        while len(nodes) > 1:
            i = int(rng.randint(0, len(nodes) - 1))
            nodes[i:i + 2] = [(nodes[i], nodes[i + 1])]
        e = encode_from_nested(nodes[0], TREE_NODES)
        levels = max(levels, e["n_levels"])
        out.append(Sample(tuple(e[k] for k in keys), np.int32(y)))
    return out, levels


def _tree_model(max_levels):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.treelstm import BinaryTreeLSTM

    return nn.Sequential(BinaryTreeLSTM(
        TREE_VOCAB, TREE_EMBED, TREE_HIDDEN, TREE_CLASSES,
        max_levels=max_levels), nn.Select(2, 1))


def _tree_schedules(samples, max_levels):
    """One batch, one set of weights, fp32 on the card: the wavefront's
    and the slot scan's loss and gradients (worst excess over
    TREE_SCHEDULE_TOL, <= 0 passes), then each schedule's bf16
    loss-and-backward time (3 calls after one warm-up)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    model = _tree_model(max_levels)
    v = model.init(torch.Generator().manual_seed(8))
    batch = samples[:TREE_BATCH]
    six = tuple(torch.as_tensor(np.stack([s.feature[i] for s in batch]))
                .cuda() for i in range(6))
    y = torch.as_tensor(np.stack([s.label for s in batch])).cuda()

    def run(inputs, policy):
        leaves = [t.requires_grad_() for t in tree_leaves(v["params"])]
        loss, _ = build_train_loss(model, nn.ClassNLLCriterion(), policy)(
            v["params"], v["state"], inputs, y, None)
        return loss, torch.autograd.grad(loss, leaves)

    wl, wg = run(six, None)
    sl, sg = run(six[:5], None)
    rtol, atol = TREE_SCHEDULE_TOL["rtol"], TREE_SCHEDULE_TOL["atol"]
    excess = max(float(((a - b).abs() - (atol + rtol * b.abs())).max())
                 for a, b in zip((wl.detach(),) + wg, (sl.detach(),) + sg))
    check(math.isfinite(float(wl)) and excess <= 0,
          f"treelstm_trainer: wavefront vs slot scan off by {excess:.3g} "
          f"over {TREE_SCHEDULE_TOL}")
    times = {}
    for name, inputs in (("wavefront", six), ("slot_scan", six[:5])):
        run(inputs, DEFAULT_MIXED)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            run(inputs, DEFAULT_MIXED)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) / 3 * 1e3
    return {"loss": float(wl), "slot_scan_loss": float(sl),
            "max_excess_over_tol": excess,
            "max_rel_grad_err": max(_rel_err(a, b) for a, b in zip(wg, sg)),
            "bf16_loss_and_backward_ms": times}


def phase_treelstm_trainer():
    """BASELINE config 4's TreeLSTM half at bench.py:602 bench_treelstm's
    widths (vocab 20000, d 300, h 150, 5 classes, batch 128, max_nodes
    64, Adam(3e-3), bf16 mixed): `Optimizer(Sequential(BinaryTreeLSTM(
    ..., max_levels), Select(2, 1)), DataSet.array(...), ClassNLL,
    batch_size=128).set_validation(Trigger.several_iteration(6),
    held-out trees, [TreeNNAccuracy(), Loss(...)]).optimize()` on the
    wavefront schedule over a pool of TREE_POOL_BATCHES batches of
    seeded trees, TREE_WARMUP + TREE_STEPS steps (validation time kept
    apart from the step time): samples/s, step ms. Gates: losses finite
    and falling (the last 3 below the first 3), validations after steps
    6 and 12 with whole counts. Then one more step under torch.profiler
    (busy share) and the schedule check (`_tree_schedules`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import (Adam, Loss, Optimizer,
                                       TreeNNAccuracy, Trigger)

    t0 = time.perf_counter()
    train, lv_train = _tree_samples(TREE_BATCH * TREE_POOL_BATCHES, 0)
    held, lv_held = _tree_samples(TREE_HELD_OUT, 1)
    max_levels = max(lv_train, lv_held)
    data_s = time.perf_counter() - t0
    steps = TREE_WARMUP + TREE_STEPS
    losses, marks, validations = [], {"val_s": []}, []
    every = Trigger.several_iteration(TREE_VALID_EVERY)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def validate_now(state):
        fire = every(state)
        if fire and "t0" in marks and "t1" not in marks:
            torch.cuda.synchronize()        # validation time, kept apart
            marks["v0"] = time.perf_counter()
        return fire

    def end_when(state):
        if "v0" in marks:
            torch.cuda.synchronize()
            marks["val_s"].append(time.perf_counter() - marks.pop("v0"))
        res = state.get("validation")
        if res is not None and res is not marks.get("seen"):
            marks["seen"] = res                 # a validation just ran
            validations.append((state["neval"], {
                k: v.result() for k, v in res.items()}))
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == TREE_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks["t0"] = time.perf_counter()
        elif state["neval"] == steps:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.start()                        # one more step, profiled
            marks["p0"] = time.perf_counter()
        elif state["neval"] == steps + 1:
            torch.cuda.synchronize()
            marks["p1"] = time.perf_counter()
            prof.stop()
        return state["neval"] > steps

    model = _tree_model(max_levels).build(torch.Generator().manual_seed(0))
    Optimizer(model, DataSet.array(train), nn.ClassNLLCriterion(),
              batch_size=TREE_BATCH) \
        .set_optim_method(Adam(TREE_LR)).set_precision("bf16") \
        .set_validation(Trigger(validate_now), DataSet.array(held),
                        [TreeNNAccuracy(), Loss(nn.ClassNLLCriterion())]) \
        .set_end_when(Trigger(end_when)).optimize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses][:steps]
    dt = marks["t1"] - marks["t0"] - sum(marks["val_s"])
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"treelstm_trainer: losses {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]),
          f"treelstm_trainer: loss did not fall: {losses}")
    check([n for n, _ in validations] == [TREE_VALID_EVERY, steps]
          and all(r[k][1] == TREE_HELD_OUT and math.isfinite(r[k][0])
                  for _, r in validations
                  for k in ("TreeNNAccuracy", "Loss")),
          f"treelstm_trainer: validations {validations}")
    OUT_DIR.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT_DIR / "treelstm_train_trace.json"))
    profiled = _profile_rows(prof, marks["p1"] - marks["p0"])
    schedules = _tree_schedules(train, max_levels)
    emit("treelstm_trainer", steps=TREE_STEPS, warmup_steps=TREE_WARMUP,
         batch=TREE_BATCH, max_nodes=TREE_NODES, max_levels=max_levels,
         schedule="wavefront", seconds=dt, data_s=data_s,
         validation_seconds=marks["val_s"],
         step_ms=dt / TREE_STEPS * 1e3,
         samples_per_sec=TREE_STEPS * TREE_BATCH / dt,
         peak_mem_gib=peak, losses=losses,
         validations=[{"neval": n, **{k: {"value": v, "count": c}
                                     for k, (v, c) in r.items()}}
                      for n, r in validations],
         profile=profiled, schedules=schedules,
         total_seconds=time.perf_counter() - t0)


# -------------------------------------------------- the training plane
# slice 13: the text, record-file and TFRecord input pipelines with
# transformer chains, LBFGS, the criterions and the eager Module facade.
# The text LM phase feeds rnn.lstm_lm (K6/K7) from raw text; the others
# run no kernel of the table.
TEXT_SENTENCES, TEXT_WORDS, TEXT_LEN = 20000, 12000, (10, 80)
TEXT_HELD_OUT = 512
TEXT_WARMUP, TEXT_STEPS = 2, 30
TEXT_PIPE_BATCHES = 50          # batches the pipeline alone is timed over
# bf16 first step, kernels vs plain recurrences: loss (absolute) and
# gradients (relative, the rnn model tests' bf16 limit, the per-leaf
# rule of TRAIN_GRAD_FLOOR). At initialisation the loss hardly depends
# on the recurrence: on an H100 the kernels read 0 and 6.0e-3 off, a
# control that reads every LSTM layer's h as 0 1.8e-3 and 1.0, and the
# control must fail both limits.
TEXT_BF16_LOSS_TOL, TEXT_BF16_GRAD_TOL = 5e-4, 5e-2
RECORDS_N, RECORDS_SHARDS, RECORDS_BATCH = 50000, 8, 128
RECORDS_WARMUP, RECORDS_STEPS = 5, 200
RECORDS_PIPE_BATCHES = 50
CIFAR_MEAN, CIFAR_STD = (125.3, 122.9, 113.8), (63.0, 62.1, 66.7)
TFRECORD_N, TFRECORD_STEPS = 1024, 4
LBFGS_ITERS, LBFGS_HISTORY, LBFGS_MNIST = 20, 10, 1024
# Rosenbrock's minimizer within 1e-3 of (1, 1) on card and CPU (fp32:
# the two runs part at rounding level, cuDNN and the CPU summing in
# other orders, and the line search's branches follow); LeNet-5 in
# fp64, card vs CPU, final losses within 1e-6 of each other
LBFGS_X_TOL, LBFGS_LOSS_RTOL = 1e-3, 1e-6
CRITERION_TOL = 1e-5            # card vs CPU, of max(1, |CPU value|)


def _text_corpus(n, seed):
    """`n` generated sentences of TEXT_LEN words (purely alphabetic,
    first letter capitalised), the words drawn with Zipf frequencies
    (p ~ 1 / rank) from TEXT_WORDS distinct ones: at 20000 sentences
    the size of PTB's training text (~0.9M words)."""
    import numpy as np

    rng = np.random.RandomState(0)              # one vocabulary for all
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = {}
    while len(words) < TEXT_WORDS:
        words.setdefault("".join(rng.choice(letters, rng.randint(2, 11))))
    words = np.array(list(words))
    p = 1.0 / np.arange(1, TEXT_WORDS + 1)
    rng = np.random.RandomState(seed)
    lens = rng.randint(TEXT_LEN[0], TEXT_LEN[1] + 1, n)
    picks = words[rng.choice(TEXT_WORDS, int(lens.sum()), p=p / p.sum())]
    ends = np.cumsum(lens)
    return [" ".join(picks[e - k:e]).capitalize() for k, e in zip(lens, ends)]


def _text_pipeline(texts, dictionary):
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.text import (LabeledSentenceToSample,
                                              SentenceBiPadding,
                                              SentenceTokenizer,
                                              TextToLabeledSentence)

    return DataSet.array(texts) >> (
        SentenceTokenizer() >> SentenceBiPadding()
        >> TextToLabeledSentence(dictionary)
        >> LabeledSentenceToSample(LM_SEQ))


def _host_ms_per_batch(it, n):
    """Host ms a batch of drawing `n` batches from the iterator `it`
    (after one untimed batch)."""
    next(it)
    t = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t) / n * 1e3


def phase_text_lm():
    """The slice's main path: raw text to the LSTM LM. A generated corpus
    (TEXT_SENTENCES sentences, Zipf over TEXT_WORDS words), `Dictionary(
    ..., vocab_size=LM_VOCAB - 1)` (PTB's 10000 with the unknown bucket),
    the pipeline `DataSet.array(texts) >> (SentenceTokenizer() >>
    SentenceBiPadding() >> TextToLabeledSentence(d) >>
    LabeledSentenceToSample(LM_SEQ))` into `Optimizer(rnn.lstm_lm(
    LM_VOCAB, 128, 128, num_layers=LM_LAYERS), ...,
    TimeDistributedCriterion(ClassNLLCriterion(), size_average=True),
    batch_size=LM_BATCH)` with Adam(1e-3) in bf16, TEXT_WARMUP +
    TEXT_STEPS steps, validated by `Loss` over TEXT_HELD_OUT held-out
    sentences after the last. Gates: K6 and K7 launch exactly LM_LAYERS
    times a step each in the timed window (and the validation's
    forwards run the inference variant only); the first batch the
    Optimizer moved to the card (read where it moves it) equals a
    second host run of the same pipeline bit for bit; on that batch
    the first step through the kernels equals the same step through
    the plain recurrences (fp32: loss TRAIN_LOSS_TOL, gradients
    TRAIN_GRAD_TOL; bf16, the trainer's dtype and the mma kernels:
    loss TEXT_BF16_LOSS_TOL and gradients TEXT_BF16_GRAD_TOL, both of
    which a control with every LSTM layer's h read as 0 fails), and the
    trainer's first loss equals the kernel step's within
    TRAIN_LOSS_TOL; losses finite and falling. Reported: tokens/s, the
    pipeline's host ms a batch alone and its share of the step, the
    device's busy share over a profiled 3-step run."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import SampleToMiniBatch
    from bigdl_tpu_torch.dataset.text import Dictionary, SentenceBiPadding, \
        SentenceTokenizer
    from bigdl_tpu_torch.models import rnn
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.optim import Adam, Loss, Optimizer, Trigger
    from bigdl_tpu_torch.optim import optimizer as optimizer_module
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    t0 = time.perf_counter()
    texts = _text_corpus(TEXT_SENTENCES, 1)
    held = _text_corpus(TEXT_HELD_OUT, 2)
    tokens = list((SentenceTokenizer() >> SentenceBiPadding())(texts))
    n_words = sum(len(s) - 2 for s in tokens)
    d = Dictionary(tokens, vocab_size=LM_VOCAB - 1)
    check(d.vocab_size() == LM_VOCAB, f"text_lm: vocab {d.vocab_size()}")
    corpus_s = time.perf_counter() - t0

    def crit():
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)

    placed = []                                 # the first batch on the card
    to_device = optimizer_module._to_device

    def record(x, device):
        out = to_device(x, device)
        if len(placed) < 2 and isinstance(out, torch.Tensor):
            placed.append(out.clone())
        return out

    train = _text_pipeline(texts, d)
    lm = rnn.lstm_lm(LM_VOCAB, RNN_EMBED, RNN_HIDDEN, num_layers=LM_LAYERS)
    lm.build(torch.Generator().manual_seed(0))
    init = tree_map(lambda t: t.clone(), lm.variables["params"])
    counters = ("fwd_train_launches", "fwd_infer_launches", "bwd_launches")
    steps = TEXT_WARMUP + TEXT_STEPS
    losses, marks, validations = [], {"val_s": []}, []
    last = Trigger.several_iteration(steps)

    def validate_now(state):
        fire = last(state)
        if fire:
            torch.cuda.synchronize()            # validation time, kept apart
            marks["v0"] = time.perf_counter()
            marks["at_validation"] = {c: getattr(fr, c) for c in counters}
        return fire

    def end_when(state):
        if "v0" in marks:
            torch.cuda.synchronize()
            marks["val_s"].append(time.perf_counter() - marks.pop("v0"))
        res = state.get("validation")
        if res is not None and not validations:
            validations.append({k: v.result() for k, v in res.items()})
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == TEXT_WARMUP:
            torch.cuda.synchronize()
            for c in counters:                  # main path starts here
                setattr(fr, c, 0)
            marks["t0"] = time.perf_counter()
        elif state["neval"] == steps:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = {c: getattr(fr, c)   # main path ends here
                                 for c in counters}
        return state["neval"] >= steps

    optimizer_module._to_device = record
    try:
        Optimizer(lm, train, crit(), batch_size=LM_BATCH) \
            .set_optim_method(Adam(1e-3)).set_precision("bf16") \
            .set_validation(Trigger(validate_now), _text_pipeline(held, d),
                            [Loss(crit())], LM_BATCH) \
            .set_end_when(Trigger(end_when)).optimize()
    finally:
        optimizer_module._to_device = to_device
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"] - sum(marks["val_s"])
    launches = marks["launches"]
    valid_batches = -(-TEXT_HELD_OUT // LM_BATCH)
    train_part = {c: marks["at_validation"][c] for c in counters}
    check(train_part == {"fwd_train_launches": TEXT_STEPS * LM_LAYERS,
                         "bwd_launches": TEXT_STEPS * LM_LAYERS,
                         "fwd_infer_launches": 0},
          f"text_lm: launches before validation {train_part} != "
          f"{TEXT_STEPS} steps x {LM_LAYERS} layers")
    check(launches == {**train_part, "fwd_infer_launches":
                       valid_batches * LM_LAYERS},
          f"text_lm: launches {launches}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"text_lm: losses {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]),
          f"text_lm: loss did not fall: {losses}")
    (vloss, vcount), = [validations[0]["Loss"]]
    check(math.isfinite(vloss) and vcount == TEXT_HELD_OUT,
          f"text_lm: validation {validations}")

    # the first batch the Optimizer moved to the card against a second
    # host run of the pipeline
    host = next(iter(SampleToMiniBatch(LM_BATCH)(
        _text_pipeline(texts, d).data(train=True))))
    check(len(placed) == 2 and all(t.is_cuda for t in placed),
          f"text_lm: the first batch on the card: "
          f"{[(t.shape, t.device) for t in placed]}")
    x, y = placed
    check(np.array_equal(x.cpu().numpy(), host.input)
          and np.array_equal(y.cpu().numpy(), host.target),
          "text_lm: the first batch differs from a host run of the pipeline")

    # the first step through the kernels, the plain versions and the
    # control (plain, every LSTM layer's h read as 0)
    def zero_h(m):
        for layer in m:
            if isinstance(layer, nn.Recurrent):
                scan = layer.cell.fused_scan
                layer.cell.fused_scan = (
                    lambda p, zx, impl=None, scan=scan:
                    scan(p, zx, impl=impl) * 0)
        return m

    def grad_rel(got, want):
        top = max(float(g.abs().max()) for g in want)
        return max(float((a - b).abs().max()) / max(
            float(b.abs().max()), TRAIN_GRAD_FLOOR * top)
            for a, b in zip(got, want))

    step1 = {}
    for impl in ("cuda", "torch", "control"):
        m = zero_h(_rnn_model("lstm_lm", "torch")) if impl == "control" \
            else _rnn_model("lstm_lm", impl)
        for dtype, policy in (("fp32", None), ("bf16", DEFAULT_MIXED)):
            if impl == "control" and policy is None:
                continue
            p = tree_map(lambda t: t.detach().requires_grad_(), init)
            loss, _ = build_train_loss(m, crit(), policy)(
                p, m.init_state(), x, y, None)
            step1[impl, dtype] = (float(loss.detach()), torch.autograd.grad(
                loss, tree_leaves(p)))
    first = {"trainer_bf16_loss": losses[0]}
    for dtype in ("fp32", "bf16"):
        first[dtype] = {
            "loss_cuda": step1["cuda", dtype][0],
            "loss_torch": step1["torch", dtype][0],
            "loss_abs_diff": abs(step1["cuda", dtype][0]
                                 - step1["torch", dtype][0]),
            "grad_max_rel_diff": grad_rel(step1["cuda", dtype][1],
                                          step1["torch", dtype][1])}
    first["bf16_control"] = {
        "loss": step1["control", "bf16"][0],
        "loss_abs_diff": abs(step1["control", "bf16"][0]
                             - step1["torch", "bf16"][0]),
        "grad_max_rel_diff": grad_rel(step1["control", "bf16"][1],
                                      step1["torch", "bf16"][1])}
    first["trainer_loss_abs_diff"] = abs(losses[0] - step1["cuda", "bf16"][0])
    check(first["fp32"]["loss_abs_diff"] <= TRAIN_LOSS_TOL
          and first["fp32"]["grad_max_rel_diff"] <= TRAIN_GRAD_TOL,
          f"text_lm: first step fp32 {first['fp32']}")
    check(first["bf16"]["loss_abs_diff"] <= TEXT_BF16_LOSS_TOL
          and first["bf16"]["grad_max_rel_diff"] <= TEXT_BF16_GRAD_TOL,
          f"text_lm: first step bf16 {first['bf16']}")
    check(first["bf16_control"]["loss_abs_diff"] > TEXT_BF16_LOSS_TOL
          and first["bf16_control"]["grad_max_rel_diff"] > TEXT_BF16_GRAD_TOL,
          f"text_lm: the zero-h control passes the bf16 gate: "
          f"{first['bf16_control']}")
    check(first["trainer_loss_abs_diff"] <= TRAIN_LOSS_TOL,
          f"text_lm: the trainer's first loss {losses[0]} against the "
          f"kernel step's {step1['cuda', 'bf16'][0]}")

    # the pipeline alone on the host, and a profiled 3-step run
    pipe_ms = _host_ms_per_batch(iter(SampleToMiniBatch(LM_BATCH)(
        _text_pipeline(texts, d).data(train=True))), TEXT_PIPE_BATCHES)
    step_ms = dt / TEXT_STEPS * 1e3

    def three_steps():
        Optimizer(lm, _text_pipeline(texts, d), crit(), LM_BATCH) \
            .set_optim_method(Adam(1e-3)).set_precision("bf16") \
            .set_end_when(Trigger.max_iteration(3)).optimize()

    profiled = _profile_call(three_steps, "text_lm_trace.json")
    torch.cuda.synchronize()
    emit("text_lm", sentences=TEXT_SENTENCES, words=n_words,
         distinct_words=TEXT_WORDS, vocab=d.vocab_size(),
         corpus_and_dictionary_s=corpus_s, steps=TEXT_STEPS,
         warmup_steps=TEXT_WARMUP, batch=LM_BATCH, seq=LM_SEQ,
         layers=LM_LAYERS, seconds=dt, step_ms=step_ms,
         tokens_per_sec=TEXT_STEPS * LM_BATCH * LM_SEQ / dt,
         pipeline_ms_per_batch=pipe_ms,
         pipeline_share_of_step=pipe_ms / step_ms,
         validation_seconds=marks["val_s"],
         validation={"loss": vloss, "count": vcount},
         launches=launches, losses=losses,
         first_step=first,
         tolerance={"fp32": {"loss": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL},
                    "bf16": {"loss": TEXT_BF16_LOSS_TOL,
                             "grad_rel": TEXT_BF16_GRAD_TOL},
                    "trainer_loss": TRAIN_LOSS_TOL},
         profile=profiled, total_seconds=time.perf_counter() - t0)
    return launches


def _records_images(n, seed):
    """`n` learnable 32 x 32 x 3 u8 images: class y's images are its own
    colour (which no shift or flip changes) and its own pattern, plus
    noise. Returns (images, labels)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    classes = (rng.randint(0, 128, (10, 1, 1, 3))
               + rng.randint(0, 64, (10, 32, 32, 3))).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.int32)
    images = rng.randint(0, 64, (n, 32, 32, 3), dtype=np.uint8)
    images += classes[labels]
    return images, labels


def _timed_steps(model, dataset, batch, warmup, steps):
    """`Optimizer(model, dataset, ClassNLLCriterion(), batch)` with
    SGD(0.1, momentum 0.9) for warmup + steps steps; returns (losses,
    seconds of the last `steps`)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    losses, marks = [], {}

    def end_when(state):
        if state["loss"] is not None:
            losses.append(float(state["loss"]))
        if state["neval"] in (warmup, warmup + steps):
            torch.cuda.synchronize()
            marks[state["neval"]] = time.perf_counter()
        return state["neval"] >= warmup + steps

    Optimizer(model, dataset, nn.ClassNLLCriterion(), batch_size=batch) \
        .set_optim_method(SGD(learningrate=0.1, momentum=0.9)) \
        .set_end_when(Trigger(end_when)).optimize()
    return losses, marks[warmup + steps] - marks[warmup]


def phase_records_trainer():
    """Disk to ResNet-20: RECORDS_N learnable 32 x 32 x 3 u8 images in
    RECORDS_SHARDS BDLS shards (the CIFAR-10 train split's size) in a
    temporary directory; `RecordFileDataSet(shards, batch 128, CIFAR's
    mean/std, pad=4, hflip=True)` feeds `Optimizer(resnet.build_cifar(20,
    10), ..., SGD(0.1, momentum 0.9))` for RECORDS_WARMUP +
    RECORDS_STEPS steps, then `Evaluator` runs over the shards. The same
    model for the same steps fed from memory twice: through
    `PrefetchDataSet` with the same shifts, flips and queue (only the
    source differs from the disk run), and from `DataSet.array` of
    normalised Samples (no augmentation, batches stacked on the
    training thread). TFRecord leg: TFRECORD_N of the images through
    `write_image_examples` and `TFRecordDataSet(...) >> MapTransformer(
    normalize)` for TFRECORD_STEPS steps. Gates: the eval-mode batches
    equal the in-memory normalisation of the same arrays bit for bit;
    the loss falls; the evaluation counts every image. Reported:
    images/s from disk and from both memory feeds, the host ms a batch
    of the file
    prefetcher and of the TFRecord read (each alone), the busy share of
    a profiled 3-step disk run."""
    import tempfile

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (DataSet, MapTransformer,
                                         PrefetchDataSet, RecordFileDataSet,
                                         Sample,
                                         TFRecordDataSet, native,
                                         write_image_examples, write_shards)
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.optim import Evaluator, Loss, Top1Accuracy

    t0 = time.perf_counter()
    images, labels = _records_images(RECORDS_N, 21)
    mean = np.asarray(CIFAR_MEAN, np.float32)
    std = np.asarray(CIFAR_STD, np.float32)
    kw = dict(batch_size=RECORDS_BATCH, mean=CIFAR_MEAN, std=CIFAR_STD)
    steps = RECORDS_WARMUP + RECORDS_STEPS
    with tempfile.TemporaryDirectory(prefix="bdls-") as tmp:
        t = time.perf_counter()
        paths = write_shards(images, labels, tmp, RECORDS_SHARDS)
        write_s = time.perf_counter() - t
        shard_bytes = sum(Path(p).stat().st_size for p in paths)
        ds = RecordFileDataSet(paths, pad=4, hflip=True, **kw)
        try:
            # eval mode: the in-memory normalisation, bit for bit
            got = list(ds.data(train=False))
            check(sum(len(b.target) for b in got) == RECORDS_N
                  and np.array_equal(np.concatenate([b.target for b in got]),
                                     labels)
                  and all(np.array_equal(b.input, (images[i:i + len(
                      b.target)].astype(np.float32) - mean) / std)
                      for i, b in zip(np.cumsum([0] + [len(b.target)
                                                      for b in got]), got)),
                  "records_trainer: eval batches differ from the in-memory "
                  "normalisation")
            del got
            model = resnet.build_cifar(20, 10).build(
                torch.Generator().manual_seed(0))
            disk_losses, disk_s = _timed_steps(model, ds, RECORDS_BATCH,
                                               RECORDS_WARMUP, RECORDS_STEPS)
            scores = Evaluator(model).test(
                ds, [Top1Accuracy(), Loss(nn.ClassNLLCriterion())],
                RECORDS_BATCH)
            scores = {k: v.result() for k, v in scores.items()}
            profiled = _profile_call(lambda: _timed_steps(
                model, ds, RECORDS_BATCH, 0, 3), "records_trace.json")
        finally:
            ds.close()
        # the file prefetcher alone, on an otherwise idle host
        pf = native.FilePrefetcher(paths, pad=4, hflip=True, seed=1, **kw)
        try:
            prefetch_ms = _host_ms_per_batch(iter(pf), RECORDS_PIPE_BATCHES)
        finally:
            pf.close()
    check(all(math.isfinite(v) for v in disk_losses)
          and sum(disk_losses[-5:]) < sum(disk_losses[:5]),
          f"records_trainer: disk losses {disk_losses}")
    check(scores["Top1Accuracy"][1] == RECORDS_N
          and scores["Loss"][1] == RECORDS_N,
          f"records_trainer: evaluation {scores}")

    # the same model and steps fed from memory: the same work but the
    # source, then pre-normalised Samples
    mem = PrefetchDataSet(images, labels, pad=4, hflip=True, capacity=3, **kw)
    try:
        mem_losses, mem_s = _timed_steps(
            resnet.build_cifar(20, 10).build(torch.Generator().manual_seed(0)),
            mem, RECORDS_BATCH, RECORDS_WARMUP, RECORDS_STEPS)
    finally:
        mem.close()
    n_array = RECORDS_BATCH * steps
    samples = [Sample((images[i].astype(np.float32) - mean) / std,
                      labels[i]) for i in range(n_array)]
    array_losses, array_s = _timed_steps(
        resnet.build_cifar(20, 10).build(torch.Generator().manual_seed(0)),
        DataSet.array(samples), RECORDS_BATCH, RECORDS_WARMUP, RECORDS_STEPS)
    del samples
    check(all(math.isfinite(v) for v in mem_losses + array_losses),
          f"records_trainer: memory losses {mem_losses}, {array_losses}")

    # TFRecord: TFRECORD_N images, normalised by a chained map
    def normalize(s):
        return Sample((s.feature - mean) / std, s.label)

    with tempfile.TemporaryDirectory(prefix="tfrecord-") as tmp:
        path = str(Path(tmp) / "train-00000.tfrecord")
        t = time.perf_counter()
        write_image_examples(path, images[:TFRECORD_N], labels[:TFRECORD_N])
        tf_write_s = time.perf_counter() - t
        tfds = TFRecordDataSet(path) >> MapTransformer(normalize)
        check(tfds.size() == TFRECORD_N, f"tfrecord: size {tfds.size()}")
        first = next(tfds.data(train=False))
        check(np.array_equal(first.feature, (images[0].astype(np.float32)
                                             - mean) / std)
              and int(first.label) == int(labels[0]),
              "tfrecord: the first record differs from its image")
        tf_losses, tf_s = _timed_steps(
            resnet.build_cifar(20, 10).build(torch.Generator().manual_seed(0)),
            tfds, RECORDS_BATCH, 1, TFRECORD_STEPS)
        t = time.perf_counter()                 # one pass: CRCs and decode
        read = sum(1 for _ in tfds.data(train=False))
        tf_ms = (time.perf_counter() - t) / (read / RECORDS_BATCH) * 1e3
    check(all(math.isfinite(v) for v in tf_losses),
          f"tfrecord: losses {tf_losses}")
    disk_ips = RECORDS_STEPS * RECORDS_BATCH / disk_s
    mem_ips = RECORDS_STEPS * RECORDS_BATCH / mem_s
    array_ips = RECORDS_STEPS * RECORDS_BATCH / array_s
    emit("records_trainer", images=RECORDS_N, shards=RECORDS_SHARDS,
         shard_bytes=shard_bytes, write_s=write_s, batch=RECORDS_BATCH,
         steps=RECORDS_STEPS, warmup_steps=RECORDS_WARMUP,
         disk={"seconds": disk_s, "step_ms": disk_s / RECORDS_STEPS * 1e3,
               "images_per_sec": disk_ips, "losses": disk_losses},
         memory={"seconds": mem_s, "step_ms": mem_s / RECORDS_STEPS * 1e3,
                 "images_per_sec": mem_ips, "losses": mem_losses},
         array={"seconds": array_s, "step_ms": array_s / RECORDS_STEPS * 1e3,
                "images_per_sec": array_ips, "losses": array_losses},
         disk_over_memory=disk_ips / mem_ips,
         disk_over_array=disk_ips / array_ips,
         prefetcher_ms_per_batch=prefetch_ms,
         evaluation={k: {"value": v, "count": c}
                     for k, (v, c) in scores.items()},
         tfrecord={"images": TFRECORD_N, "write_s": tf_write_s,
                   "steps": TFRECORD_STEPS, "step_ms": tf_s / TFRECORD_STEPS
                   * 1e3, "read_ms_per_batch": tf_ms, "losses": tf_losses},
         profile=profiled, total_seconds=time.perf_counter() - t0)


def _rosenbrock(p):
    return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2


def phase_lbfgs():
    """LBFGS (optim/lbfgs.py) on the card: Rosenbrock in fp32 from
    (-1.2, 1) (100 iterations at most) on the card and on the CPU; then
    LeNet-5 at full width fitted on one fixed batch of LBFGS_MNIST
    synthetic MNIST images (LBFGS_ITERS iterations, history
    LBFGS_HISTORY, strong Wolfe; feval = ClassNLL of the forward): in
    fp32 on the card (timed), and in fp64 on the card and on the CPU,
    where the two runs take the same decisions. Gates: Rosenbrock's
    minimizer within LBFGS_X_TOL of (1, 1) on both devices; LeNet's
    fp32 loss below half its first; the fp64 runs' final losses within
    LBFGS_LOSS_RTOL of each other. Reported: ms an iteration and fevals
    an iteration of the fp32 card run, one feval's ms and what an
    iteration costs beyond its fevals (each decision reads a value on
    the host)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.models.convert import (tree_leaves, tree_map,
                                                tree_unflatten)
    from bigdl_tpu_torch.optim import LBFGS

    t0 = time.perf_counter()
    rosen = {}
    for dev in ("cuda", "cpu"):
        opt = LBFGS(max_iter=100, history_size=LBFGS_HISTORY)
        x, loss, it = opt.minimize(_rosenbrock, torch.tensor(
            [-1.2, 1.0], device=dev))
        rosen[dev] = {"x": x.cpu().tolist(), "loss": float(loss),
                      "iterations": it, "evals": opt.evals}
        check(max(abs(v - 1.0) for v in rosen[dev]["x"]) <= LBFGS_X_TOL
              and rosen[dev]["loss"] < 1e-6,
              f"lbfgs: Rosenbrock on {dev} ended at {rosen[dev]}")

    data = synthetic_mnist(LBFGS_MNIST, seed=3)
    xs = np.stack([s.feature for s in data]).astype(np.float32)
    ys = np.stack([s.label for s in data]).astype(np.int32)
    model = lenet.build(10)
    v0 = model.init(torch.Generator().manual_seed(1), device="cpu")
    crit = nn.ClassNLLCriterion()
    res = {}
    for dev, dtype in (("cuda", torch.float32), ("cuda", torch.float64),
                       ("cpu", torch.float64)):
        x = torch.as_tensor(xs, device=dev, dtype=dtype)
        y = torch.as_tensor(ys, device=dev)
        state = tree_map(lambda t: t.to(dev, dtype), v0["state"])

        def feval(p, x=x, y=y, state=state):
            return crit(model.apply({"params": p, "state": state}, x)[0], y)

        p0 = tree_map(lambda t: t.to(dev, dtype), v0["params"])
        first = float(feval(p0))
        opt = LBFGS(max_iter=LBFGS_ITERS, history_size=LBFGS_HISTORY,
                    line_search="wolfe")
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss, it = opt.minimize(feval, p0)
        loss = float(loss)                      # ends in a host read
        key = f"{dev}/{str(dtype)[6:]}"
        res[key] = {"first_loss": first, "loss": loss, "iterations": it,
                    "evals": opt.evals, "seconds": time.perf_counter() - t}
        if key == "cuda/float32":               # one feval and its gradient
            leaves = [t.detach().requires_grad_() for t in
                      tree_leaves(p0)]
            p = tree_unflatten(p0, leaves)
            times = []
            for _ in range(6):
                t = time.perf_counter()
                float(torch.autograd.grad(feval(p), leaves)[0].sum())
                times.append(time.perf_counter() - t)
            res[key]["feval_ms"] = statistics.median(times[1:]) * 1e3
    g32, g64, c64 = res["cuda/float32"], res["cuda/float64"], \
        res["cpu/float64"]
    check(math.isfinite(g32["loss"]) and g32["loss"] < 0.5 * g32["first_loss"],
          f"lbfgs: LeNet-5 fp32 loss did not fall: {g32}")
    rel = abs(g64["loss"] - c64["loss"]) / c64["loss"]
    check(rel <= LBFGS_LOSS_RTOL and g64["loss"] < 0.5 * g64["first_loss"],
          f"lbfgs: LeNet-5 fp64 card {g64} against CPU {c64}")
    emit("lbfgs", rosenbrock=rosen,
         lenet={"images": LBFGS_MNIST, "history": LBFGS_HISTORY,
                "max_iter": LBFGS_ITERS, **res,
                "ms_per_iteration": g32["seconds"] / g32["iterations"] * 1e3,
                "evals_per_iteration": g32["evals"] / g32["iterations"],
                # what an iteration costs beyond its fevals: the two-loop
                # recursion, the line search's arithmetic, the host reads
                "ms_per_iteration_beyond_fevals": (
                    g32["seconds"] - g32["evals"] * g32["feval_ms"] / 1e3)
                / g32["iterations"] * 1e3,
                "fp64_loss_rel_diff": rel,
                "fp64_same_path": (g64["iterations"], g64["evals"]) == (
                    c64["iterations"], c64["evals"])},
         tolerance={"x": LBFGS_X_TOL, "fp64_loss_rel": LBFGS_LOSS_RTOL},
         seconds=time.perf_counter() - t0)


def _criterion_cases():
    """Every criterion of nn/criterion.py with seeded fp32 inputs:
    name -> (criterion, inputs, target, packing) as
    tests/test_torch_criterions.py builds them, plus the five the
    earlier slices ported."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn

    rng = np.random.RandomState(31)
    n, c = 64, 10

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def pm1(*shape):
        return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)

    x, y = f(n, c), f(n, c)
    ids = rng.randint(0, c, n).astype(np.int64)
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    probs = (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    kl_t = rng.rand(n, c).astype(np.float32)
    kl_t[kl_t < 0.3] = 0.0
    seq = f(8, 16, c)
    seq_logp = (seq - np.log(np.exp(seq).sum(-1, keepdims=True))).astype(
        np.float32)
    return {
        "ClassNLL": (nn.ClassNLLCriterion(), [logp], ids, "one"),
        "CrossEntropy": (nn.CrossEntropyCriterion(), [x], ids, "one"),
        "MSE": (nn.MSECriterion(), [x], y, "one"),
        "TimeDistributed": (nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True), [seq_logp],
            rng.randint(0, c, (8, 16)).astype(np.int64), "one"),
        "ChunkedSoftmaxCE": (nn.ChunkedSoftmaxCE(), [seq_logp],
                             rng.randint(0, c, (8, 16)).astype(np.int64),
                             "one"),
        "Abs": (nn.AbsCriterion(), [x], y, "one"),
        "BCE": (nn.BCECriterion(torch.from_numpy(rng.rand(c).astype(
            np.float32)), size_average=False), [probs],
            (rng.rand(n, c) < 0.5).astype(np.float32), "one"),
        "SmoothL1": (nn.SmoothL1Criterion(), [2.0 * x], y, "one"),
        "Margin": (nn.MarginCriterion(0.5, squared=True), [x], pm1(n, c),
                   "one"),
        "MultiLabelMargin": (nn.MultiLabelMarginCriterion(), [x],
                             (rng.rand(n, c) < 0.4).astype(np.float32),
                             "one"),
        "HingeEmbedding": (nn.HingeEmbeddingCriterion(1.5), [2.0 * x],
                           pm1(n, c), "one"),
        "CosineEmbedding": (nn.CosineEmbeddingCriterion(0.1),
                            [x, x + 0.7 * y], pm1(n), "table"),
        "DistKLDiv": (nn.DistKLDivCriterion(), [logp], kl_t, "one"),
        "KLD": (nn.KLDCriterion(), [x, 0.5 * y], None, "table"),
        "L1Cost": (nn.L1Cost(), [x], None, "one"),
        "ClassSimplex": (nn.ClassSimplexCriterion(c), [x], ids, "one"),
        "Parallel": (nn.ParallelCriterion().add(nn.AbsCriterion(), 0.7)
                     .add(nn.SmoothL1Criterion(size_average=False), 1.3),
                     [x, 2.0 * y], [y, f(n, c)], "table"),
        "Multi": (nn.MultiCriterion().add(nn.CosineEmbeddingCriterion(0.1),
                                          0.6).add(nn.KLDCriterion(), 0.4),
                  [x, y], pm1(n), "table"),
        "MultiMargin": (nn.MultiMarginCriterion(p=2, margin=0.8), [x], ids,
                        "one"),
        "MarginRanking": (nn.MarginRankingCriterion(0.3), [x[:, 0], y[:, 0]],
                          pm1(n), "table"),
        "CosineProximity": (nn.CosineProximityCriterion(), [x], y, "one"),
    }


def phase_criterions():
    """All 21 criterions of nn/criterion.py, forward and the gradient with
    respect to every input, on the card against the CPU, fp32: each
    within CRITERION_TOL of max(1, the CPU value's largest entry). The
    table criterions take `utils/table` Tables."""
    import torch

    from bigdl_tpu_torch.utils.table import T

    report = {}
    for name, (crit, xs, target, how) in _criterion_cases().items():
        res = {}
        for dev in ("cuda", "cpu"):
            ts = [torch.as_tensor(a, device=dev).requires_grad_()
                  for a in xs]
            tgt = None if target is None else (
                T(*(torch.as_tensor(a, device=dev) for a in target))
                if isinstance(target, list)
                else torch.as_tensor(target, device=dev))
            loss = crit(T(*ts) if how == "table" else ts[0], tgt)
            grads = torch.autograd.grad(loss, ts)
            res[dev] = [loss.detach().cpu()] + [g.cpu() for g in grads]
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(res["cuda"], res["cpu"]))
        check(err <= CRITERION_TOL and all(bool(torch.isfinite(a).all())
                                           for a in res["cuda"]),
              f"criterions: {name} card vs CPU {err}")
        report[name] = {"loss": float(res["cuda"][0]), "max_rel_err": err}
    check(len(report) == 21, f"criterions: {len(report)} of 21")
    emit("criterions", tolerance=CRITERION_TOL, cases=report)


def phase_eager_facade():
    """The eager Module facade on the card: LeNet-5 and a batch-norm
    model (the CIFAR ResNet-20) built on `cuda`; `m.evaluate()(x)`
    equals `apply(..., training=False)` bit for bit; a training-mode
    eager forward stores the new running statistics (those of `apply(
    ..., training=True)`, bit for bit) and leaves the params in place;
    `get_parameters()` has the model's parameter count."""
    import torch

    from bigdl_tpu_torch.models import lenet, resnet
    from bigdl_tpu_torch.models.convert import tree_leaves

    report = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, model, shape in (
            ("lenet5", lenet.build(10), (16, 28, 28, 1)),
            ("resnet20", resnet.build_cifar(20, 10), (16, 32, 32, 3))):
        model.build(torch.Generator().manual_seed(0))
        x = torch.randn(shape, device="cuda", generator=g)
        check(model.is_training() and model.training() is model,
              f"eager_facade {name}: not in training mode by default")
        before = dict(model.variables)
        ref_out, ref_state = model.apply(before, x, training=True)
        out = model(x)
        check(torch.equal(out, ref_out)
              and model.variables["params"] is before["params"]
              and all(torch.equal(a, b) for a, b in zip(
                  tree_leaves(model.variables["state"]),
                  tree_leaves(ref_state))),
              f"eager_facade {name}: training forward")
        moved = sum(not torch.equal(a, b) for a, b in zip(
            tree_leaves(before["state"]), tree_leaves(model.variables[
                "state"])))
        check(moved == len(tree_leaves(before["state"])),
              f"eager_facade {name}: {moved} state leaves moved")
        check(model.evaluate() is model and not model.is_training(),
              f"eager_facade {name}: evaluate()")
        with torch.no_grad():
            ev = model(x)
        check(torch.equal(ev, model.apply(model.variables, x,
                                          training=False)[0]),
              f"eager_facade {name}: eval forward")
        vec = model.get_parameters()
        count = sum(t.numel() for _, t in model.parameters())
        check(vec.numel() == count and vec.device.type == "cuda",
              f"eager_facade {name}: get_parameters {vec.numel()} vs "
              f"{count}")
        report[name] = {"parameters": count, "state_leaves_moved": moved}
    emit("eager_facade", **report)


# ----------------------------------------------------- MultiHeadAttention
# the mha phase: nn.MultiHeadAttention at the 43M LM's attention widths
# (TRAIN_CONFIG: E = DIM = 512, 8 heads of 64, batch TRAIN_BATCH x
# TRAIN_SEQ) through the flash kernels (K2-K5), against the same layer
# with impl="torch" from the same weights
MHA_CROSS_SEQ = 512             # encoder rows of the cross-attention case
MHA_PAD_DIM = 640               # 8 heads of 80: the wrapper pads D to 128
MHA_LAYERS = 4                  # causal layers of the trained stack
MHA_SAMPLES = 32                # distinct training samples (4 batches)
MHA_PROMPT, MHA_NEW, MHA_CACHE = 512, 64, 640
MHA_DECODE_TOL = 1e-5
MHA_POISON_POS = 600            # a cache row past every decode clock


def _mha_step(module, params, xs, ct):
    """module.apply over `xs` (one tensor, or [queries, keys/values])
    and the gradients of sum(y * ct) with respect to every parameter, in
    the tree's order, with the flash launches the pair made."""
    import torch

    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    f0, b0 = _flash_counts()
    y, _ = module.apply({"params": p, "state": {}}, xs)
    grads = torch.autograd.grad((y * ct).sum(), tree_leaves(p))
    torch.cuda.synchronize()
    f1, b1 = _flash_counts()
    return y.detach(), grads, (f1 - f0, b1 - b0)


def _mha_case(name, embed, cross_seq, causal):
    """One fp32 MHA layer, forward and backward, kernels (impl None on
    CUDA tensors) against the plain version (impl "torch") from one set
    of weights and inputs: the output within FLASH_TOL's fp32 "out" of
    max(1, its largest entry), every parameter gradient within its
    "grad" of the gradient's largest entry, except the key bias's, zero
    in exact arithmetic (softmax is shift-invariant): there both routes
    must stay below "grad" of the largest gradient. Exact launches."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import tree_leaves_with_path
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    g = torch.Generator(device="cuda").manual_seed(len(name))
    params = nn.MultiHeadAttention(embed, HEADS).init(
        torch.Generator().manual_seed(3))["params"]
    xq = torch.randn(TRAIN_BATCH, TRAIN_SEQ, embed, device="cuda",
                     generator=g)
    xs = xq if cross_seq is None else [xq, torch.randn(
        TRAIN_BATCH, cross_seq, embed, device="cuda", generator=g)]
    ct = torch.randn(xq.shape, device="cuda", generator=g)
    runs = {impl: _mha_step(nn.MultiHeadAttention(embed, HEADS,
                                                  causal=causal, impl=impl),
                            params, xs, ct)
            for impl in (None, "torch")}
    (y, grads, launches), (y_ref, ref, ref_launches) = runs[None], \
        runs["torch"]
    tol = FLASH_TOL["fp32"]
    out_err = float((y - y_ref).abs().max()) / max(
        1.0, float(y_ref.abs().max()))
    top = max(float(b.abs().max()) for b in ref)
    errs = {}
    for (path, _), a, b in zip(tree_leaves_with_path(params), grads, ref):
        key = ".".join(map(str, path))
        errs[key] = (max(float(a.abs().max()), float(b.abs().max())) / top
                     if key == "bk" else _rel_err(a, b))
    check(out_err <= tol["out"], f"mha {name}: output {out_err:.3g}")
    check(max(errs.values()) <= tol["grad"],
          f"mha {name}: gradients {errs}")
    check(launches == (1, fa.BWD_LAUNCHES) and ref_launches == (0, 0),
          f"mha {name}: launches {launches} (plain {ref_launches})")
    return {"embed": embed, "head_dim": embed // HEADS,
            "kernel_head_dim": fa.kernel_head_dim(embed // HEADS),
            "kv_seq": cross_seq or TRAIN_SEQ, "causal": causal,
            "out_err": out_err, "grad_rel_err": errs,
            "launches": {"fwd": launches[0], "bwd": launches[1]}}


def _mha_samples(n, seed):
    """Seeded (S, E) sequences whose target is the sequence shifted by
    one step (row t is row t - 1): causal attention can learn it."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    x = np.random.RandomState(seed).randn(n, TRAIN_SEQ, DIM) \
        .astype(np.float32)
    y = np.roll(x, 1, axis=1)
    return [Sample(x[i], y[i]) for i in range(n)]


def _timed_optimize(model, samples, criterion, batch, warmup, steps,
                    optim, precision=None, validation=None, counters=None,
                    profile_trace=None, kernel_re=None):
    """Optimizer(...).optimize() for `warmup` + `steps` steps (plus one
    profiled step when `profile_trace` names a trace): the losses, the
    timed window's step ms (validation time inside it taken out),
    samples/s, the validations, the counts read over the window
    (counters = (zero, read): zero() at its start, read() at its end),
    and the profiled step's device rows (busy share, top device
    operations, the device ms of the kernels `kernel_re` matches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    end = warmup + steps
    last = end + (profile_trace is not None)
    losses, validations = [], []
    marks = {"val_s": []}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def validate_now(fire):
        def trig(state):
            f = fire(state)
            if f and "t0" in marks and "t1" not in marks:
                torch.cuda.synchronize()     # validation time, kept apart
                marks["v0"] = time.perf_counter()
            return f
        return trig

    def end_when(state):
        if "v0" in marks:
            torch.cuda.synchronize()
            marks["val_s"].append(time.perf_counter() - marks.pop("v0"))
        res = state.get("validation")
        if res is not None and res is not marks.get("seen"):
            marks["seen"] = res
            validations.append({"neval": state["neval"], **{
                k: v.result() for k, v in res.items()}})
        if state["loss"] is not None:
            losses.append(state["loss"])
        n = state["neval"]
        if n == warmup:
            torch.cuda.synchronize()
            if counters is not None:
                counters[0]()                   # main path starts here
            marks["t0"] = time.perf_counter()
        if n == end:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            if counters is not None:
                marks["counts"] = counters[1]()  # main path ends here
            if profile_trace is not None:
                prof.start()
                marks["p0"] = time.perf_counter()
        if n == last and profile_trace is not None:
            torch.cuda.synchronize()
            marks["p1"] = time.perf_counter()
            prof.stop()
        return n >= last

    o = Optimizer(model, DataSet.array(samples), criterion,
                  batch_size=batch).set_optim_method(optim) \
        .set_end_when(Trigger(end_when))
    if precision is not None:
        o.set_precision(precision)
    if validation is not None:
        trigger, held_out, methods = validation
        o.set_validation(Trigger(validate_now(trigger)), held_out, methods,
                         batch)
    o.optimize()
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"] - sum(marks["val_s"])
    check(len(losses) == last and all(math.isfinite(v) for v in losses),
          f"losses not all finite: {losses[:4]}...{losses[-4:]}")
    out = {"steps": steps, "warmup_steps": warmup, "batch": batch,
           "seconds": dt, "step_ms": dt / steps * 1e3,
           "samples_per_sec": steps * batch / dt,
           "validation_seconds": marks["val_s"], "losses": losses,
           "validations": validations, "counts": marks.get("counts")}
    if profile_trace is not None:
        OUT_DIR.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(OUT_DIR / profile_trace))
        out["profile"] = _profile_rows(prof, marks["p1"] - marks["p0"])
        if kernel_re is not None:
            from torch.autograd import DeviceType

            out["profile"]["kernel_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and re.search(kernel_re, e.key)) / 1e3
    return out


def phase_mha():
    """The slice's main path: nn.MultiHeadAttention on the flash kernels
    at the 43M LM's widths. (1) one causal self-attention layer, fp32,
    forward and backward, kernels vs plain; (2) cross-attention, 2048
    queries over MHA_CROSS_SEQ encoder rows, non-causal; (3) 8 heads of
    80 (MHA_PAD_DIM), padded to the 128 instantiation; (4) a Sequential
    of MHA_LAYERS causal layers trained by Optimizer in bf16 with
    MSECriterion for TRAIN_WARMUP + TRAIN_STEPS steps: the loss falls,
    the flash counts, zeroed after the warm-up, read layers x steps
    forward and x BWD_LAUNCHES backward; with --profile one more step
    under torch.profiler (busy share, flash ms a step); (5) fp32
    incremental decode: apply_prefill of MHA_PROMPT tokens, then
    MHA_NEW apply_decode steps, each row apply's row on the same tokens
    within MHA_DECODE_TOL, with NaN key and value rows written past one
    row's clock leaving every output finite."""
    import torch

    from bigdl_tpu_torch import nn
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    from bigdl_tpu_torch.optim import Adam

    t_phase = time.perf_counter()
    layers = {"self_causal": _mha_case("self_causal", DIM, None, True),
              "cross": _mha_case("cross", DIM, MHA_CROSS_SEQ, False),
              "padded_head_dim": _mha_case("padded_head_dim", MHA_PAD_DIM,
                                           None, True)}
    torch.cuda.empty_cache()

    model = nn.Sequential(*[nn.MultiHeadAttention(DIM, HEADS, causal=True)
                            for _ in range(MHA_LAYERS)])
    model.build(torch.Generator().manual_seed(0))
    profiled = "--profile" in sys.argv[1:]
    train = _timed_optimize(
        model, _mha_samples(MHA_SAMPLES, 21), nn.MSECriterion(),
        TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, Adam(1e-3), "bf16",
        counters=(_zero_flash_counts, _flash_counts),
        profile_trace="mha_train_trace.json" if profiled else None,
        kernel_re=r"fa_(fwd|dkdv|dq)_(bf16_)?kernel")
    fwd, bwd = train.pop("counts")
    losses = train["losses"]
    check(losses[-1] < losses[0], f"mha trainer loss did not fall: {losses}")
    want = (MHA_LAYERS * TRAIN_STEPS, MHA_LAYERS * TRAIN_STEPS
            * fa.BWD_LAUNCHES)
    check((fwd, bwd) == want, f"mha trainer launches {(fwd, bwd)} != {want}")
    train.update(layers=MHA_LAYERS, seq=TRAIN_SEQ,
                 tokens_per_sec=train["samples_per_sec"] * TRAIN_SEQ,
                 launches={"fwd": fwd, "bwd": bwd})
    if profiled:                     # the flash kernels' ms a step
        train["profile"]["flash_ms_per_step"] = train["profile"].pop(
            "kernel_ms", "not measured")
    del model
    torch.cuda.empty_cache()

    # (5) incremental decode, fp32
    m = nn.MultiHeadAttention(DIM, HEADS, causal=True)
    v = m.init(torch.Generator().manual_seed(5))
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(TRAIN_BATCH, MHA_PROMPT + MHA_NEW, DIM, device="cuda",
                    generator=g)
    with torch.no_grad():
        _zero_flash_counts()
        full, _ = m.apply(v, x)
        cache = m.init_cache(TRAIN_BATCH, MHA_CACHE, device="cuda")
        y, cache = m.apply_prefill(v, x[:, :MHA_PROMPT], cache)
        cache["k"][0, :, MHA_POISON_POS] = float("nan")
        cache["v"][0, :, MHA_POISON_POS] = float("nan")
        rows = [y]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MHA_PROMPT, MHA_PROMPT + MHA_NEW):
            pos = torch.full((TRAIN_BATCH,), t, dtype=torch.int32,
                             device="cuda")
            yt, cache = m.apply_decode(v, x[:, t], cache, pos)
            rows.append(yt[:, None])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        got = torch.cat(rows, dim=1)
        decode_launches = _flash_counts()
    err = float((got - full).abs().max())
    check(bool(torch.isfinite(got).all()),
          "mha decode: a NaN row past the clock reached the output")
    check(err <= MHA_DECODE_TOL, f"mha decode: rows {err:.3g} from apply's")
    check(decode_launches == (2, 0),
          f"mha decode: flash launches {decode_launches} (apply + prefill)")
    emit("mha", layers=layers, trainer=train,
         decode={"batch": TRAIN_BATCH, "prompt": MHA_PROMPT,
                 "new_tokens": MHA_NEW, "max_abs_err": err,
                 "tolerance": MHA_DECODE_TOL, "poisoned_row": MHA_POISON_POS,
                 "ms_per_step": decode_s / MHA_NEW * 1e3,
                 "flash_launches": decode_launches[0]},
         seconds=time.perf_counter() - t_phase)
    return fwd, bwd


# ------------------------------------------------------- the rest of nn/
# nn_extra: every layer of the activation, linear, table, upsampling,
# volumetric and sparse families the JAX package has, card vs CPU (no
# TPU kernel: the JAX package computes them outside Pallas). Sizes: the
# volumetric layers at a C3D clip (16 frames of 112 x 112 x 3, batch 8;
# conv1a's 64 filters, pool1's 1 x 2 x 2), the sparse layers at a wide
# model's 1,000,000 columns, capacity 64, batch 4096
SPARSE_COLS, SPARSE_CAP, SPARSE_BATCH = 1_000_000, 64, 4096
C3D_CLIP = (8, 16, 112, 112, 3)         # conv1a's input
C3D_POOL = (8, 16, 56, 56, 64)          # a pooling input at 56 x 56


def _sparse_batch(g):
    """A COO batch of SPARSE_BATCH rows over SPARSE_COLS columns: each
    row 1..SPARSE_CAP ids (pads at index 0, value 0)."""
    import torch

    cols, cap, batch = SPARSE_COLS, SPARSE_CAP, SPARSE_BATCH
    idx = torch.randint(0, cols, (batch, cap), generator=g)
    vals = torch.randn(batch, cap, generator=g)
    keep = torch.arange(cap)[None, :] < torch.randint(1, cap + 1, (batch, 1),
                                                      generator=g)
    return [torch.where(keep, idx, 0).to(torch.int32),
            torch.where(keep, vals, 0.0)]


def _nn_extra_cases():
    """(name, module factory, inputs(generator), table packing)."""
    import torch

    from bigdl_tpu_torch import nn

    def dense(*shapes):
        return lambda g: [torch.randn(s, generator=g) for s in shapes]

    return [
        ("prelu", lambda: nn.PReLU(64), dense((64, 28, 28, 64)), None),
        ("srelu", lambda: nn.SReLU((64,)), dense((64, 28, 28, 64)), None),
        ("rrelu_eval", lambda: nn.RReLU(), dense((64, 28, 28, 64)), None),
        ("cmul", lambda: nn.CMul((1, 512)), dense((256, 512)), None),
        ("cadd", lambda: nn.CAdd((512,)), dense((256, 512)), None),
        ("bilinear", lambda: nn.Bilinear(128, 96, 64),
         dense((256, 128), (256, 96)), "list"),
        ("cosine", lambda: nn.Cosine(256, 128), dense((512, 256)), None),
        ("euclidean", lambda: nn.Euclidean(256, 128), dense((512, 256)),
         None),
        ("mm", lambda: nn.MM(False, True), dense((16, 128, 64),
                                                 (16, 96, 64)), "list"),
        ("mv", lambda: nn.MV(True), dense((16, 128, 64), (16, 128)),
         "list"),
        ("dot_product", lambda: nn.DotProduct(), dense((512, 256),
                                                       (512, 256)), "list"),
        ("cosine_distance", lambda: nn.CosineDistance(),
         dense((512, 256), (512, 256)), "list"),
        ("upsample_nearest", lambda: nn.SpatialUpSamplingNearest(2),
         dense((16, 28, 28, 64)), None),
        ("upsample_bilinear_align", lambda: nn.SpatialUpSamplingBilinear(2),
         dense((16, 28, 28, 64)), None),
        ("upsample_bilinear_half", lambda: nn.SpatialUpSamplingBilinear(
            2, align_corners=False), dense((16, 28, 28, 64)), None),
        ("volumetric_conv_c3d", lambda: nn.VolumetricConvolution(
            3, 64, 3, 3, 3, 1, 1, 1, 1, 1, 1), dense(C3D_CLIP), None),
        ("volumetric_conv_same", lambda: nn.VolumetricConvolution(
            64, 64, 3, 3, 3, 2, 2, 2, pad_w=-1), dense(
                (C3D_POOL[0], C3D_POOL[1] // 2, C3D_POOL[2] // 2,
                 C3D_POOL[3] // 2, 64)), None),
        ("volumetric_max_pool_c3d", lambda: nn.VolumetricMaxPooling(
            1, 2, 2), dense(C3D_POOL), None),
        ("volumetric_avg_pool", lambda: nn.VolumetricAveragePooling(
            2, 2, 2, 2, 2, 2, 1, 1, 1), dense(C3D_POOL), None),
        ("sparse_linear", lambda: nn.SparseLinear(SPARSE_COLS, 16),
         _sparse_batch, "list"),
        ("lookup_sparse_mean", lambda: nn.LookupTableSparse(
            SPARSE_COLS, 64, "mean"), _sparse_batch, "list"),
        ("lookup_sparse_sqrtn", lambda: nn.LookupTableSparse(
            SPARSE_COLS, 16, "sqrtn"), _sparse_batch, "list"),
        ("lookup_sparse_sum", lambda: nn.LookupTableSparse(
            SPARSE_COLS, 16, "sum"), _sparse_batch, "list"),
        ("sparse_join_table", lambda: nn.SparseJoinTable(
            [SPARSE_COLS, SPARSE_COLS]),
         lambda g: [_sparse_batch(g), _sparse_batch(g)], "list"),
    ]


def phase_nn_extra():
    """Every layer of the activation, linear, table, upsampling,
    volumetric and sparse families on the card against the same layer
    on the CPU, fp32 with TF32 off, from one set of seeded variables and
    inputs (cnn_layers' pass: forward <= CNN_FWD_TOL, gradients of every
    parameter and float input <= CNN_GRAD_TOL of each one's largest
    entry); RReLU in evaluation, and in training its slopes within
    [lower, upper]; the SparseTensor products (mm, mv, dot, addmm,
    addmv) card vs CPU."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.sparse import SparseTensor, addmm, addmv

    t0 = time.perf_counter()
    results = {}
    for i, (name, factory, inputs, table) in enumerate(_nn_extra_cases()):
        module = factory()
        variables = _seeded_variables(
            module.init(torch.Generator().manual_seed(i), "cpu"), i)
        xs = inputs(torch.Generator().manual_seed(200 + i))
        if name == "sparse_join_table":
            xs = [tuple(p) for p in xs]
        ref_out, _, ref_grads, cts = _cnn_pass(module, variables, xs, table,
                                               False, "cpu")
        out, _, grads, _ = _cnn_pass(module, variables, xs, table, False,
                                     "cuda", cts)
        fwd = max(_rel_err(a, b) for a, b in zip(out, ref_out))
        grad = max((_rel_err(a, b) for a, b in zip(grads, ref_grads)),
                   default=0.0)
        results[name] = {"fwd_rel_err": fwd, "grad_rel_err": grad}
        check(all(a.shape == b.shape for a, b in zip(out, ref_out)),
              f"nn_extra {name}: output shapes differ")
        check(fwd <= CNN_FWD_TOL,
              f"nn_extra {name}: forward {fwd:.3g} > {CNN_FWD_TOL}")
        check(grad <= CNN_GRAD_TOL,
              f"nn_extra {name}: gradients {grad:.3g} > {CNN_GRAD_TOL}")
        del module, variables, xs, ref_out, ref_grads, out, grads, cts
    # RReLU in training: slopes drawn on the card, within the bounds
    rr = nn.RReLU(0.1, 0.4)
    x = -torch.rand(64, 28, 28, 64, device="cuda") - 0.5
    y, _ = rr.apply({"params": {}, "state": {}}, x, training=True,
                    rng=torch.Generator(device="cuda").manual_seed(1))
    slopes = y / x
    check(float(slopes.min()) >= 0.1 - 1e-6
          and float(slopes.max()) <= 0.4 + 1e-6,
          f"nn_extra rrelu_train: slopes in [{float(slopes.min())}, "
          f"{float(slopes.max())}]")
    # the SparseTensor math: (4096 x 100000) with 64 nonzeros a row
    g = torch.Generator().manual_seed(9)
    rows = torch.arange(SPARSE_BATCH).repeat_interleave(SPARSE_CAP)
    cols = torch.randint(0, 100_000, (rows.numel(),), generator=g)
    st = SparseTensor(torch.stack([rows, cols], 1),
                      torch.randn(rows.numel(), generator=g),
                      (SPARSE_BATCH, 100_000))
    dense = torch.randn(100_000, 32, generator=g)
    vec = torch.randn(100_000, generator=g)
    c = torch.randn(SPARSE_BATCH, 32, generator=g)
    yv = torch.randn(SPARSE_BATCH, generator=g)
    full = torch.randn(SPARSE_BATCH, 100_000, generator=g)

    def ops(s, dv, vv, cc, yy, ff):
        return [s.mm(dv), s.mv(vv), s.dot(ff)[None],
                addmm(0.5, cc, 2.0, s, dv), addmv(0.5, yy, 2.0, s, vv)]

    ref = ops(st, dense, vec, c, yv, full)
    cu = ops(st.to("cuda"), *(t.cuda() for t in (dense, vec, c, yv, full)))
    st_err = max(_rel_err(a.cpu(), b) for a, b in zip(cu, ref))
    check(st_err <= CNN_FWD_TOL, f"nn_extra sparse_tensor: {st_err:.3g}")
    results["sparse_tensor_ops"] = {"fwd_rel_err": st_err}
    emit("nn_extra", cases=len(results), seconds=time.perf_counter() - t0,
         max_fwd_rel_err=max(r["fwd_rel_err"] for r in results.values()),
         max_grad_rel_err=max(r.get("grad_rel_err", 0.0)
                              for r in results.values()),
         rrelu_train_slopes=[float(slopes.min()), float(slopes.max())],
         results=results)


# ---------------------------------------------------------------- int8
QUANT_LENET_HELD_OUT = 2048     # held-out images for the int8 top-1
QUANT_TOP1_GAP = 0.01           # int8 top-1 within 1 point of fp32's
QUANT_RESNET_BATCH, QUANT_RESNET_ITERS = 64, 5


def _images_per_sec(fn, batch, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return iters * batch / (time.perf_counter() - t0)


def _param_bytes(tree) -> int:
    from bigdl_tpu_torch.models.convert import tree_leaves

    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def phase_quantized(lenet_model):
    """INT8 inference (nn/quantized.py; products on cuBLASLt's int8 gemm
    through torch._int_mm). (1) The LeNet-5 lenet_trainer trained,
    quantized: held-out top-1 (QUANT_LENET_HELD_OUT images) of int8
    within QUANT_TOP1_GAP of fp32's; (2) ResNet-50 at 224 x 224, batch
    QUANT_RESNET_BATCH, seeded weights (cnn_layers' draws), eval mode:
    int8 against fp32 — top-1 agreement and the logits' relative error
    — images/s of both and weight bytes of both; (3) the int32
    accumulators of LeNet-5's and ResNet-50's first convolution and
    last Linear on the card equal the CPU plain version's (the fp64
    product) bit for bit, at row counts below _int_mm's minimum and K
    and N off its multiple of 8."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.nn import quantize
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy

    t0 = time.perf_counter()
    held = DataSet.array(synthetic_mnist(QUANT_LENET_HELD_OUT, seed=19))
    qlenet, qvars = quantize(lenet_model, lenet_model.variables)
    qlenet.variables = qvars
    top1 = {}
    for name, m in (("fp32", lenet_model), ("int8", qlenet)):
        top1[name], count = Evaluator(m).test(
            held, [Top1Accuracy()], LENET_BATCH)["Top1Accuracy"].result()
        check(count == QUANT_LENET_HELD_OUT, f"quantized lenet: {count}")
    gap = abs(top1["int8"] - top1["fp32"])
    check(gap <= QUANT_TOP1_GAP,
          f"quantized lenet: top-1 int8 {top1['int8']} vs fp32 "
          f"{top1['fp32']}")
    lenet_bytes = {"fp32": _param_bytes(lenet_model.variables["params"]),
                   "int8": _param_bytes(qvars["params"])}

    model = resnet.build_imagenet(50, 1000)
    variables = _seeded_variables(
        model.init(torch.Generator().manual_seed(0), "cpu"), 0)
    variables = tree_map(lambda t: t.cuda(), variables)
    qmodel, qv = quantize(model, variables)
    x = torch.randn(QUANT_RESNET_BATCH, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        ref, _ = model.apply(variables, x)
        got, _ = qmodel.apply(qv, x)
        check(bool(torch.isfinite(got).all()), "quantized resnet: not finite")
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        # seeded weights may send every image to a few classes, which
        # makes agreement easy: the spread of fp32's predictions says
        classes = int(ref.argmax(-1).unique().numel())
        logit_err = float((got - ref).norm() / ref.norm())
        ips = {"fp32": _images_per_sec(lambda: model.apply(variables, x),
                                       QUANT_RESNET_BATCH,
                                       QUANT_RESNET_ITERS),
               "int8": _images_per_sec(lambda: qmodel.apply(qv, x),
                                       QUANT_RESNET_BATCH,
                                       QUANT_RESNET_ITERS)}
    resnet_bytes = {"fp32": _param_bytes(variables["params"]),
                    "int8": _param_bytes(qv["params"])}
    check(resnet_bytes["int8"] < 0.35 * resnet_bytes["fp32"],
          f"quantized resnet: weights {resnet_bytes}")

    # the accumulators, card vs CPU, bit for bit
    def first_and_last(seq, params):
        """The first conv and the last Linear of a Sequential, each
        with its params."""
        kinds = [type(m).__name__ for m in seq.modules_]
        i = kinds.index("QuantizedSpatialConvolution")
        j = len(kinds) - 1 - kinds[::-1].index("QuantizedLinear")
        return [(seq[k], params[seq._keys[k]]) for k in (i, j)]

    g = torch.Generator().manual_seed(4)
    accs = {}
    for name, (mod, mvars), shape in zip(
            ("lenet_conv1", "lenet_score", "resnet_conv1", "resnet_fc"),
            first_and_last(qlenet, qvars["params"])
            + first_and_last(qmodel, qv["params"]),
            ((64, 28, 28, 1), (3, 100), (2, 224, 224, 3), (5, 2048))):
        xin = torch.randn(shape, generator=g)
        cpu_vars = {"params": tree_map(lambda t: t.cpu(), mvars)}
        acc_cpu, s_cpu = mod.accumulate(cpu_vars, xin)
        acc_gpu, s_gpu = mod.accumulate({"params": mvars}, xin.cuda())
        equal = torch.equal(acc_gpu.cpu(), acc_cpu) and float(s_gpu) \
            == float(s_cpu)
        check(acc_gpu.dtype == torch.int32 and equal,
              f"quantized {name}: card accumulator differs from the CPU's")
        accs[name] = {"shape": list(acc_cpu.shape), "bitwise": equal,
                      "max_abs": int(acc_cpu.abs().max())}
    emit("quantized",
         lenet={"held_out": QUANT_LENET_HELD_OUT, "top1": top1,
                "gap": gap, "tolerance": QUANT_TOP1_GAP,
                "weight_bytes": lenet_bytes},
         resnet50={"batch": QUANT_RESNET_BATCH, "top1_agreement": agree,
                   "fp32_distinct_classes": classes,
                   "logits_rel_err": logit_err, "images_per_sec": ips,
                   "weight_bytes": resnet_bytes},
         accumulators=accs, seconds=time.perf_counter() - t0)


# --------------------------------------------- NCF, TextClassifier, AE
# NeuralCF at MovieLens-1M's sizes (6040 users, 3706 items, 1,000,209
# ratings in 5 classes with ML-1M's class shares), one epoch at batch
# 2048 on 90% of the ratings, validated on the other 10%; the
# TextClassifier at news20's (20 classes, vocabulary 20000, 500 tokens,
# GloVe-shaped 100-wide embedding, 128 filters), batch 128; the
# autoencoder at MNIST's 784 -> 32 -> 784, batch 256
NCF_USERS, NCF_ITEMS, NCF_RATINGS = 6040, 3706, 1_000_209
NCF_CLASS_SHARES = (0.0563, 0.1075, 0.2611, 0.3489, 0.2262)
NCF_BATCH, NCF_HELD_OUT = 2048, 0.1
TEXTCLS_CLASSES, TEXTCLS_VOCAB, TEXTCLS_LEN = 20, 20000, 500
TEXTCLS_EMBED, TEXTCLS_BATCH, AE_BATCH = 100, 128, 256


def _ncf_ratings(seed):
    """Seeded (user, item) pairs and 5-class ratings: a rank-8 score
    plus noise, cut at ML-1M's class shares."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.RandomState(seed)
    u = rng.randn(NCF_USERS, 8).astype(np.float32)
    v = rng.randn(NCF_ITEMS, 8).astype(np.float32)
    pairs = np.stack([rng.randint(0, NCF_USERS, NCF_RATINGS),
                      rng.randint(0, NCF_ITEMS, NCF_RATINGS)],
                     1).astype(np.int32)
    score = (u[pairs[:, 0]] * v[pairs[:, 1]]).sum(1) \
        + rng.randn(NCF_RATINGS).astype(np.float32)
    cuts = np.quantile(score, np.cumsum(NCF_CLASS_SHARES)[:-1])
    labels = np.searchsorted(cuts, score).astype(np.int32)
    return [Sample(p, y) for p, y in zip(pairs, labels)]


def _news20_samples(n, seed):
    """Seeded news20-like token ids: class c draws half its TEXTCLS_LEN
    tokens from its own band of 200 ids, the rest from the vocabulary."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.RandomState(seed)
    out = []
    for c in rng.randint(0, TEXTCLS_CLASSES, n):
        ids = rng.randint(0, TEXTCLS_VOCAB, TEXTCLS_LEN)
        own = rng.rand(TEXTCLS_LEN) < 0.5
        ids[own] = rng.randint(c * 200, (c + 1) * 200, int(own.sum()))
        out.append(Sample(ids.astype(np.int32), np.int32(c)))
    return out


def phase_ncf_textcls():
    """Three models trained through Optimizer (Adam), each with step ms,
    samples/s and the busy share of one profiled step: NeuralCF
    (ClassNLLCriterion) for one epoch of MovieLens-1M-sized ratings,
    validated (Top1Accuracy, Loss) on the held-out 10% at the epoch's
    end; the TextClassifier from a seeded GloVe-shaped embedding
    (set_embedding), 2 + 10 steps; the autoencoder (MSECriterion) on
    synthetic MNIST, 2 + 10 steps. Losses finite and falling;
    validation counts whole."""
    import math as _m

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models import autoencoder, ncf, textclassifier
    from bigdl_tpu_torch.optim import Adam, Loss, Top1Accuracy, Trigger

    t0 = time.perf_counter()
    report = {}
    ratings = _ncf_ratings(31)
    n_held = int(round(NCF_RATINGS * NCF_HELD_OUT))
    train, held = ratings[n_held:], ratings[:n_held]
    steps = _m.ceil(len(train) / NCF_BATCH)     # one epoch
    model = ncf.build(NCF_USERS, NCF_ITEMS)
    model.build(torch.Generator().manual_seed(0))
    res = _timed_optimize(
        model, train, nn.ClassNLLCriterion(), NCF_BATCH, TRAIN_WARMUP,
        steps - TRAIN_WARMUP, Adam(1e-3),
        validation=(Trigger.every_epoch(), DataSet.array(held),
                    [Top1Accuracy(), Loss(nn.ClassNLLCriterion())]),
        profile_trace="ncf_trace.json")
    check(len(res["validations"]) == 1 and all(
        r[1] == n_held for k, r in res["validations"][0].items()
        if k != "neval"), f"ncf validations {res['validations']}")
    report["ncf"] = res
    del ratings, train, held

    tmodel = textclassifier.build(TEXTCLS_CLASSES, TEXTCLS_VOCAB,
                                  TEXTCLS_LEN, TEXTCLS_EMBED)
    tmodel.build(torch.Generator().manual_seed(0))
    glove = np.random.RandomState(32).randn(TEXTCLS_VOCAB, TEXTCLS_EMBED) \
        .astype(np.float32) * 0.3
    tmodel.variables = textclassifier.set_embedding(tmodel.variables, glove)
    check(torch.equal(tmodel.variables["params"]["0_embedding"]["weight"]
                      .cpu(), torch.from_numpy(glove)),
          "textclassifier: set_embedding")
    report["textclassifier"] = _timed_optimize(
        tmodel, _news20_samples(TEXTCLS_BATCH * 8, 33),
        nn.ClassNLLCriterion(), TEXTCLS_BATCH, TRAIN_WARMUP, TRAIN_STEPS,
        Adam(1e-3), profile_trace="textcls_trace.json")

    amodel = autoencoder.build()
    amodel.build(torch.Generator().manual_seed(0))
    images = [Sample(s.feature, np.clip(s.feature, 0.0, 1.0).reshape(-1))
              for s in synthetic_mnist(AE_BATCH * 8, seed=34)]
    report["autoencoder"] = _timed_optimize(
        amodel, images, nn.MSECriterion(), AE_BATCH, TRAIN_WARMUP,
        TRAIN_STEPS, Adam(1e-3), profile_trace="autoencoder_trace.json")
    for name, r in report.items():
        losses = r["losses"]
        check(losses[-1] < losses[0], f"{name} loss did not fall: "
              f"{losses[:3]}...{losses[-3:]}")
        r["losses"] = losses if len(losses) <= 16 else \
            losses[:4] + losses[-4:]
        r.pop("counts")
    report["ncf"].update(users=NCF_USERS, items=NCF_ITEMS,
                         ratings=NCF_RATINGS, held_out=n_held)
    emit("ncf_textcls", seconds=time.perf_counter() - t0, **report)


# ---------------------------------------------------------------- PR 16
# the C++ data plane, data-parallel training (DistriOptimizer over a
# one-rank NCCL mesh) through the training CLI, and ConvLSTMPeephole
NATIVE_CHECK_N, NATIVE_CHECK_BATCHES = 4096, 4   # index-labelled shards
NATIVE_PIPE_BATCHES, NATIVE_WARMUP, NATIVE_STEPS = 30, 5, 50
DIST_N, DIST_SHARDS, DIST_BATCH, DIST_SIZE = 1024, 4, 128, 224
DIST_WARMUP, DIST_STEPS, DIST_PROFILED = 2, 6, 3
DPAR_LENET_STEPS, DPAR_LENET_BATCH, DPAR_LM_STEPS = 5, 128, 3
DPAR_EXACT_TOL = 1e-5          # exact wire vs LocalOptimizer, LeNet-5 fp32
DPAR_BF16_TOL = 1e-4           # bf16 wire vs LocalOptimizer, LeNet-5 fp32
DPAR_LM_LOSS_TOL = 1e-2        # bf16 wire vs LocalOptimizer, LM losses
DPAR_LM_PARAM_TOL = 0.0        # the LM's final fp32 masters, bit for bit
CONVLSTM_BATCH, CONVLSTM_FRAMES, CONVLSTM_SIZE = 8, 10, 64
CONVLSTM_HIDDEN, CONVLSTM_KERNEL, CONVLSTM_CHECK_ROWS = 64, 5, 2
CONVLSTM_TOL = 1e-4            # card vs CPU, fp32, relative to the max


def _shift_flip_match(img, raw_norm, pad):
    """Whether the f32 image `img` is `raw_norm` shifted by some (dy, dx)
    in [-pad, pad] (zero fill) and maybe flipped, bit for bit — the
    Python plane's output for that record and that draw."""
    import numpy as np

    h, w = raw_norm.shape[:2]
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            out = np.zeros_like(raw_norm)
            y0, y1 = max(0, dy), min(h, h + dy)
            x0, x1 = max(0, dx), min(w, w + dx)
            out[y0:y1, x0:x1] = raw_norm[y0 - dy:y1 - dy, x0 - dx:x1 - dx]
            if np.array_equal(img, out) or np.array_equal(img, out[:, ::-1]):
                return True
    return False


def phase_native_plane():
    """The C++ data plane (dataset/csrc/dataplane.cpp, built with g++
    at first use). Gates: it builds (`.native` is True); every record of
    NATIVE_CHECK_BATCHES C++ batches (PR 14's ResNet-20 images, labels
    set to the record index, CIFAR's mean/std, pad 4, hflip) is the
    Python plane's normalisation of that record under one of its shifts
    and flips, bit for bit; eval batches and `normalize_u8` equal numpy.
    Reported: host ms a batch of the C++ and Python file prefetchers
    (each alone, RECORDS_N images in RECORDS_SHARDS shards, batch 128),
    and ResNet-20's images/s from disk through the C++ plane."""
    import tempfile
    import unittest.mock as mock

    import numpy as np
    import torch

    from bigdl_tpu_torch.dataset import RecordFileDataSet, native, write_shards
    from bigdl_tpu_torch.models import resnet

    t0 = time.perf_counter()
    check(native.available(), "native_plane: the C++ plane did not build")
    build_s = time.perf_counter() - t0
    images, labels = _records_images(RECORDS_N, 21)
    mean = np.asarray(CIFAR_MEAN, np.float32)
    std = np.asarray(CIFAR_STD, np.float32)
    kw = dict(batch_size=RECORDS_BATCH, mean=CIFAR_MEAN, std=CIFAR_STD)
    check(np.array_equal(native.normalize_u8(images[:256], mean, std),
                         (images[:256].astype(np.float32) - mean) / std),
          "native_plane: normalize_u8 differs from numpy")
    with tempfile.TemporaryDirectory(prefix="bdls-native-") as tmp:
        idx = np.arange(NATIVE_CHECK_N, dtype=np.int32)
        cpaths = write_shards(images[:NATIVE_CHECK_N], idx,
                              f"{tmp}/check", 2)
        pf = native.FilePrefetcher(cpaths, pad=4, hflip=True, seed=5, **kw)
        try:
            check(pf.native, "native_plane: FilePrefetcher is not native")
            seen = 0
            for _ in range(NATIVE_CHECK_BATCHES):
                img, lbl = pf.next()
                for j, i in enumerate(lbl):
                    raw = (images[i].astype(np.float32) - mean) / std
                    check(_shift_flip_match(img[j], raw, 4),
                          f"native_plane: record {i} is no shift/flip of "
                          "the Python plane's")
                    seen += 1
        finally:
            pf.close()
        paths = write_shards(images, labels, f"{tmp}/train", RECORDS_SHARDS)
        ms = {}
        for plane in ("cpp", "python"):
            with mock.patch.object(native, "_load", return_value=None) \
                    if plane == "python" else contextlib.nullcontext():
                pf = native.FilePrefetcher(paths, pad=4, hflip=True,
                                           seed=1, **kw)
            try:
                check(pf.native == (plane == "cpp"),
                      f"native_plane: {plane} plane not selected")
                ms[plane] = _host_ms_per_batch(iter(pf), NATIVE_PIPE_BATCHES)
            finally:
                pf.close()
        ds = RecordFileDataSet(paths, pad=4, hflip=True, **kw)
        try:
            check(ds.native, "native_plane: RecordFileDataSet not native")
            model = resnet.build_cifar(20, 10).build(
                torch.Generator().manual_seed(0))
            losses, disk_s = _timed_steps(model, ds, RECORDS_BATCH,
                                          NATIVE_WARMUP, NATIVE_STEPS)
        finally:
            ds.close()
    check(all(math.isfinite(v) for v in losses),
          f"native_plane: losses {losses}")
    emit("native_plane", build_or_load_s=build_s, checked_records=seen,
         host_ms_per_batch={"cpp": ms["cpp"], "python": ms["python"]},
         cpp_speedup=ms["python"] / ms["cpp"], batch=RECORDS_BATCH,
         resnet20_disk_images_per_sec=NATIVE_STEPS * RECORDS_BATCH / disk_s,
         resnet20_steps=NATIVE_STEPS,
         total_seconds=time.perf_counter() - t0)


def _dist_images(n, seed):
    """`n` seeded 224 x 224 x 3 u8 images over 1000 classes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, DIST_SIZE, DIST_SIZE, 3), np.uint8),
            rng.randint(0, 1000, n).astype(np.int32))


def _distri_steps(model, ds, mesh, warmup, steps, profile=None):
    """ResNet-50 through `Optimizer(...).set_precision("bf16")`, SGD(0.1,
    momentum 0.9), with `set_mesh(mesh)` unless mesh is None; returns
    (losses, seconds of the last `steps`); with `profile` the last
    `steps` run under torch.profiler and its rows are returned too."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    losses, marks = [], {}
    prof = tprofile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) if profile else None

    def end_when(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] in (warmup, warmup + steps):
            torch.cuda.synchronize()
            marks[state["neval"]] = time.perf_counter()
            if prof is not None:
                (prof.start if state["neval"] == warmup else prof.stop)()
        return state["neval"] >= warmup + steps

    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    batch_size=DIST_BATCH).set_precision("bf16") \
        .set_optim_method(SGD(learningrate=0.1, momentum=0.9)) \
        .set_end_when(Trigger(end_when))
    if mesh is not None:
        opt.set_mesh(mesh)
    opt.optimize()
    dt = marks[warmup + steps] - marks[warmup]
    rows = None
    if prof is not None:
        OUT_DIR.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(OUT_DIR / profile))
        rows = _profile_rows(prof, dt)
        from torch.autograd import DeviceType
        rows["nccl_ms"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and "nccl" in e.key.lower()) / 1e3
    return [float(v) for v in losses], dt, rows


def phase_distri_cli():
    """The slice's main path: `python -m bigdl_tpu_torch.models.train
    --model resnet50 --records DIR --recordsAug hflip --mesh data=1
    --precision bf16 -b 128 --maxEpoch 1 --checkpoint CK` (as
    `train.main(argv, device="cuda")`) on DIST_N seeded 224 x 224 x 3
    images in DIST_SHARDS BDLS shards: the C++ plane feeds
    DistriOptimizer (ZeRO-1, bf16 gradient wire) over a one-rank NCCL
    mesh for one epoch, then validation and a checkpoint. Gates: the
    plane is native; the backend is NCCL; the losses are finite; the
    checkpoint's slots carry layout zero1_flat, and LocalOptimizer
    resumes from it for one more step. Reported: the CLI's seconds, and
    images/s over DIST_STEPS steps (after DIST_WARMUP) of the same
    shards through DistriOptimizer and through LocalOptimizer, and the
    NCCL device ms a step of a profiled DIST_PROFILED-step window."""
    import tempfile

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import RecordFileDataSet, write_shards
    from bigdl_tpu_torch.models import resnet, train
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serialization.checkpoint import Checkpoint

    t0 = time.perf_counter()
    images, labels = _dist_images(DIST_N, 16)
    with tempfile.TemporaryDirectory(prefix="bdls-dist-") as tmp:
        paths = write_shards(images, labels, f"{tmp}/shards", DIST_SHARDS)
        shard_bytes = sum(Path(p).stat().st_size for p in paths)
        del images
        ck = f"{tmp}/ck"
        t = time.perf_counter()
        opt = train.main(["--model", "resnet50", "--records",
                          f"{tmp}/shards", "--recordsAug", "hflip",
                          "--mesh", "data=1", "--precision", "bf16",
                          "-b", str(DIST_BATCH), "--maxEpoch", "1",
                          "--checkpoint", ck], device="cuda")
        cli_s = time.perf_counter() - t
        state = opt.train_state
        check(opt.dataset.native,
              "distri_cli: the records did not ride the C++ plane")
        check(opt.mesh.backend == "nccl",
              f"distri_cli: backend {opt.mesh.backend}, not NCCL")
        check(state["neval"] == DIST_N // DIST_BATCH
              and math.isfinite(float(state["loss"]))
              and math.isfinite(state["score"]),
              f"distri_cli: final state {state}")
        cpt = Checkpoint(ck)
        _, slots, saved_ts, meta = cpt.load(with_optim_meta=True)
        check(meta["layout"] == "zero1_flat" and meta["num_shards"] == 1
              and set(slots) == {"velocity"}
              and tuple(slots["velocity"].shape) == (meta["padded"],),
              f"distri_cli: checkpoint layout {meta}")
        # LocalOptimizer resumes the flat checkpoint: one more step
        kw = dict(batch_size=DIST_BATCH, mean=[127.5] * 3, std=[127.5] * 3,
                  hflip=True)
        ds = RecordFileDataSet(paths, **kw)
        try:
            model = resnet.build_imagenet(50, 1000).build(
                torch.Generator().manual_seed(1))
            resumed = Optimizer(model, ds, nn.ClassNLLCriterion(),
                                batch_size=DIST_BATCH) \
                .set_precision("bf16") \
                .set_optim_method(SGD(learningrate=0.01, momentum=0.9)) \
                .set_checkpoint(ck, Trigger.max_iteration(10 ** 9)) \
                .resume_from_checkpoint() \
                .set_end_when(Trigger.max_iteration(saved_ts["neval"] + 1))
            resumed.optimize()
            check(resumed.train_state["neval"] == saved_ts["neval"] + 1
                  and math.isfinite(float(resumed.train_state["loss"])),
                  f"distri_cli: resume {resumed.train_state}")
            del model, resumed
            torch.cuda.empty_cache()
            rates, profiled = {}, None
            for kind in ("distri", "local"):
                mesh = make_mesh({"data": 1}) if kind == "distri" else None
                model = resnet.build_imagenet(50, 1000).build(
                    torch.Generator().manual_seed(0))
                try:
                    losses, dt, _ = _distri_steps(model, ds, mesh,
                                                  DIST_WARMUP, DIST_STEPS)
                    if kind == "distri":
                        _, pdt, profiled = _distri_steps(
                            model, ds, mesh, 1, DIST_PROFILED,
                            profile="distri_trace.json")
                finally:
                    if mesh is not None:
                        mesh.close()
                check(all(math.isfinite(v) for v in losses),
                      f"distri_cli: {kind} losses {losses}")
                rates[kind] = DIST_STEPS * DIST_BATCH / dt
                del model
                torch.cuda.empty_cache()
        finally:
            ds.close()
    nccl_ms = profiled.get("nccl_ms") if isinstance(profiled, dict) else None
    emit("distri_cli", images=DIST_N, shards=DIST_SHARDS,
         shard_bytes=shard_bytes, batch=DIST_BATCH, cli_seconds=cli_s,
         cli_steps=state["neval"], cli_loss=float(state["loss"]),
         cli_top1=state["score"], checkpoint_layout=meta["layout"],
         backend=opt.mesh.backend, images_per_sec=rates,
         distri_over_local=rates["distri"] / rates["local"],
         nccl_ms_per_step=("not measured" if nccl_ms is None
                           else nccl_ms / DIST_PROFILED),
         profile={k: v for k, v in (profiled or {}).items() if k != "top"},
         total_seconds=time.perf_counter() - t0)


def _flat_params(model):
    import torch

    from bigdl_tpu_torch.models.convert import tree_leaves

    return torch.cat([t.detach().reshape(-1).float()
                      for t in tree_leaves(model.variables["params"])])


def phase_distri_parity():
    """DistriOptimizer against LocalOptimizer on the card, world size 1
    under NCCL. LeNet-5 in fp32 (cuDNN deterministic), DPAR_LENET_STEPS
    steps of SGD with momentum from the same init and batches: the exact
    wire within DPAR_EXACT_TOL of LocalOptimizer and the bf16 wire (the
    default) within DPAR_BF16_TOL, each the largest difference of the
    final weights over their largest; ZeRO-2 bit for bit ZeRO-1, on the
    exact and on the bf16 wire. Then the 43M LM through
    `set_mesh(make_mesh({"data": 1}), zero=2)` (bf16 compute, bf16
    wire) for DPAR_LM_STEPS steps: its final fp32 masters within
    DPAR_LM_PARAM_TOL of LocalOptimizer's, its losses within
    DPAR_LM_LOSS_TOL, with K2/K3 launched TRAIN_CONFIG's layers (x
    BWD_LAUNCHES) times a step — the flash kernels on the data-parallel
    path, counted from 0. The controls, which the same limits must
    refuse: the bf16 wire one LeNet step short, and LocalOptimizer one
    LM step short (an update skipped)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist
    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer, make_mesh
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    samples = synthetic_mnist(DPAR_LENET_BATCH * DPAR_LENET_STEPS, seed=3)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    finals = {}
    try:
        for run in ("local", "exact/1", "exact/2", "bf16/1", "bf16/2",
                    "bf16/1/short"):
            model = lenet.build(10).build(torch.Generator().manual_seed(4))
            steps = DPAR_LENET_STEPS - run.endswith("/short")
            opt = Optimizer(model, DataSet.array(samples),
                            nn.ClassNLLCriterion(),
                            batch_size=DPAR_LENET_BATCH) \
                .set_optim_method(SGD(learningrate=0.05, momentum=0.9)) \
                .set_end_when(Trigger.max_iteration(steps))
            if run == "local":
                opt.optimize()
            else:
                wire, zero = run.split("/")[:2]
                mesh = make_mesh({"data": 1})
                try:
                    check(mesh.backend == "nccl",
                          f"distri_parity: backend {mesh.backend}")
                    DistriOptimizer(opt, mesh, zero=int(zero),
                                    grad_dtype=None if wire == "exact"
                                    else "bfloat16").run()
                finally:
                    mesh.close()
            finals[run] = _flat_params(model)
    finally:
        torch.backends.cudnn.deterministic = det
    ref = finals["local"]

    def lenet_err(run):
        return float((finals[run] - ref).abs().max() / ref.abs().max())

    exact_err, bf16_err = lenet_err("exact/1"), lenet_err("bf16/1")
    bf16_short = lenet_err("bf16/1/short")
    check(exact_err <= DPAR_EXACT_TOL,
          f"distri_parity: exact wire {exact_err} from LocalOptimizer")
    check(bf16_err <= DPAR_BF16_TOL < bf16_short,
          f"distri_parity: bf16 wire {bf16_err} from LocalOptimizer, one "
          f"step short {bf16_short} (limit {DPAR_BF16_TOL})")
    check(torch.equal(finals["exact/1"], finals["exact/2"])
          and torch.equal(finals["bf16/1"], finals["bf16/2"]),
          "distri_parity: ZeRO-2 differs from ZeRO-1")
    lenet_s = time.perf_counter() - t0

    lm_losses, lm_finals, launches = {}, {}, None
    lm_samples = synthetic_next_token(TRAIN_BATCH * DPAR_LM_STEPS, VOCAB,
                                      TRAIN_SEQ)
    for run in ("local", "distri", "local/short"):
        model = _train_model()
        model.build(torch.Generator().manual_seed(0))
        losses = []
        steps = DPAR_LM_STEPS - run.endswith("/short")

        def end_when(state, losses=losses, steps=steps):
            if state["loss"] is not None:
                losses.append(state["loss"])
            return state["neval"] >= steps

        opt = Optimizer(model, DataSet.array(lm_samples),
                        nn.ChunkedSoftmaxCE(), batch_size=TRAIN_BATCH) \
            .set_optim_method(Adam(3e-4)).set_precision("bf16") \
            .set_end_when(Trigger(end_when))
        mesh = None
        if run == "distri":
            mesh = make_mesh({"data": 1})
            opt.set_mesh(mesh, zero=2)
        try:
            torch.cuda.synchronize()
            fa.fwd_launches = fa.bwd_launches = 0  # main path starts here
            opt.optimize()
            torch.cuda.synchronize()
            if run == "distri":
                launches = (fa.fwd_launches, fa.bwd_launches)  # ends here
        finally:
            if mesh is not None:
                mesh.close()
        lm_losses[run] = [float(v) for v in losses]
        lm_finals[run] = _flat_params(model)
        del model, opt
        torch.cuda.empty_cache()
    lm_ref = lm_finals["local"]

    def master_err(run):
        return float((lm_finals[run] - lm_ref).abs().max()
                     / lm_ref.abs().max())

    lm_param_err, lm_short = master_err("distri"), master_err("local/short")
    check(lm_param_err <= DPAR_LM_PARAM_TOL < lm_short,
          f"distri_parity: LM masters {lm_param_err} from LocalOptimizer's, "
          f"one step short {lm_short} (limit {DPAR_LM_PARAM_TOL})")
    layers = TRAIN_CONFIG["num_layers"]
    check(launches == (DPAR_LM_STEPS * layers,
                       DPAR_LM_STEPS * layers * fa.BWD_LAUNCHES),
          f"distri_parity: flash launches {launches} over {DPAR_LM_STEPS} "
          f"steps of {layers} layers")
    lm_err = max(abs(a - b) / abs(b) for a, b in
                 zip(lm_losses["distri"], lm_losses["local"]))
    check(len(lm_losses["distri"]) == DPAR_LM_STEPS and lm_err
          <= DPAR_LM_LOSS_TOL,
          f"distri_parity: LM losses {lm_losses}")
    emit("distri_parity", lenet_steps=DPAR_LENET_STEPS,
         exact_wire_rel_err=exact_err, bf16_wire_rel_err=bf16_err,
         bf16_one_step_short_rel_err=bf16_short,
         zero2_equals_zero1=True, exact_tol=DPAR_EXACT_TOL,
         bf16_tol=DPAR_BF16_TOL, lenet_seconds=lenet_s,
         lm_steps=DPAR_LM_STEPS, lm_param_rel_err=lm_param_err,
         lm_one_step_short_rel_err=lm_short,
         lm_param_tol=DPAR_LM_PARAM_TOL,
         lm_losses=lm_losses, lm_loss_rel_err=lm_err,
         lm_loss_tol=DPAR_LM_LOSS_TOL,
         launches={"fwd": launches[0], "bwd": launches[1]},
         total_seconds=time.perf_counter() - t0)
    return launches


def phase_convlstm():
    """ConvLSTMPeephole at Moving-MNIST-like widths (CONVLSTM_BATCH
    sequences of CONVLSTM_FRAMES 64 x 64 x 1 frames, 64 hidden
    channels, kernel 5) inside `Recurrent`, fp32: forward and backward
    on the card against `device="cpu"` on the same weights and the
    first CONVLSTM_CHECK_ROWS sequences (outputs and every gradient,
    relative to their largest entry, within CONVLSTM_TOL); ms a
    forward + backward step at the full batch (CUDA events)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map

    t0 = time.perf_counter()
    model = nn.Recurrent(nn.ConvLSTMPeephole(1, CONVLSTM_HIDDEN,
                                             kernel=CONVLSTM_KERNEL))
    v_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    # non-zero peepholes, so that the check reaches them
    g = torch.Generator().manual_seed(1)
    for k in ("w_ci", "w_cf", "w_co"):
        v_cpu["params"]["cell"][k] = 0.1 * torch.randn(CONVLSTM_HIDDEN,
                                                       generator=g)
    rng = np.random.RandomState(2)
    x = rng.rand(CONVLSTM_BATCH, CONVLSTM_FRAMES, CONVLSTM_SIZE,
                 CONVLSTM_SIZE, 1).astype(np.float32)

    def fwd_bwd(variables, xs, device):
        params = tree_map(lambda t: t.to(device).requires_grad_(),
                          variables["params"])
        out, _ = model.apply({"params": params, "state": {}},
                             torch.as_tensor(xs).to(device))
        grads = torch.autograd.grad((out * out).mean(), tree_leaves(params))
        return out, grads

    rows = CONVLSTM_CHECK_ROWS
    out_c, g_c = fwd_bwd(v_cpu, x[:rows], "cpu")
    out_g, g_g = fwd_bwd(v_cpu, x[:rows], "cuda")

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    errs = [rel(out_g, out_c)] + [rel(a, b) for a, b in zip(g_g, g_c)]
    check(max(errs) <= CONVLSTM_TOL,
          f"convlstm: card vs CPU relative errors {errs}")
    full = x
    step_ms = []
    for i in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, grads = fwd_bwd(v_cpu, full, "cuda")
        end.record()
        torch.cuda.synchronize()
        if i:  # the first call warms cuDNN up
            step_ms.append(start.elapsed_time(end))
    check(all(torch.isfinite(t).all() for t in (out, *grads)),
          "convlstm: non-finite full-batch output or gradient")
    emit("convlstm", batch=CONVLSTM_BATCH, frames=CONVLSTM_FRAMES,
         size=CONVLSTM_SIZE, hidden=CONVLSTM_HIDDEN, kernel=CONVLSTM_KERNEL,
         check_rows=rows, max_rel_err=max(errs), tol=CONVLSTM_TOL,
         step_ms=step_ms, step_ms_min=min(step_ms),
         total_seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------
# PR 17: A.8 steps 4-5 — the MoE-FFN LM, the parallel steps at world
# size 1, sharded checkpoints
# the MoE LM: the trainer's 43M widths with 8 experts, top-2 (the JAX
# CLI's --moeExperts/--moeTopK switches), capacity 1.25
MOE_CONFIG = dict(TRAIN_CONFIG, moe_experts=8, moe_top_k=2,
                  moe_capacity_factor=1.25)
MOE_WARMUP, MOE_STEPS = 2, 10
# kernel vs plain attention, first batch, bf16: the loss within the bf16
# tolerance the dense LM is held to (tests/test_torch_optimizer.py, 2e-2
# relative); the share of tokens the first MoE layer routes alike (its
# input differs by one bf16 attention; deeper layers compound earlier
# flips, their shares are reported)
MOE_LOSS_TOL, MOE_ROUTE_AGREE = 2e-2, 0.98
# the MoE layer alone, fp32, card vs CPU: tokens whose top two gates
# (and second and third) are more than MOE_GATE_GAP apart route alike;
# their outputs agree within MOE_LAYER_TOL
MOE_LAYER_TOKENS, MOE_GATE_GAP, MOE_LAYER_TOL = 2048, 1e-5, 1e-4
# the parallel steps at world size 1: fp32, full log-softmax
PAR_STEPS = 3                   # timed steps after one warm-up
PAR_LOSS_TOL = 1e-5             # relative: tp and pipeline vs local
PAR_PARAM_TOL = 1e-5            # after a step, of the largest master
PAR_MICRO = 4                   # the pipeline's microbatches
PAR_LR = 0.1                    # SGD, momentum 0.9 (_par_method)
PAR_ULYSSES_SHAPE = (8, 8, 2048, 64)
# sharded checkpoints: the 43M LM under DistriOptimizer(zero=2)
SCK_STEPS, SCK_EVERY, SCK_PLAN = 4, 2, "preempt@3"


def _moe_model(attn_impl=None, ep_axis=None):
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    return TransformerLM(TransformerConfig(**MOE_CONFIG),
                         attn_impl=attn_impl, ep_axis=ep_axis)


def _moe_layer_check():
    """The MoE layer alone (the LM's widths) in fp32 on MOE_LAYER_TOKENS
    seeded tokens, card vs CPU: routing and outputs."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerConfig
    from bigdl_tpu_torch.parallel import MoE

    c = TransformerConfig(**MOE_CONFIG)
    moe = MoE(c.dim, c.dim * c.mlp_ratio, c.moe_experts,
              capacity_factor=c.moe_capacity_factor, top_k=c.moe_top_k)
    p = moe.init_params(torch.Generator().manual_seed(7))
    x = torch.randn(MOE_LAYER_TOKENS, c.dim,
                    generator=torch.Generator().manual_seed(8))
    out = {}
    for dev in ("cuda", "cpu"):
        (y, aux), _ = moe.apply({"params": {k: v.to(dev)
                                            for k, v in p.items()}},
                                x.to(dev))
        out[dev] = (y.cpu(), float(aux),
                    [e.cpu() for e in moe.last_route["experts"]])
    gates = torch.softmax(x @ p["router"], -1).sort(-1, descending=True)[0]
    clear = ((gates[:, 0] - gates[:, 1]) > MOE_GATE_GAP) & (
        (gates[:, 1] - gates[:, 2]) > MOE_GATE_GAP)
    same = torch.ones_like(clear)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        same &= a == b
    routed_alike = bool(same[clear].all())
    # a token routed differently moves the queue positions after it:
    # outputs are compared where every token was routed alike
    err = float((out["cuda"][0] - out["cpu"][0])[clear].abs().max()) \
        if bool(same.all()) else float((out["cuda"][0] - out["cpu"][0])[
            clear & same].abs().max())
    check(routed_alike, "moe_lm: the MoE layer routed a clearly-gated "
                        "token differently on the card")
    check(err <= MOE_LAYER_TOL, f"moe_lm: MoE layer card vs CPU {err}")
    return {"tokens": MOE_LAYER_TOKENS, "clear_tokens": int(clear.sum()),
            "routed_alike_share": float(same.float().mean()),
            "max_abs_err": err, "aux_card": out["cuda"][1],
            "aux_cpu": out["cpu"][1], "tol": MOE_LAYER_TOL,
            "gate_gap": MOE_GATE_GAP}


def _moe_first_batch(params, x, y):
    """The bf16 (DEFAULT_MIXED) loss of the first batch through the
    flash kernels and through the plain attention, and the share of
    (token, layer) routing decisions the two routes take alike."""
    import torch

    from bigdl_tpu_torch.nn import ChunkedSoftmaxCE
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    res = {}
    for impl in ("cuda", "torch"):
        model = _moe_model(impl)
        with torch.no_grad():
            loss, _ = build_train_loss(model, ChunkedSoftmaxCE(),
                                       DEFAULT_MIXED)(params, {}, x, y, None)
        res[impl] = (float(loss), [[e.clone() for e in r["experts"]]
                                   for r in model.moe_routes])
    agree = [float(torch.stack([a == b for a, b in zip(ra, rb)]).all(0)
                   .float().mean())
             for ra, rb in zip(res["cuda"][1], res["torch"][1])]
    return res["cuda"][0], res["torch"][0], agree


def phase_moe_lm():
    """The MoE-FFN Transformer-LM at the 43M LM's widths (MOE_CONFIG:
    vocabulary 32000, dim 512, 8 heads, 8 layers, seq 2048, batch 8, 8
    experts, top-2, capacity 1.25) through `Optimizer(...).optimize()`
    with ChunkedSoftmaxCE, Adam(3e-4), DEFAULT_MIXED: MOE_WARMUP steps,
    then MOE_STEPS timed steps whose flash launches are counted from 0
    (8 forward, 16 backward a step, as the dense LM), then one step
    under torch.profiler (device-busy share). Before it, on the first
    batch: the bf16 loss through the kernels against the plain
    attention (MOE_LOSS_TOL relative) and their routing decisions
    (MOE_ROUTE_AGREE of the tokens alike in the first MoE layer, every
    layer's share reported); the MoE layer
    alone in fp32, card vs CPU (_moe_layer_check). Reported: tokens/s,
    step ms, peak memory, the dropped share of the routing choices per
    layer, the busy share. Returns the timed window's (fwd, bwd)
    launches, the first batch and its loss through the kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    layer = _moe_layer_check()
    steps = MOE_WARMUP + MOE_STEPS + 1
    samples = synthetic_next_token(TRAIN_BATCH * steps, VOCAB, TRAIN_SEQ)
    model = _moe_model()
    model.build(torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.stack([s.feature for s in
                                  samples[:TRAIN_BATCH]])).cuda()
    y = torch.as_tensor(np.stack([s.label for s in
                                  samples[:TRAIN_BATCH]])).cuda()
    loss_k, loss_p, agree = _moe_first_batch(model.variables["params"],
                                             x, y)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(rel <= MOE_LOSS_TOL, f"moe_lm: first-batch loss kernels "
                               f"{loss_k} vs plain {loss_p}")
    check(agree[0] >= MOE_ROUTE_AGREE,
          f"moe_lm: routing alike {agree} (limit {MOE_ROUTE_AGREE} in the "
          "first MoE layer)")
    torch.cuda.empty_cache()

    losses, marks = [], {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def watch(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        n = state["neval"]
        if n == MOE_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.fwd_launches = fa.bwd_launches = 0  # main path starts here
            marks["t0"] = time.perf_counter()
        elif n == MOE_WARMUP + MOE_STEPS:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = (fa.fwd_launches,  # main path ends here
                                 fa.bwd_launches)
            marks["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
            prof.start()
            marks["p0"] = time.perf_counter()
        elif n == steps:
            torch.cuda.synchronize()
            marks["p1"] = time.perf_counter()
            prof.stop()
        return n >= steps

    Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
              batch_size=TRAIN_BATCH).set_optim_method(Adam(3e-4)) \
        .set_precision("bf16").set_end_when(Trigger(watch)).optimize()
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"]
    fwd, bwd = marks["launches"]
    layers = MOE_CONFIG["num_layers"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"moe_lm losses not all finite: {losses}")
    # not gated on falling: in its first dozen Adam steps the router's
    # updates move many tokens between experts (the loss rose for 4
    # steps on the card, then fell); reported with the losses
    check((fwd, bwd) == (MOE_STEPS * layers,
                         MOE_STEPS * layers * fa.BWD_LAUNCHES),
          f"moe_lm flash launches {(fwd, bwd)} over {MOE_STEPS} steps of "
          f"{layers} layers")
    k = MOE_CONFIG["moe_top_k"]
    dropped = [(int(r["dropped_first"]) + int(r.get("dropped_second", 0)))
               / (r["tokens"] * k) for r in model.moe_routes]
    check(len(dropped) == layers, f"moe_lm: {len(dropped)} route records")
    tokens = MOE_STEPS * TRAIN_BATCH * TRAIN_SEQ
    busy = _profile_rows(prof, marks["p1"] - marks["p0"])
    if isinstance(busy.get("device_ms"), float):
        # the profiler slows the host: the share of an unprofiled step
        busy["busy_share_of_timed_step"] = busy["device_ms"] / (
            dt / MOE_STEPS * 1e3)
    emit("moe_lm", steps=MOE_STEPS, warmup_steps=MOE_WARMUP,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, experts=MOE_CONFIG["moe_experts"],
         top_k=k, capacity_factor=MOE_CONFIG["moe_capacity_factor"],
         seconds=dt, step_ms=dt / MOE_STEPS * 1e3,
         tokens_per_sec=tokens / dt, peak_mem_gib=marks["peak"],
         dropped_share_by_layer=dropped, busy=busy,
         first_batch={"loss_kernels": loss_k, "loss_plain": loss_p,
                      "rel_diff": rel, "tol": MOE_LOSS_TOL,
                      "routing_alike_by_layer": agree,
                      "routing_limit": MOE_ROUTE_AGREE},
         layer_check=layer, launches={"fwd": fwd, "bwd": bwd},
         losses=losses, total_seconds=time.perf_counter() - t0)
    return {"launches": (fwd, bwd), "first_loss": loss_k,
            "first_batch": (x, y)}


def _par_method():
    """SGD: a step moves each weight by lr times its gradient, so two
    steps' params differ as their gradients do (Adam's first step is
    lr x sign(g), which turns the rounding noise of a gradient that is
    zero in exact arithmetic — the key bias's — into lr-sized moves)."""
    from bigdl_tpu_torch.optim import SGD

    return SGD(learningrate=PAR_LR, momentum=0.9, dampening=0.0)


def _full_nll():
    """Mean NLL of full log-probs — the JAX tp step's loss — as a
    criterion without the chunked fusion."""
    from bigdl_tpu_torch.nn.module import Criterion

    class FullLogSoftmaxNLL(Criterion):
        def forward(self, input, target):
            return -input.gather(-1, target.long()[..., None]).mean()

    return FullLogSoftmaxNLL()


def _par_local(params, samples, steps):
    """LocalOptimizer's fp32 SGD steps with the full-log-softmax loss
    from `params`: (losses, final params, ms a step after the first)."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.convert import tree_map
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    model = _train_model()
    model.variables = {"params": tree_map(lambda t: t.clone(), params),
                       "state": {}}
    losses, marks = [], {}

    def watch(state):
        if state["loss"] is not None:
            losses.append(float(state["loss"]))
        if state["neval"] in (1, steps):
            torch.cuda.synchronize()
            marks[state["neval"]] = time.perf_counter()
        return state["neval"] >= steps

    Optimizer(model, DataSet.array(samples), _full_nll(),
              batch_size=TRAIN_BATCH).set_optim_method(_par_method()) \
        .set_precision("fp32").set_end_when(Trigger(watch)).optimize()
    ms = (marks[steps] - marks[1]) / (steps - 1) * 1e3 if steps > 1 \
        else None
    return losses, model.variables["params"], ms


def _par_step(step, params, slots, samples, steps):
    """`steps` calls of a parallel step from `params`: (losses, ms a
    step after the first, the first step's K2/K3 launches, the params
    after the first step, copied)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.models.convert import tree_map

    losses, launches, first, t = [], None, None, None
    for i in range(steps):
        batch = samples[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
        x = torch.as_tensor(np.stack([b.feature for b in batch])).cuda()
        y = torch.as_tensor(np.stack([b.label for b in batch])).cuda()
        if i == 0:
            torch.cuda.synchronize()
            _zero_flash_counts()                # main path starts here
        params, slots, loss = step(params, slots, x, y, PAR_LR, i, None)
        losses.append(float(loss))
        if i == 0:
            launches = _flash_counts()          # main path ends here
            first = tree_map(lambda t: t.detach().clone(), params)
            torch.cuda.synchronize()
            t = time.perf_counter()
    torch.cuda.synchronize()
    return (losses, (time.perf_counter() - t) / (steps - 1) * 1e3,
            launches, first)


def _max_rel(a_tree, b_tree) -> float:
    from bigdl_tpu_torch.models.convert import tree_leaves

    top = max(float(b.abs().max()) for b in tree_leaves(b_tree))
    return max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(a_tree), tree_leaves(b_tree))) / top


def phase_parallel_w1(moe):
    """The parallel strategies at world size 1 under NCCL (every mesh
    axis 1: one card holds one rank; multi-rank parity is in the CPU
    tests). On the 43M LM in fp32 with the full log-softmax loss and
    SGD (_par_method), PAR_STEPS + 1 steps each from the same weights and
    batches: make_transformer_train_step at {data: 1, model: 1} against
    LocalOptimizer (first loss within PAR_LOSS_TOL relative, params after
    the first step within PAR_PARAM_TOL of the largest master; K2/K3 8 /
    16 a step); make_pipeline_train_step at pipe 1 with PAR_MICRO
    microbatches (first loss against LocalOptimizer's, the unpipelined
    mean; K2 PAR_MICRO ticks x 8 layers a step); make_ring_attention
    (mode="ulysses") at seq 1 on PAR_ULYSSES_SHAPE bf16 (one K2 launch,
    bitwise ops.flash_attention); make_moe_lm_train_step at expert 1 on
    the MoE LM and moe_lm's first batch (its fp32 loss within
    MOE_LOSS_TOL of moe_lm's bf16 first-batch loss). `moe`: what
    phase_moe_lm returned. Returns each path's (fwd, bwd) launches."""
    import torch

    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.ops.flash_attention import flash_attention
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.parallel import (make_mesh, make_moe_lm_train_step,
                                          make_pipeline_train_step,
                                          make_ring_attention,
                                          make_transformer_train_step,
                                          shard_params)
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    steps = PAR_STEPS + 1
    layers = TRAIN_CONFIG["num_layers"]
    samples = synthetic_next_token(TRAIN_BATCH * steps, VOCAB, TRAIN_SEQ,
                                   seed=5)
    init = _train_model().init_params(torch.Generator().manual_seed(0))
    # the timed run (Optimizer shuffles the samples), and the first
    # batch alone: the loss and the params after one step to hold to
    local_losses, _, local_ms = _par_local(init, samples, steps)
    (local_loss,), local_one, _ = _par_local(init, samples[:TRAIN_BATCH],
                                             1)
    torch.cuda.empty_cache()
    mesh = make_mesh({"data": 1, "model": 1, "seq": 1, "expert": 1,
                      "pipe": 1})
    out, launches = {}, {}
    try:
        check(mesh.backend == "nccl",
              f"parallel_w1: backend {mesh.backend}")
        cfg = TransformerConfig(**TRAIN_CONFIG)
        for name, model, build in (
                ("tp", TransformerLM(cfg, tp_axis="model"),
                 lambda m, meth: make_transformer_train_step(
                     m, meth, mesh, "data", "model")),
                ("pipeline", TransformerLM(cfg),
                 lambda m, meth: make_pipeline_train_step(
                     m, meth, mesh, "pipe", microbatches=PAR_MICRO))):
            method = _par_method()
            step = build(model, method)
            p = shard_params(mesh, step.specs, init)
            losses, ms, lc, first = _par_step(
                step, p, method.init_slots(tree_leaves(p)), samples, steps)
            rel = abs(losses[0] - local_loss) / abs(local_loss)
            ticks = PAR_MICRO if name == "pipeline" else 1
            check(rel <= PAR_LOSS_TOL,
                  f"parallel_w1 {name}: first loss {losses[0]} vs local "
                  f"{local_loss}")
            check(lc == (ticks * layers, ticks * layers * fa.BWD_LAUNCHES),
                  f"parallel_w1 {name}: flash launches {lc}")
            row = {"step_ms": ms, "losses": losses, "loss_rel_diff": rel,
                   "launches": {"fwd": lc[0], "bwd": lc[1]}}
            if name == "tp":
                err = _max_rel(first, local_one)
                check(err <= PAR_PARAM_TOL,
                      f"parallel_w1 tp: params after a step {err}")
                row["param_rel_err"] = err
            else:
                row["bubble_fraction"] = step.bubble_fraction
            out[name], launches[name] = row, lc
            del step, p, first, model
            torch.cuda.empty_cache()

        # Ulysses at seq 1: the flash kernel on the whole sequence
        g = torch.Generator(device="cuda").manual_seed(9)
        q, k, v = (torch.randn(PAR_ULYSSES_SHAPE, generator=g,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        fn = make_ring_attention(mesh, "seq", causal=True, mode="ulysses")
        _zero_flash_counts()                    # main path starts here
        got = fn(q, k, v)
        lc = _flash_counts()                    # main path ends here
        check(lc == (1, 0), f"parallel_w1 ulysses: launches {lc}")
        check(torch.equal(got, flash_attention(q, k, v, causal=True)),
              "parallel_w1 ulysses: differs from ops.flash_attention")
        out["ulysses"], launches["ulysses"] = {
            "shape": list(PAR_ULYSSES_SHAPE), "equal_to_flash": True,
            "launches": {"fwd": lc[0], "bwd": lc[1]}}, lc

        # the expert-parallel step at expert 1 on moe_lm's first batch
        model = _moe_model(ep_axis="expert")
        method = Adam(3e-4)
        step = make_moe_lm_train_step(model, method, mesh, "expert")
        p = shard_params(mesh, step.specs, _moe_model().init_params(
            torch.Generator().manual_seed(0)))
        x, y = moe["first_batch"]
        _zero_flash_counts()                    # main path starts here
        p, _, loss = step(p, method.init_slots(tree_leaves(p)), x, y, 3e-4,
                          0, None)
        loss = float(loss)
        lc = _flash_counts()                    # main path ends here
        rel = abs(loss - moe["first_loss"]) / abs(moe["first_loss"])
        check(rel <= MOE_LOSS_TOL, f"parallel_w1 ep: fp32 loss {loss} vs "
                                   f"moe_lm's bf16 {moe['first_loss']}")
        check(lc == (layers, layers * fa.BWD_LAUNCHES),
              f"parallel_w1 ep: flash launches {lc}")
        out["ep"], launches["ep"] = {
            "loss_fp32": loss, "moe_lm_loss_bf16": moe["first_loss"],
            "rel_diff": rel, "tol": MOE_LOSS_TOL,
            "launches": {"fwd": lc[0], "bwd": lc[1]}}, lc
        del step, p, model
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    emit("parallel_w1", mesh="data=1,model=1,seq=1,expert=1,pipe=1 (NCCL)",
         local={"step_ms": local_ms, "losses": local_losses,
                "first_batch_loss": local_loss},
         loss_tol=PAR_LOSS_TOL, param_tol=PAR_PARAM_TOL, **out,
         total_seconds=time.perf_counter() - t0)
    return launches


def phase_sharded_ckpt():
    """Sharded checkpoints on the card: the 43M LM (TRAIN_CONFIG, batch
    8 x 2048, bf16, Adam(3e-4)) under DistriOptimizer(zero=2) on a
    one-rank NCCL mesh, SCK_STEPS steps through Optimizer.optimize():
    U uninterrupted; R1 with set_checkpoint(sharded=True,
    async_save=True) every SCK_EVERY steps, preempted by SCK_PLAN; R2 a
    model from another seed, resume_from_checkpoint(). Gates: R2's fp32
    masters equal U's bit for bit, R2 resumed from checkpoint-2 (a
    MANIFEST and one shard unit), U's flash launches exact. Reported:
    each save's stall (the host snapshot and enqueue), the resume's
    load seconds, the checkpoint's GiB. Returns U's (fwd, bwd)."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serialization.checkpoint import shard_unit_name
    from bigdl_tpu_torch.utils import faults

    t0 = time.perf_counter()
    samples = synthetic_next_token(TRAIN_BATCH * SCK_STEPS, VOCAB,
                                   TRAIN_SEQ, seed=6)
    tmp = Path(tempfile.mkdtemp(prefix="sharded_ckpt_"))
    mesh = make_mesh({"data": 1})
    out, finals = {}, {}
    try:
        for run, seed in (("U", 0), ("R1", 0), ("R2", 1)):
            o = _lm_optimizer(samples, SCK_STEPS, seed=seed, accum=1)
            o.set_mesh(mesh, zero=2)
            stalls, loads = [], []
            if run != "U":
                o.set_checkpoint(str(tmp / "ckpt"),
                                 Trigger.several_iteration(SCK_EVERY),
                                 sharded=True, async_save=True)
                ck = o.checkpoint
                save, load = ck.save_sharded, ck.load

                def timed_save(*a, save=save, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    path = save(*a, **kw)
                    stalls.append({"step": a[0],
                                   "s": time.perf_counter() - t})
                    return path

                def timed_load(*a, load=load, **kw):
                    t = time.perf_counter()
                    res = load(*a, **kw)
                    loads.append(time.perf_counter() - t)
                    return res

                ck.save_sharded, ck.load = timed_save, timed_load
            if run == "R2":
                o.resume_from_checkpoint()
            faults.set_plan(faults.FaultPlan(SCK_PLAN) if run == "R1"
                            else None)
            _zero_flash_counts()                # main path starts here
            try:
                o.optimize()
            except faults.Preempted:
                check(run == "R1", f"sharded_ckpt {run} was preempted")
            finally:
                faults.set_plan(None)
            if run == "U":
                out["launches"] = _check_flash_counts("sharded_ckpt U",
                                                      SCK_STEPS)
            if run != "R1":
                finals[run] = _flat_params(o.model)
            out[f"save_stalls_{run}"] = stalls
            if loads:
                out["resume_load_s"] = loads[0]
                out["resumed_from"] = Path(o.checkpoint._last_loaded).name
            del o
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    d = tmp / "ckpt" / "checkpoint-2"
    units = sorted(f.name for f in d.iterdir()) if d.is_dir() else []
    out["checkpoint_gib"] = _dir_gib(d) if d.is_dir() else None
    shutil.rmtree(tmp, ignore_errors=True)
    check(out.get("resumed_from") == "checkpoint-2",
          f"sharded_ckpt: R2 resumed from {out.get('resumed_from')}")
    check("MANIFEST.json" in units and f"{shard_unit_name(0, 1)}.npz"
          in units, f"sharded_ckpt: checkpoint-2 holds {units}")
    check(torch.equal(finals["R2"], finals["U"]),
          "sharded_ckpt: the resumed masters differ from U's")
    emit("sharded_ckpt", steps=SCK_STEPS, checkpoint_every=SCK_EVERY,
         plan=SCK_PLAN, units=units, masters_bitwise=True, **out,
         total_seconds=time.perf_counter() - t0)
    return out["launches"]["fwd"], out["launches"]["bwd"]


# ------------------------------------------- tensor-parallel serving
TP_AXES = {"model": 1}          # one card holds one NCCL rank


def phase_tp_serve(model, params, fp32_tokens):
    """The engine's timed wave through `InferenceEngine(model,
    tp_mesh=mesh)` on a one-rank NCCL mesh (serving/tp.py): the same
    warm-up and timed waves as phase_engine, K1 per rank on its H/tp
    heads. Gates: the timed wave's tokens and statuses bitwise equal to
    phase_engine's fp32 tokens, K1's launches exact, and the serving
    tree through gather_serving_params -> shard_serving_params ->
    gather_serving_params bitwise (and equal to the unsharded layout).
    Reported: decode ms a step and tokens/s beside the unsharded
    engine's. Returns the timed wave's K1 launches."""
    import numpy as np

    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import (InferenceEngine, Request,
                                         gather_serving_params,
                                         shard_serving_params)

    mesh = make_mesh(TP_AXES)
    try:
        eng = InferenceEngine(model, params, tp_mesh=mesh, **ENGINE_KNOBS)
        check(eng.tp == 1 and eng.attn_impl == "cuda",
              f"tp engine: tp {eng.tp}, attn_impl {eng.attn_impl}")
        eng.run([Request(**r) for r in _wave(0)])          # warm-up
        res, dt, steps, launches = _timed_run(eng, _wave(100))
        _check_launches("tp_serve", launches, steps)
        check(all(r.status == "done" and r.finish_reason == "max_tokens"
                  for r in res), "tp_serve: a request did not finish done")
        same = [r.tokens == t for r, t in zip(res, fp32_tokens)]
        check(all(same), f"tp_serve: {same.count(False)} of {len(same)} "
              "requests' tokens differ from the unsharded engine's")
        host = gather_serving_params(eng._params, mesh)
        back = gather_serving_params(shard_serving_params(mesh, host),
                                     mesh)
        plain = gather_serving_params(model.serving_params(params))
        check(all(np.array_equal(a, b) and np.array_equal(a, c)
                  for a, b, c in zip(tree_leaves(host), tree_leaves(back),
                                     tree_leaves(plain))),
              "tp_serve: the gather -> shard -> gather round trip moved "
              "a bit")
        pool_bytes = sum(leaf.numel() * leaf.element_size()
                         for layer in eng.pool for leaf in layer.values())
        n_tok = sum(len(r.tokens) for r in res)
        ref = RESULTS["engine"]
        emit("tp_serve", mesh=TP_AXES, backend=mesh.backend,
             requests=len(res), new_tokens=n_tok, seconds=dt,
             decode_steps=steps, step_ms=dt / steps * 1e3,
             tokens_per_sec=n_tok / dt,
             unsharded_step_ms=ref["step_ms"],
             unsharded_tokens_per_sec=ref["tokens_per_sec"],
             kernel_launches=launches, tokens_bitwise=True,
             reshard_bitwise=True, pool_bytes_per_rank=pool_bytes)
    finally:
        mesh.close()
    return launches


# ------------------------------------------- the serving fleet (A.9)
# the fleet and speculative phases share the bench's shared-prompt burst
# (bench.py bench_lm_decode_spec, CPU configuration): 256-token prompts,
# 90% of each prompt one shared prefix, prefill buckets (32, 256)
FLEET_CONTEXT, FLEET_TAIL, FLEET_NEW = 256, 26, 16
FLEET_MAX_LEN = FLEET_CONTEXT + 32 + 8 + (-(FLEET_CONTEXT + 40)) % BLOCK
FLEET_BUCKETS = (2 * BLOCK, FLEET_CONTEXT)
FLEET_REQUESTS = 32             # the burst: 24 steady, 8 flooding
FLEET_FLOOD = 8
FLEET_TARGET_P99_S = 4.0        # the SLO, in virtual seconds
FLEET_STEP_S = 0.5              # virtual seconds a scheduling round
FLEET_SLOW_STEP = 6             # the decode step serve_slow hangs on e0


def _fleet_burst(seed, n, new, sampled_every=2):
    """`n` requests of FLEET_CONTEXT tokens, the first
    FLEET_CONTEXT - FLEET_TAIL of them shared; every `sampled_every`-th
    seeded (temperature 0.8, top-k 50), the others greedy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(1, VOCAB,
                                          FLEET_CONTEXT - FLEET_TAIL)]
    out = []
    for i in range(n):
        tail = [int(t) for t in rng.randint(1, VOCAB, FLEET_TAIL)]
        sampled = sampled_every and i % sampled_every == 1
        out.append(dict(prompt=shared + tail, max_new_tokens=new,
                        temperature=0.8 if sampled else 0.0,
                        top_k=50 if sampled else 0, seed=seed * 100 + i))
    return out


def _fleet_wall(obj, name, box):
    """Wrap obj.name to add its wall seconds to box[name], without a
    synchronise: the decode fetch fences each step, and an admission's
    prefill lands in the next fetch, so the two together hold the
    engines' device work and the rest of a round is the host's."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            box[name] = box.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def phase_fleet(model, params):
    """The serving fleet on the card (serving/router.py, tenancy.py,
    autoscaler.py; obs/ whole): an EngineRouter over two engines on
    cuda, a TenancyController with a steady and a flooding tenant, an
    Autoscaler (max_engines=3), a MetricsSampler and an AlertEngine
    carrying a p99 objective, a ScrapeServer on port 0 and a
    FlightRecorder, all on one virtual clock (FLEET_STEP_S a round).
    Traffic: FLEET_REQUESTS shared-prompt requests at once, greedy and
    seeded mixed, then a recovery trickle; serve_slow hangs engine e0's
    decode step FLEET_SLOW_STEP past its real 0.5 s watchdog, and its
    requests fail over. Gates: every request ends in exactly one
    terminal; each one served (failed over or not) has the tokens of a
    single-engine run, bitwise; journeys show no lost hop; the alert
    fires and resolves; /metrics serves render_prometheus()'s bytes;
    one engine_degraded incident bundle; K1's launches equal the
    engines' decode steps x layers. Reported: router host ms a round
    (router.step wall less the engines' decode and admission wall).
    Returns K1's launches."""
    import tempfile
    import urllib.request

    import torch

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import (Autoscaler, EngineRouter,
                                         InferenceEngine, Request,
                                         TenancyController, TenantSpec)

    knobs = dict(slots=SLOTS, max_len=FLEET_MAX_LEN,
                 prefill_buckets=FLEET_BUCKETS, block_size=BLOCK)
    specs = _fleet_burst(21, FLEET_REQUESTS, FLEET_NEW)
    for i, s in enumerate(specs):
        s["tenant"] = "flood" if i >= FLEET_REQUESTS - FLEET_FLOOD \
            else "steady"
    trickle = [dict(s, max_new_tokens=1, tenant="steady")
               for s in _fleet_burst(22, 6, 1)]
    ref_eng = InferenceEngine(model, params, **knobs)
    ref = {i: r.tokens for i, r in enumerate(ref_eng.run(
        [Request(**{k: v for k, v in s.items() if k != "tenant"})
         for s in specs]))}
    clk = _Clock()
    prev = obs.set_enabled(True)
    obs.reset_all(clock=clk)
    outdir = tempfile.mkdtemp(prefix="fleet_incidents_")
    made, wall = [], {}

    def engine(**kw):
        e = InferenceEngine(model, params, clock=clk,
                            obs_label=f"e{len(made)}", **knobs, **kw)
        for name in ("_dispatch_and_fetch", "_admit_into"):
            _fleet_wall(e, name, wall)
        made.append(e)
        return e

    e0 = engine(step_timeout_s=WATCHDOG_S)      # warmed at construction
    e1 = engine()
    ctl = TenancyController(
        [TenantSpec("steady", weight=4.0, bucket_capacity=64.0,
                    refill_rate=8.0),
         TenantSpec("flood", weight=1.0, bucket_capacity=2.0,
                    refill_rate=0.5, max_pending=4)], clock=clk)
    router = EngineRouter([e0, e1], engine_factory=engine, clock=clk,
                          obs_label="r0", tenancy=ctl)
    asc = Autoscaler(router, target_p99_s=FLEET_TARGET_P99_S,
                     max_engines=3, evaluate_every_s=FLEET_STEP_S,
                     backlog_high=2.0)
    sampler = obs.MetricsSampler(interval_s=FLEET_STEP_S, capacity=512,
                                 clock=clk)
    objective = obs.SLOObjective(
        name="p99", kind="latency_quantile",
        metric="router_request_latency_seconds",
        target=FLEET_TARGET_P99_S, q=0.99, labels={"router": "r0"})
    alerts = obs.AlertEngine(sampler, [obs.AlertRule(
        name="p99_burn", objective=objective, kind="burn_rate",
        long_window_s=8.0, short_window_s=2.0, clear_s=6.0)], clock=clk)
    scrape = obs.ScrapeServer(sampler=sampler, alert_engine=alerts)
    port = scrape.start()
    rec = obs.FlightRecorder(outdir, clock=clk)
    for e in (e0, e1):
        rec.register_health_source(e.obs_name, e.health)
    rec.install()
    got, rounds, step_wall = {}, 0, 0.0

    def run_until(done, limit):
        nonlocal rounds, step_wall
        n = 0
        while not done():
            n += 1
            check(n <= limit, f"fleet: stalled, {len(got)} settled")
            clk.t += FLEET_STEP_S
            t0 = time.perf_counter()
            for res in router.step():
                check(res.id not in got, f"fleet: request {res.id} "
                      "reached a second terminal")
                got[res.id] = res
            # router.step() ends in each engine's per-step token fetch
            step_wall += time.perf_counter() - t0  # graftlint: disable=unfenced-timing
            rounds += 1
            asc.observe()
            sampler.tick()
            alerts.evaluate()

    def traffic():
        ids = [router.submit(Request(**s)) for s in specs]
        run_until(lambda: all(i in got for i in ids), 400)
        tids = []
        for s in trickle:
            tids.append(router.submit(Request(**s)))
            run_until(lambda: tids[-1] in got, 50)
        run_until(lambda: not alerts.firing(), 50)
        return ids, tids

    try:
        torch.cuda.synchronize()
        paged_decode.launches = 0
        t0 = time.perf_counter()
        ids, tids = _with_plan(f"serve_slow@{FLEET_SLOW_STEP}", traffic)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = paged_decode.launches
        rec.close()
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30).read())
        events = obs.get_event_log().events()
        text = obs.get_registry().render_prometheus().encode()
    finally:
        scrape.close()
        obs.reset_all()
        obs.set_enabled(prev)
    steps = sum(e.stats["decode_steps"] for e in made)
    check(launches > 0 and launches == steps * LAYERS,
          f"fleet: K1 launches {launches} != decode steps {steps} x "
          f"{LAYERS}")
    check(e0.degraded is not None and "watchdog" in e0.degraded,
          f"fleet: e0 did not trip its watchdog ({e0.degraded})")
    statuses = {}
    for i in ids + tids:
        statuses[got[i].status] = statuses.get(got[i].status, 0) + 1
    check(set(statuses) <= {"done", "shed"} and all(
        got[i].status == "done" for i in ids[:FLEET_REQUESTS
                                             - FLEET_FLOOD] + tids),
          f"fleet: statuses {statuses}")
    served = [i for i, rid in enumerate(ids) if got[rid].status == "done"]
    check(all(got[ids[i]].tokens == ref[i] for i in served),
          "fleet: a served request's tokens differ from the single-engine "
          "run's")
    journeys = obs.build_journeys(events)
    jsum = obs.summarize_journeys(journeys)
    check(jsum["count"] == len(ids) + len(tids)
          and jsum["complete"] == jsum["count"] and jsum["lost_hops"] == 0,
          f"fleet: journeys {jsum}")
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    failed_over = sum(1 for e in events if e["kind"] == "router_failover")
    check(failed_over >= 1, "fleet: nothing failed over")
    fired = kinds.get("alert_firing", 0)
    check(fired >= 1 and kinds.get("alert_resolved") == fired,
          f"fleet: the alert fired {fired} times and resolved "
          f"{kinds.get('alert_resolved')} times")
    check(metrics == text, "fleet: /metrics is not render_prometheus()'s "
          "bytes")
    degraded_bundles = [b for b in rec.bundles
                        if b.endswith("engine_degraded")]
    check(len(degraded_bundles) == 1, f"fleet: bundles {rec.bundles}")
    check(os.path.exists(os.path.join(outdir, degraded_bundles[0],
                                      "manifest.json")),
          "fleet: the incident bundle has no manifest")
    decode_admit = sum(wall.values())
    emit("fleet", requests=len(ids) + len(tids), statuses=statuses,
         rounds=rounds, seconds=seconds, decode_steps=steps,
         kernel_launches=launches, engines_built=len(made),
         autoscale=[d["action"] for d in asc.decisions
                    if d["action"] != "hold"],
         failovers=failed_over,
         throttled=kinds.get("tenant_throttled", 0),
         tenants={t: ctl.stats(t) for t in ctl.tenants},
         journeys=jsum, bundles=rec.bundles,
         alert_fired=fired,
         scrape_health_keys=sorted(health),
         tokens_bitwise_single_engine=len(served),
         router_step_ms=step_wall / rounds * 1e3,
         decode_and_admit_ms_a_round=decode_admit / rounds * 1e3,
         router_host_ms_a_round=(step_wall - decode_admit) / rounds * 1e3,
         card=nvidia_smi())
    return launches


# ----------------------------------------- speculative decoding (A.9)
SPEC_K = 3
SPEC_REQUESTS = 32
SPEC_NEW = 32
SPEC_EPS = 0.07                 # bench.py's planted predictability
SPEC_DRAFT = dict(dim=64, num_heads=2, num_layers=2)
SPEC_SLOW_STEP = 3              # the draft chain step serve_slow hangs


def _spec_models(model, params):
    """(target params, draft model, draft params): the 43M target with
    its blocks' output projections (wo, w2) scaled by SPEC_EPS — full
    shapes and weight traffic, but greedy chains that repeat, as a
    trained target's are predictable (bench.py bench_lm_decode_spec) —
    and a 64-wide, 2-layer, 2-head draft whose blocks and positional
    table are zero, so its argmax is the current token."""
    import torch

    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    tp = dict(params)
    tb = dict(tp["blocks"])
    tb["wo"] = tb["wo"] * SPEC_EPS
    tb["w2"] = tb["w2"] * SPEC_EPS
    tp["blocks"] = tb
    draft = TransformerLM(TransformerConfig(
        vocab_size=VOCAB, max_len=MAX_LEN, **SPEC_DRAFT))
    dp = draft.init_params(torch.Generator().manual_seed(1))
    dp["blocks"] = {k: torch.zeros_like(v) for k, v in dp["blocks"].items()}
    dp["pos"] = torch.zeros_like(dp["pos"])
    return tp, draft, dp


def _row_bits(model, params, cache_dtype, tiled=True):
    """Do SLOTS rows' logits decoded alone equal, bitwise, the same rows
    inside a SLOTS*(SPEC_K+1)-row verify-shaped call over copies of the
    same pools? (rows equal, rows, max abs difference). Both calls run
    the layer norms and products over SLOTS-row tiles, as the engine
    calls the step (`row_tile=SLOTS`); `tiled=False` runs the verify
    call's over all its rows at once: the control."""
    import torch

    sp = model.serving_params(params)
    nb = MAX_LEN // BLOCK
    pools = model.init_block_pool(SLOTS * nb + 1, BLOCK, cache_dtype)
    dev = model.device
    table = (1 + torch.arange(SLOTS * nb, dtype=torch.int32)).reshape(
        SLOTS, nb).to(dev)
    g = torch.Generator().manual_seed(5)
    lens = [512, 253, 495, 170, 100, 300, 20, 400]
    for r, n in enumerate(lens):
        bucket = 256 if n <= 256 else 512
        toks = torch.zeros(1, bucket, dtype=torch.int32)
        toks[0, :n] = torch.randint(1, VOCAB, (n,), generator=g)
        model.prefill_paged(sp, toks.to(dev), pools, table[r:r + 1],
                            table[r, :bucket // BLOCK], 0)
    clone = [{k: t.clone() for k, t in layer.items()} for layer in pools]
    k1 = SPEC_K + 1
    tok = torch.randint(1, VOCAB, (SLOTS,), generator=g).int()
    vtok = torch.randint(1, VOCAB, (SLOTS * k1,), generator=g).int()
    vtok[::k1] = tok
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    vpos = (pos[:, None] + torch.arange(k1, dtype=torch.int32)).reshape(-1)
    with torch.no_grad():
        alone, _ = model.decode_step_paged(sp, tok.to(dev), pos.to(dev),
                                           pools, table, row_tile=SLOTS)
        within, _ = model.decode_step_paged(
            sp, vtok.to(dev), vpos.to(dev), clone,
            table.repeat_interleave(k1, 0),
            row_tile=SLOTS if tiled else None)
    torch.cuda.synchronize()
    within = within[::k1]
    return (int((alone == within).all(-1).sum()), SLOTS,
            float((alone - within).abs().max()))


def phase_spec(model, params):
    """Speculative decoding on the card (serving/speculative.py): a
    SpeculativeEngine with k = SPEC_K over the 43M target (planted
    predictability, SPEC_EPS) and a 64-wide 2-layer draft, SLOTS slots,
    on the fleet's shared-prompt burst (half greedy, half seeded).
    Gates: the row bits of trouble spot 1 — SLOTS rows decoded alone
    equal, bitwise, the same rows among SLOTS*(k+1) (fp32 and bf16
    pools; the untiled products, reported only, are the control);
    the speculative tokens bitwise the target-only engine's; the verify
    pass launches K1 once a layer a round over SLOTS*(k+1) rows; a
    serve_slow trip of the draft's watchdog falls back to target-only
    with the tokens unchanged; the target as its own draft accepts every
    seeded proposal (coupled sampling). Reported: accept rate (also of the
    seeded and the greedy rows apart), tokens a round,
    speculative and target-only tokens/s (also for the same burst all
    greedy), beside the card's name and power limit. Returns K1's
    launches in the speculative run."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import (InferenceEngine, Request,
                                         SpeculativeEngine)

    bits = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        bits[name] = _row_bits(model, params, dtype)
        bits[name + "_untiled"] = _row_bits(model, params, dtype,
                                            tiled=False)
        check(bits[name][0] == bits[name][1],
              f"spec: {name} rows differ across extents {bits[name]}")
    tp, draft, dp = _spec_models(model, params)
    knobs = dict(slots=SLOTS, max_len=FLEET_MAX_LEN,
                 prefill_buckets=FLEET_BUCKETS, block_size=BLOCK)

    def target(**kw):
        return InferenceEngine(model, tp, **knobs, **kw)

    def spec(**kw):
        return SpeculativeEngine(InferenceEngine(draft, dp, **knobs, **kw),
                                 target(), k=SPEC_K)

    def burst(seed, sampled_every=2):
        return [Request(**s) for s in
                _fleet_burst(seed, SPEC_REQUESTS, SPEC_NEW, sampled_every)]

    spec().run(burst(99)[:SLOTS + 1])              # warm-up, both models
    target().run(burst(99)[:2])

    def timed(eng, sampled_every=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(burst(1, sampled_every))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    tgt = target()
    ref, ref_dt = timed(tgt)
    eng = spec()
    t, d = eng.target_engine, eng.draft_engine
    rows = {"target": [], "draft": []}
    for name, e in (("target", t), ("draft", d)):
        real = e._decode_rows

        def counted(tok, *a, real=real, log=rows[name]):
            log.append(int(tok.shape[0]))
            return real(tok, *a)

        e._decode_rows = counted
    paged_decode.launches = 0
    res, dt = timed(eng)
    launches = paged_decode.launches
    check([r.tokens for r in res] == [r.tokens for r in ref]
          and all(r.status == "done" for r in res),
          "spec: the speculative tokens differ from the target-only "
          "engine's")
    verify_rows = SLOTS * (SPEC_K + 1)
    h = eng.health()["speculative"]
    check(t.stats["decode_steps"] == h["rounds"] and h["rounds"] > 0,
          f"spec: {t.stats['decode_steps']} target steps for "
          f"{h['rounds']} rounds")
    check(rows["target"] == [verify_rows] * h["rounds"]
          and rows["draft"] == [SLOTS] * h["draft_steps"],
          f"spec: decode calls by rows: target {sorted(set(rows['target']))}"
          f" x {len(rows['target'])}, draft {sorted(set(rows['draft']))} x "
          f"{len(rows['draft'])}, for {h['rounds']} rounds")
    check(t.stats["attn_kernel_launches"] == h["rounds"] * LAYERS
          and d.stats["attn_kernel_launches"] == h["draft_steps"]
          * SPEC_DRAFT["num_layers"]
          and launches == t.stats["attn_kernel_launches"]
          + d.stats["attn_kernel_launches"],
          f"spec: K1 launches {launches}: target "
          f"{t.stats['attn_kernel_launches']} for {h['rounds']} rounds, "
          f"draft {d.stats['attn_kernel_launches']} for "
          f"{h['draft_steps']} steps")
    fb = spec(step_timeout_s=WATCHDOG_S)
    fres = _with_plan(f"serve_slow@{SPEC_SLOW_STEP}",
                      lambda: fb.run(burst(1)))
    check(fb.fallback is not None and "watchdog" in fb.fallback
          and fb.draft_engine.degraded is not None,
          f"spec: the draft's watchdog trip did not fall back "
          f"({fb.fallback})")
    check([r.tokens for r in fres] == [r.tokens for r in ref],
          "spec: the fallback run's tokens differ from target-only")
    # the mixed burst's seeded and greedy rows apart: a row's proposals
    # and verdicts depend only on its own request (rows are independent
    # and k is fixed), so each half run alone earns what its rows earned
    # in the mixed run, and the halves' tallies add up to the mixed one
    halves = {}
    for kind in ("seeded", "greedy"):
        reqs = [r for r in burst(1) if (r.temperature > 0) == (kind ==
                                                               "seeded")]
        he = spec()
        he.run(reqs)
        hh = he.health()["speculative"]
        halves[kind] = {"requests": len(reqs), "proposed": hh["proposed"],
                        "accepted": hh["accepted"],
                        "accept_rate": hh["accept_rate"]}
    halves["tallies_add_up"] = all(
        sum(halves[kind][n] for kind in ("seeded", "greedy")) == h[n]
        for n in ("proposed", "accepted"))
    # coupled sampling on the card: the target as its own draft proposes
    # the target's own samples (the same generator state at each output
    # index), so every seeded proposal is accepted
    sel = [i for i, r in enumerate(burst(1)) if r.temperature > 0]
    own = SpeculativeEngine(target(), target(), k=SPEC_K)
    ores = own.run([burst(1)[i] for i in sel])
    oh = own.health()["speculative"]
    check([r.tokens for r in ores] == [ref[i].tokens for i in sel],
          "spec: the target-as-draft run's tokens differ from target-only")
    check(oh["proposed"] > 0 and oh["accepted"] == oh["proposed"],
          f"spec: the target as its own draft had {oh['accepted']} of "
          f"{oh['proposed']} seeded proposals accepted")
    halves["target_as_draft_seeded"] = {"proposed": oh["proposed"],
                                        "accepted": oh["accepted"]}
    # the same burst all greedy: the accept rate the draft earns on
    # greedy rows alone
    gref, gref_dt = timed(target(), sampled_every=0)
    geng = spec()
    gres, gdt = timed(geng, sampled_every=0)
    check([r.tokens for r in gres] == [r.tokens for r in gref],
          "spec: the greedy burst's speculative tokens differ")
    gh = geng.health()["speculative"]
    n_tok = sum(len(r.tokens) for r in res)
    g_tok = sum(len(r.tokens) for r in gres)
    emit("spec", k=SPEC_K, slots=SLOTS, requests=len(res),
         new_tokens=n_tok, draft=SPEC_DRAFT, eps=SPEC_EPS,
         row_bits=bits, accept_rate=h["accept_rate"],
         accept_by_kind=halves,
         tokens_per_round=h["tokens_per_round"], rounds=h["rounds"],
         draft_steps=h["draft_steps"], verify_rows=verify_rows,
         kernel_launches=launches, spec_seconds=dt,
         target_only_seconds=ref_dt,
         spec_tokens_per_sec=n_tok / dt,
         target_only_tokens_per_sec=n_tok / ref_dt,
         speedup=ref_dt / dt,
         greedy_accept_rate=gh["accept_rate"],
         greedy_tokens_per_round=gh["tokens_per_round"],
         greedy_spec_tokens_per_sec=g_tok / gdt,
         greedy_target_only_tokens_per_sec=g_tok / gref_dt,
         greedy_speedup=gref_dt / gdt, fallback=fb.fallback,
         fallback_rounds=fb.health()["speculative"]["rounds"],
         card=nvidia_smi())
    return launches


# ------------------------------- the training plane's telemetry (A.9)
TELEM_WARMUP, TELEM_STEPS = 2, 10  # phase_trainer's window
TELEM_ORDER = ("on", "off", "off", "on")    # runs in turns


def _telem_run(obs_on, ckpt=None, resume=False, steps=None):
    """The 43M LM's Optimizer loop (`_trainer`'s configuration) for
    TELEM_WARMUP + TELEM_STEPS steps with obs on or off: (the losses, as
    the loop holds them, the timed window's seconds, the host seconds
    spent in StepTelemetry.emit_step, the events, the registry
    snapshot). `ckpt` checkpoints every TELEM_WARMUP steps under it;
    `resume` resumes from it first."""
    import torch

    from bigdl_tpu_torch import nn, obs
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.obs.training import StepTelemetry
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    steps = steps or TELEM_WARMUP + TELEM_STEPS
    model = _train_model()
    model.build(torch.Generator().manual_seed(0))
    samples = synthetic_next_token(TRAIN_BATCH * steps, VOCAB, TRAIN_SEQ)
    losses, marks = [], {}
    stop = Trigger.max_iteration(steps)

    def end_when(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == TELEM_WARMUP:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
            marks["emit0"] = box["emit"]
        elif state["neval"] == TELEM_WARMUP + TELEM_STEPS:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["emit1"] = box["emit"]
        return stop(state)

    box = {"emit": 0.0}
    real = StepTelemetry.emit_step

    def timed(self, **kw):
        t0 = time.perf_counter()
        try:
            return real(self, **kw)
        finally:
            box["emit"] += time.perf_counter() - t0

    prev = obs.set_enabled(obs_on)
    obs.reset_all()
    StepTelemetry.emit_step = timed
    try:
        opt = Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
                        batch_size=TRAIN_BATCH) \
            .set_optim_method(Adam(3e-4)).set_precision("bf16") \
            .set_end_when(Trigger(end_when))
        if ckpt is not None:
            opt.set_checkpoint(str(ckpt),
                               Trigger.several_iteration(TELEM_WARMUP))
        if resume:
            opt.resume_from_checkpoint()
        opt.optimize()
        events = obs.get_event_log().events()
        snap = obs.get_registry().snapshot()["metrics"]
    finally:
        StepTelemetry.emit_step = real
        obs.reset_all()
        obs.set_enabled(prev)
    window = marks["t1"] - marks["t0"] if "t1" in marks else None
    emit_s = marks["emit1"] - marks["emit0"] if "emit1" in marks else None
    return losses, window, emit_s, events, snap


def _telem_counter(snap, name):
    series = snap.get(name, {}).get("series", [])
    return sum(s.get("value", s.get("count", 0)) for s in series)


def phase_train_telemetry():
    """The training plane's telemetry on the card (obs/training.py,
    optim/metrics.py, utils/anomaly.py, serialization/checkpoint.py):
    the 43M LM's Optimizer loop, TELEM_WARMUP + TELEM_STEPS steps (the
    trainer phase's configuration and window), with obs enabled and
    disabled in turns (TELEM_ORDER). Gates: the loss streams of every
    run bitwise equal (telemetry reads only host values the loop
    already holds, so it cannot move a step); with obs on, one
    `train_step` event a step, `training_steps_total` and
    `training_records_total` equal to the steps and the records, the
    `training_phase_seconds` series present; with obs off, no event and
    no series; a save (checkpoint every TELEM_WARMUP steps) records
    `checkpoint_save` and its histogram, a resume from it one
    `checkpoint_load`. Reported: step ms of each run (median, min, max
    by setting), the host ms a step inside StepTelemetry.emit_step, and
    flash launches of the timed window of each run."""
    import shutil
    import tempfile

    import torch

    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    t_phase = time.perf_counter()
    runs = {"on": [], "off": []}
    streams, launches = [], []
    for mode in TELEM_ORDER:
        torch.cuda.empty_cache()
        fa.fwd_launches = fa.bwd_launches = 0
        losses, window, emit_s, events, snap = _telem_run(mode == "on")
        launches.append((fa.fwd_launches, fa.bwd_launches))
        steps = TELEM_WARMUP + TELEM_STEPS
        streams.append(torch.stack(losses).float().cpu())
        n_ev = sum(e["kind"] == "train_step" for e in events)
        if mode == "on":
            check(n_ev == steps and _telem_counter(
                snap, "training_steps_total") == steps
                and _telem_counter(snap, "training_records_total")
                == steps * TRAIN_BATCH
                and snap.get("training_phase_seconds", {}).get("series"),
                f"train_telemetry: obs on recorded {n_ev} train_step "
                f"events and {sorted(snap)} for {steps} steps")
        else:
            series = {k for k, f in snap.items() if f["series"]}
            check(not events and not series,
                  f"train_telemetry: obs off recorded {len(events)} "
                  f"events and the series {sorted(series)}")
        runs[mode].append({"step_ms": window / TELEM_STEPS * 1e3,
                           "emit_host_ms_a_step":
                               emit_s / TELEM_STEPS * 1e3,
                           "train_step_events": n_ev})
    check(all(torch.equal(s, streams[0]) for s in streams[1:]),
          "train_telemetry: the loss streams differ between obs on and "
          "off")
    layers = TRAIN_CONFIG["num_layers"]
    check(all(f == steps * layers and b == steps * layers * fa.BWD_LAUNCHES
              for f, b in launches),
          f"train_telemetry: flash launches {launches}")
    # a save, then a resume: the checkpoint writer's records
    tmp = tempfile.mkdtemp(prefix="telemetry_ckpt_")
    try:
        torch.cuda.empty_cache()
        _, _, _, saved_ev, saved_snap = _telem_run(
            True, ckpt=tmp, steps=TELEM_WARMUP)
        torch.cuda.empty_cache()
        _, _, _, resumed_ev, _ = _telem_run(
            True, ckpt=tmp, resume=True, steps=TELEM_WARMUP + 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def kinds(evs):
        out = {}
        for e in evs:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    saves = [e for e in saved_ev if e["kind"] == "checkpoint_save"]
    loads = [e for e in resumed_ev if e["kind"] == "checkpoint_load"]
    check(len(saves) == 1 and saves[0]["step"] == TELEM_WARMUP
          and _telem_counter(saved_snap, "training_checkpoint_seconds") == 1
          and len(loads) == 1 and loads[0]["path"].endswith(
              f"checkpoint-{TELEM_WARMUP}")
          and kinds(resumed_ev).get("train_step") == 1,
          f"train_telemetry: save events {kinds(saved_ev)}, resume "
          f"events {kinds(resumed_ev)}")

    def spread(mode, key):
        vals = [r[key] for r in runs[mode]]
        return {"median": statistics.median(vals), "min": min(vals),
                "max": max(vals), "runs": vals}

    emit("train_telemetry", order=list(TELEM_ORDER), steps=TELEM_STEPS,
         warmup_steps=TELEM_WARMUP, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         step_ms={m: spread(m, "step_ms") for m in runs},
         emit_host_ms_a_step={m: spread(m, "emit_host_ms_a_step")
                              for m in runs},
         losses_bitwise_equal=True,
         launches={"fwd": launches[0][0], "bwd": launches[0][1]},
         checkpoint={"save": kinds(saved_ev), "resume": kinds(resumed_ev),
                     "save_seconds": saves[0]["duration_s"]},
         seconds=time.perf_counter() - t_phase, card=nvidia_smi())
    return launches[0]


# ----------------------------------------- draft distillation (A.9)
DISTILL_EPOCHS = 2              # the JAX DraftDistiller's defaults
DISTILL_SEQ = 16
DISTILL_BATCH = 32
DISTILL_LR = 3e-3
# a study beside the main path: windows that span a stream, so the
# draft trains at the positions it serves (the new tokens sit at 256 to
# 287); 280 = 2 x 140 splits into loss chunks (a 287-token window would
# not), and a 288-token stream holds two such windows
DISTILL_FULL_SEQ = 280
DISTILL_FULL_BATCH = 8
DISTILL_FULL_EPOCHS = 4


def _distill_accept(make_spec, reqs):
    """Accept rates of the seeded and the greedy rows of `reqs`, each
    half run alone on a fresh speculative engine (a row's proposals and
    verdicts depend only on its own request)."""
    out = {}
    for kind in ("seeded", "greedy"):
        half = [r for r in reqs if (r.temperature > 0) == (kind == "seeded")]
        eng = make_spec()
        eng.run(half)
        h = eng.health()["speculative"]
        out[kind] = {"requests": len(half), "proposed": h["proposed"],
                     "accepted": h["accepted"],
                     "accept_rate": h["accept_rate"]}
    return out


def phase_distill(model, params):
    """Draft distillation on the card (serving/distill.py): the spec
    phase's setup (the 43M target with SPEC_EPS's planted
    predictability, the SPEC_DRAFT draft, k = SPEC_K, the same
    SPEC_REQUESTS-request burst). The target-only engine's emitted
    streams are ingested into a DraftDistiller (the JAX distiller's
    defaults), which trains the draft on copies through
    `Optimizer(...).set_mesh(make_mesh({"data": 1}), zero=2)` on the
    card: the flash kernels K2-K5, launched exactly the draft's layers
    (x BWD_LAUNCHES) times a step, counted from 0. A second distill
    from the same weights over the same streams gives bitwise-equal
    variables. The distilled draft is hot-swapped (`swap_draft`) into a
    live adaptive SpeculativeEngine, which serves a second burst: its
    tokens bitwise the target-only engine's, greedy and seeded rows, and
    K1 launched once a layer a verify pass (its LAYERS) and a draft step
    (the draft's), counted from 0. Reported: accept rate before and
    after the swap, seeded and greedy rows apart, on the second burst;
    spec and target-only tokens/s before and after; the distill's
    seconds."""
    import torch

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import (DraftDistiller, InferenceEngine,
                                         Request, SpeculativeEngine)

    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    tp, draft, dp = _spec_models(model, params)
    draft.variables = {"params": dp, "state": {}}
    knobs = dict(slots=SLOTS, max_len=FLEET_MAX_LEN,
                 prefill_buckets=FLEET_BUCKETS, block_size=BLOCK)

    def target():
        return InferenceEngine(model, tp, **knobs)

    def spec(variables, **kw):
        return SpeculativeEngine(InferenceEngine(draft, variables, **knobs),
                                 target(), k=SPEC_K, **kw)

    def burst(seed):
        return [Request(**s) for s in
                _fleet_burst(seed, SPEC_REQUESTS, SPEC_NEW)]

    def timed(eng, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(burst(seed))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    spec(dp).run(burst(99)[:SLOTS + 1])               # warm-up
    # the corpus: the target-only engine's streams of the first burst
    ref1, ref1_dt = timed(target(), 1)
    ref2, ref2_dt = timed(target(), 2)
    before_res, before_dt = timed(spec(dp), 2)
    check([r.tokens for r in before_res] == [r.tokens for r in ref2],
          "distill: the planted draft's tokens differ from target-only")
    before = _distill_accept(lambda: spec(dp), burst(2))

    def distiller():
        d = DraftDistiller(draft, seq_len=DISTILL_SEQ,
                           batch_size=DISTILL_BATCH,
                           learningrate=DISTILL_LR, epochs=DISTILL_EPOCHS)
        windows = sum(d.ingest(r) for r in ref1)
        return d, windows

    start = tree_map(lambda t: t.detach().clone(), draft.variables)
    d, windows = distiller()
    prev = obs.set_enabled(True)
    obs.reset_all()
    try:
        torch.cuda.synchronize()
        fa.fwd_launches = fa.bwd_launches = 0        # main path starts
        t0 = time.perf_counter()
        distilled = d.distill()
        torch.cuda.synchronize()
        distill_s = time.perf_counter() - t0
        k2, k3 = fa.fwd_launches, fa.bwd_launches    # main path ends
        steps = sum(e["kind"] == "train_step"
                    for e in obs.get_event_log().events())
    finally:
        obs.reset_all()
        obs.set_enabled(prev)
    layers = SPEC_DRAFT["num_layers"]
    check(steps > 0 and k2 == steps * layers
          and k3 == steps * layers * fa.BWD_LAUNCHES,
          f"distill: flash launches {k2} / {k3} for {steps} steps of "
          f"{layers} layers")
    again = tree_map(lambda t: t.detach().clone(), start)
    draft.variables = again
    d2, _ = distiller()
    redone = d2.distill()
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(distilled), tree_leaves(redone)))
    check(bitwise, "distill: two distills over the same streams differ: "
          + str([float((a - b).abs().max()) for a, b in
                 zip(tree_leaves(distilled), tree_leaves(redone))]))
    served = {t.data_ptr() for t in tree_leaves(dp)}
    check(not any(t.data_ptr() in served for t in tree_leaves(distilled)),
          "distill: the distilled draft shares storage with the served "
          "draft")
    # hot-swap into a live adaptive engine, then the second burst
    live = spec(dp, adapt_k=True)
    live.run(burst(99)[:SLOTS])
    live.swap_draft(distilled)
    t, dr = live.target_engine, live.draft_engine
    t0_launch = t.stats["attn_kernel_launches"]
    d0_launch = dr.stats["attn_kernel_launches"]
    t0_steps = t.stats["decode_steps"]
    h0 = dict(live.health()["speculative"])
    paged_decode.launches = 0                         # main path starts
    after_res, after_dt = timed(live, 2)
    launches = paged_decode.launches                  # main path ends
    h = live.health()["speculative"]
    check([r.tokens for r in after_res] == [r.tokens for r in ref2]
          and all(r.status == "done" for r in after_res),
          "distill: the swapped draft's tokens differ from target-only")
    # verify passes and, where the adaptive ladder suspended
    # speculation, the target's own cruise steps: each a decode step
    rounds = h["rounds"] - h0["rounds"]
    tsteps = t.stats["decode_steps"] - t0_steps
    dsteps = h["draft_steps"] - h0["draft_steps"]
    tl = t.stats["attn_kernel_launches"] - t0_launch
    dl = dr.stats["attn_kernel_launches"] - d0_launch
    check(rounds > 0 and tl == tsteps * LAYERS
          and dl == dsteps * SPEC_DRAFT["num_layers"]
          and launches == tl + dl,
          f"distill: K1 launches {launches}: target {tl} for {tsteps} "
          f"decode steps ({rounds} verify passes), draft {dl} for "
          f"{dsteps} draft steps")
    after = _distill_accept(lambda: spec(distilled), burst(2))
    # the study: the same corpus in whole-stream windows, from the same
    # start
    draft.variables = tree_map(lambda t: t.detach().clone(), start)
    full = DraftDistiller(draft, seq_len=DISTILL_FULL_SEQ,
                          batch_size=DISTILL_FULL_BATCH,
                          learningrate=DISTILL_LR,
                          epochs=DISTILL_FULL_EPOCHS)
    full_windows = sum(full.ingest(r) for r in ref1)
    t0 = time.perf_counter()
    full_vars = full.distill()
    full_s = time.perf_counter() - t0
    full_res, full_dt = timed(spec(full_vars), 2)
    check([r.tokens for r in full_res] == [r.tokens for r in ref2],
          "distill: the whole-stream draft's tokens differ from "
          "target-only")
    full_accept = _distill_accept(lambda: spec(full_vars), burst(2))
    n_tok = sum(len(r.tokens) for r in ref2)
    emit("distill", windows=windows, seq_len=DISTILL_SEQ,
         batch=DISTILL_BATCH, epochs=DISTILL_EPOCHS, lr=DISTILL_LR,
         train_steps=steps, distill_seconds=distill_s,
         flash_launches={"fwd": k2, "bwd": k3},
         two_distills_bitwise=bitwise,
         accept_before=before, accept_after=after,
         swapped_engine={"rounds": rounds, "target_steps": tsteps,
                         "draft_steps": dsteps,
                         "k_live": h.get("k_live"),
                         "last_swap": h.get("last_swap")},
         kernel_launches=launches,
         target_only_tokens_per_sec=n_tok / ref2_dt,
         spec_tokens_per_sec_before=n_tok / before_dt,
         spec_tokens_per_sec_after=n_tok / after_dt,
         speedup_before=ref2_dt / before_dt,
         speedup_after=ref2_dt / after_dt,
         whole_stream_windows={
             "seq_len": DISTILL_FULL_SEQ, "windows": full_windows,
             "batch": DISTILL_FULL_BATCH, "epochs": DISTILL_FULL_EPOCHS,
             "distill_seconds": full_s, "accept": full_accept,
             "spec_tokens_per_sec": n_tok / full_dt,
             "speedup": ref2_dt / full_dt},
         card=nvidia_smi())
    return launches, (k2, k3)


# --------------------------------- a vision group beside the LM pool (A.9)
VFLEET_IMAGES = 64              # LeNet-5 requests in the mixed burst
VFLEET_BATCH = 8                # a vision engine's fixed batch
VFLEET_ENGINES = 2              # the vision group
VFLEET_FEATURES = 28 * 28       # BASELINE config 1's flattened image


def _vfleet_images(n, seed):
    """`n` synthetic_mnist images as pixel ints in [0, 255] (the
    features a vision request carries) and their labels."""
    import numpy as np

    from bigdl_tpu_torch.dataset.mnist import synthetic_mnist

    imgs = np.stack([s.feature for s in synthetic_mnist(n, seed=seed)])
    return np.clip(np.round(imgs * 64.0 + 64.0), 0, 255).astype(np.int64)


def phase_vision_fleet(model, params):
    """The vision engine on the card (serving/vision.py): one
    EngineRouter over the fleet phase's LM pool (two 43M engines on K1)
    and a `model_tag="vision"` group of VFLEET_ENGINES VisionEngines
    over one LeNet-5 (BASELINE config 1, feature_len 784, batch
    VFLEET_BATCH, cuDNN deterministic), serving one mixed burst — the
    fleet phase's FLEET_REQUESTS LM requests interleaved with
    VFLEET_IMAGES images — on a virtual clock. Gates: argmax ties break
    to the lowest index on the card; every request
    settles once (none lost); the classes equal
    `Predictor.predict_class` on the same images and weights at the same
    batch; the LM tokens bitwise the LM-only fleet's on the same
    requests; K1 launches equal the LM engines' decode steps x LAYERS;
    the vision group built its forward once (`forward_traces`).
    Reported: images/s (the vision engines' step wall), the router's
    host ms a round (router.step wall less every engine's decode,
    admission and vision step wall), forward_traces."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.serving import (EngineRouter, InferenceEngine,
                                         Request, VisionEngine)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = lenet.build(10).build(torch.Generator().manual_seed(7))
        weights = net.variables
        imgs = _vfleet_images(VFLEET_IMAGES, seed=11)

        def predict_fn(feats):
            return net.apply(weights, feats.reshape(-1, 28, 28, 1))[0]

        want = Predictor(net, batch_size=VFLEET_BATCH).predict_class(
            DataSet.array([Sample(im.astype("float32"), 0) for im in imgs])
        ).cpu().tolist()
        knobs = dict(slots=SLOTS, max_len=FLEET_MAX_LEN,
                     prefill_buckets=FLEET_BUCKETS, block_size=BLOCK)
        specs = _fleet_burst(21, FLEET_REQUESTS, FLEET_NEW)

        def serve(with_vision):
            clk = _Clock()
            wall = {}
            lm = [InferenceEngine(model, params, clock=clk,
                                  obs_label=f"vl{i}", **knobs)
                  for i in range(2)]
            for e in lm:
                for name in ("_dispatch_and_fetch", "_admit_into"):
                    _fleet_wall(e, name, wall)
            vis = []
            if with_vision:
                vis = [VisionEngine(predict_fn, batch=VFLEET_BATCH,
                                    feature_len=VFLEET_FEATURES,
                                    model_tag="vision", clock=clk,
                                    obs_label=f"vv{i}")
                       for i in range(VFLEET_ENGINES)]
                for e in vis:
                    _fleet_wall(e, "step", wall)
            router = EngineRouter(lm + vis, clock=clk, obs_label="rv")
            reqs = [("lm", i, Request(**s)) for i, s in enumerate(specs)]
            if with_vision:
                per = VFLEET_IMAGES // FLEET_REQUESTS
                mixed = []
                for i, r in enumerate(reqs):
                    mixed.append(r)
                    mixed.extend(("vision", i * per + j, Request(
                        prompt=[int(p) for p in imgs[i * per + j].ravel()],
                        max_new_tokens=1, model_tag="vision"))
                        for j in range(per))
                reqs = mixed
            ids = {router.submit(r): (kind, i) for kind, i, r in reqs}
            got, rounds, step_wall = {}, 0, 0.0
            torch.cuda.synchronize()
            paged_decode.launches = 0
            t0 = time.perf_counter()
            while len(got) < len(ids):
                rounds += 1
                check(rounds <= 2000, f"vision_fleet: stalled at "
                      f"{len(got)} of {len(ids)}")
                clk.t += FLEET_STEP_S
                s0 = time.perf_counter()
                for res in router.step():
                    check(res.id not in got, f"vision_fleet: request "
                          f"{res.id} settled twice")
                    got[res.id] = res
                # router.step() ends in each engine's per-step fetch
                step_wall += time.perf_counter() - s0  # graftlint: disable=unfenced-timing
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out = {"lm": {}, "vision": {}}
            for rid, (kind, i) in ids.items():
                out[kind][i] = got[rid]
            steps = sum(e.stats["decode_steps"] for e in lm)
            return {"results": out, "launches": paged_decode.launches,
                    "decode_steps": steps, "rounds": rounds,
                    "seconds": seconds, "step_wall": step_wall,
                    "wall": wall, "vision": vis}

        mixed = serve(True)
        alone = serve(False)
    finally:
        torch.backends.cudnn.deterministic = det
    res = mixed["results"]
    check(len(res["lm"]) == FLEET_REQUESTS
          and len(res["vision"]) == VFLEET_IMAGES
          and all(r.status == "done" for k in res for r in res[k].values()),
          "vision_fleet: a request was lost or not done")
    classes = [res["vision"][i].tokens[0] for i in range(VFLEET_IMAGES)]
    check(classes == want, "vision_fleet: classes differ from "
          "Predictor.predict_class")
    check(all(res["lm"][i].tokens == alone["results"]["lm"][i].tokens
              for i in range(FLEET_REQUESTS)),
          "vision_fleet: LM tokens differ from the LM-only fleet's")
    for run in (mixed, alone):
        check(run["launches"] == run["decode_steps"] * LAYERS,
              f"vision_fleet: K1 launches {run['launches']} for "
              f"{run['decode_steps']} decode steps")
    # argmax ties break to the lowest index on the card, as the JAX
    # engine's jnp.argmax does: rows of equal maxima, one wide
    ties = torch.zeros(4, 1000, device="cuda")
    ties[1, [300, 700]] = 1.0
    ties[2, 999] = 1.0
    ties[3, [5, 6, 998]] = 2.0
    check(torch.argmax(ties, dim=-1).tolist() == [0, 300, 999, 5],
          f"vision_fleet: argmax ties {torch.argmax(ties, dim=-1)}")
    traces = [e.stats["forward_traces"] for e in mixed["vision"]]
    forwards = sum(e.stats["forwards"] for e in mixed["vision"])
    # the build count is process-wide, each engine's a delta since its
    # creation: one shared forward built once reads 1 on each
    check(traces == [1] * VFLEET_ENGINES,
          f"vision_fleet: forward builds {traces}")
    vis_wall = mixed["wall"].get("step", 0.0)
    engines_wall = sum(mixed["wall"].values())
    emit("vision_fleet", lm_requests=FLEET_REQUESTS,
         images=VFLEET_IMAGES, vision_engines=VFLEET_ENGINES,
         vision_batch=VFLEET_BATCH, feature_len=VFLEET_FEATURES,
         classes_equal_predictor=True, lm_tokens_bitwise_lm_only=True,
         rounds=mixed["rounds"], lm_only_rounds=alone["rounds"],
         seconds=mixed["seconds"], lm_only_seconds=alone["seconds"],
         kernel_launches=mixed["launches"],
         decode_steps=mixed["decode_steps"], forwards=forwards,
         forward_traces=traces,
         images_per_sec=VFLEET_IMAGES / vis_wall,
         images_per_sec_of_the_burst=VFLEET_IMAGES / mixed["seconds"],
         router_host_ms_a_round=(mixed["step_wall"] - engines_wall)
         / mixed["rounds"] * 1e3,
         lm_only_router_host_ms_a_round=(
             alone["step_wall"] - sum(alone["wall"].values()))
         / alone["rounds"] * 1e3,
         card=nvidia_smi())
    return mixed["launches"]


# ------------------------------ the fleet simulator's calibration (A.9)
SIMCAL_RUNS = 3                 # step_study.calibration's timed rounds
SIMCAL_SLOTS = 4                # the JAX divergence test's fleet
SIMCAL_BUCKETS = (8, 16, 32)
SIMCAL_MAX_LEN = 96
SIMCAL_STEP_DT = 0.25           # virtual seconds a round (the replay's)
SIMCAL_TRACE = {"name": "simcal", "seed": 3, "shapes": [
    {"kind": "steady", "n": 24, "t0": 0.0, "rate": 6.0}]}


def phase_sim_calibration(model, params):
    """The fleet simulator (serving/sim.py) calibrated on the card: the
    43M engine's decode ms a token and prefill ms a prompt token, read
    by serving/step_study.py's `calibration` (SIMCAL_RUNS rounds), with
    the card's name and power limit and the torch version, written to
    chiprun_out/sim_calibration.json (the committed
    bigdl_tpu_torch/serving/sim_calibration.json is such a reading).
    Then one 24-request seeded trace (scenarios.compile_scenario of
    SIMCAL_TRACE: Poisson at 6/s, the load generator's request fields)
    replays through a real one-engine fleet of the 43M LM (SIMCAL_SLOTS
    slots, K1) and through a SimulatedEngine fleet over this reading
    with per-step pacing, both through the scripts' load generator
    (bigdl_tpu_torch/scripts/loadgen.py `replay`, SIMCAL_STEP_DT virtual
    seconds a round) and its report. Gates:
    the terminal counts and the goodput tokens agree exactly; K1
    launches equal the real engine's decode steps x LAYERS. Reported:
    the relative divergence of the p50 and p99 latency, the p50 TTFT
    and the makespan, beside the JAX divergence test's tolerance
    max(0.25, 1.5 x the reading's spread)."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.scripts.loadgen import replay
    from bigdl_tpu_torch.serving import (CostModel, EngineRouter,
                                         InferenceEngine, SimulatedEngine,
                                         compile_scenario, step_study)

    t_phase = time.perf_counter()
    eng = InferenceEngine(model, params, **ENGINE_KNOBS)
    reading = step_study.calibration(sys.modules[__name__], eng,
                                     SIMCAL_RUNS)
    reading.update(card=nvidia_smi(), torch=torch.__version__,
                   pr=21, tool="bigdl_tpu_torch/serving/step_study.py "
                   "calibration, chip_smoke.py phase sim_calibration")
    del eng
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "sim_calibration.json"
    path.write_text(json.dumps(reading, indent=1))
    cost = CostModel.from_card_reading(str(path))
    prov = cost.provenance()
    check(prov["source"] == "card_reading"
          and prov["sources"][0]["card"] == reading["card"],
          f"sim_calibration: provenance {prov}")
    from bigdl_tpu_torch.serving.sim import CARD_CALIBRATION

    committed = CostModel.default().provenance() \
        if os.path.exists(CARD_CALIBRATION) else None
    reports = {}
    for mode in ("real", "sim"):
        trace = compile_scenario(SIMCAL_TRACE)
        cell = {"t": 0.0}

        def clk():
            return cell["t"]

        if mode == "real":
            e = InferenceEngine(model, params, slots=SIMCAL_SLOTS,
                                prefill_buckets=SIMCAL_BUCKETS,
                                max_len=SIMCAL_MAX_LEN, block_size=BLOCK,
                                clock=clk, obs_label="simcal_real")
        else:
            e = SimulatedEngine(cost, clock=clk, slots=SIMCAL_SLOTS,
                                prefill_buckets=SIMCAL_BUCKETS,
                                pacing="per_step", obs_label="sim0")
        router = EngineRouter([e], clock=clk, obs_label=f"simcal_{mode}")
        torch.cuda.synchronize()
        paged_decode.launches = 0
        t0 = time.perf_counter()
        reports[mode] = replay(router, trace, clock=cell,
                               step_dt=SIMCAL_STEP_DT)
        torch.cuda.synchronize()
        reports[mode]["wall_seconds"] = time.perf_counter() - t0
        reports[mode]["kernel_launches"] = paged_decode.launches
        reports[mode]["decode_steps"] = e.stats["decode_steps"]
    real, sim = reports["real"], reports["sim"]
    check(real["by_status"] == sim["by_status"] == {"done": 24}
          and real["goodput_tokens"] == sim["goodput_tokens"],
          f"sim_calibration: real {real} against simulated {sim}")
    check(real["kernel_launches"] == real["decode_steps"] * LAYERS
          and sim["kernel_launches"] == 0,
          f"sim_calibration: K1 launches {real['kernel_launches']} for "
          f"{real['decode_steps']} decode steps")
    tol = max(0.25, 1.5 * cost.spread_frac)
    div = {k: abs(sim[k] - real[k]) / max(abs(real[k]), 1e-9)
           for k in ("latency_p50_s", "latency_p99_s", "ttft_p50_s",
                     "makespan_s")}
    emit("sim_calibration", reading=reading, provenance=prov,
         committed_provenance=committed, reports=reports,
         divergence=div, tolerance=tol,
         within_tolerance={k: v <= tol for k, v in div.items()},
         seconds=time.perf_counter() - t_phase, card=reading["card"])
    return real["kernel_launches"]


# ------------------- the command-line scripts (bigdl_tpu_torch/scripts/)
# scripts_loadgen: the load generator's replay over the fleet phase's 43M
# LM (2 engines of SLOTS slots, the autoscaler up to 3, a p99 objective)
# on a trace of two seeded arrival processes, each SCRIPTS_LG_REQUESTS
# requests behind a shared prefix of SCRIPTS_LG_PREFIX tokens: a bursty
# greedy one and a Poisson sampled one
SCRIPTS_LG_REQUESTS = 32
SCRIPTS_LG_PREFIX = FLEET_CONTEXT - 56          # + a tail of 3-8 tokens
SCRIPTS_LG_NEW = (8, 12, 16)
SCRIPTS_LG_STEP_S = 0.5                         # virtual seconds a round
SCRIPTS_LG_TARGET_P99_S = 6.0
SCRIPTS_LG_CLI = ("--requests", "32", "--engines", "2", "--arrival",
                  "bursty", "--seed", "0")
SCRIPTS_CLI_TIMEOUT_S = 240
# the sections the report surfaces must render for scripts_loadgen's run
SCRIPTS_REPORT_SECTIONS = ("events by kind:", "serving:", "serving SLO:",
                           "request journeys:", "alerts / SLO:",
                           "prefix cache:", "metrics (last snapshot):")
SCRIPTS_CONSOLE_SECTIONS = ("── pool ", "── SLO ", "── alerts ",
                            "── incidents ")
SCRIPTS_URL_SECTIONS = ("── endpoint ", "── objectives ", "── alerts ",
                        "── pool gauges ")


def _scripts_trace():
    """The merged trace (loadgen.make_trace twice, arrivals in time
    order): greedy bursts and sampled Poisson arrivals."""
    from bigdl_tpu_torch.scripts import loadgen

    kw = dict(shared_prefix_len=SCRIPTS_LG_PREFIX, vocab=VOCAB,
              prompt_len_choices=(3, 5, 8), max_new_choices=SCRIPTS_LG_NEW,
              priorities=(0,))
    bursty = loadgen.make_trace(SCRIPTS_LG_REQUESTS, seed=5,
                                arrival="bursty", burst_size=16,
                                burst_gap_s=3.0, temperature=0.0, **kw)
    poisson = loadgen.make_trace(SCRIPTS_LG_REQUESTS, seed=6,
                                 arrival="poisson", rate=4.0,
                                 temperature=0.8, **kw)
    arrivals = sorted(bursty["arrivals"] + poisson["arrivals"],
                      key=lambda a: a.t)
    return {"arrivals": arrivals, "sessions": bursty["sessions"]}


def _scripts_replay(model, params, attn_impl, jsonl=None):
    """One replay of _scripts_trace() through a fresh fleet with engines
    of `attn_impl`, obs on its virtual clock (the event log's file sink
    at `jsonl`, and a metrics snapshot at the end, when given). Returns
    (report, {prompt: (status, tokens, greedy)}, K1 launches, decode
    steps, the obs objects the report surfaces read)."""
    import torch

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.scripts import loadgen
    from bigdl_tpu_torch.serving import (Autoscaler, EngineRouter,
                                         InferenceEngine)

    cell = {"t": 0.0}

    def clk():
        return cell["t"]

    trace = _scripts_trace()
    greedy = {tuple(a.spec["prompt"]): a.spec["temperature"] == 0.0
              for a in trace["arrivals"]}
    obs.reset_all(clock=clk)
    if jsonl is not None:
        obs.set_event_log(obs.EventLog(capacity=1 << 16, path=str(jsonl),
                                       clock=clk))
    made = []

    def engine():
        e = InferenceEngine(model, params, slots=SLOTS,
                            max_len=FLEET_MAX_LEN,
                            prefill_buckets=FLEET_BUCKETS, block_size=BLOCK,
                            clock=clk, attn_impl=attn_impl,
                            obs_label=f"lg{len(made)}")
        made.append(e)
        return e

    router = EngineRouter([engine(), engine()], engine_factory=engine,
                          clock=clk, obs_label="lg")
    asc = Autoscaler(router, target_p99_s=SCRIPTS_LG_TARGET_P99_S,
                     max_engines=3, evaluate_every_s=SCRIPTS_LG_STEP_S)
    step = SCRIPTS_LG_STEP_S
    sampler = obs.MetricsSampler(interval_s=step, capacity=4096, clock=clk)
    alerts = obs.AlertEngine(sampler, [obs.AlertRule(
        name="p99_burn", objective=obs.SLOObjective(
            name="p99", kind="latency_quantile",
            metric="router_request_latency_seconds",
            target=SCRIPTS_LG_TARGET_P99_S, q=0.99, labels={"router": "lg"}),
        kind="burn_rate", long_window_s=20 * step, short_window_s=5 * step,
        clear_s=5 * step)], clock=clk)

    def observer():
        sampler.tick()
        alerts.evaluate()

    got = {}

    def on_result(r):
        key = tuple(r.prompt)
        check(key not in got, "scripts_loadgen: two results of one prompt")
        got[key] = (r.status, list(r.tokens), greedy[key])

    torch.cuda.synchronize()
    paged_decode.launches = 0
    report = loadgen.replay(router, trace, clock=cell, step_dt=step,
                            autoscaler=asc, observer=observer,
                            on_result=on_result)
    torch.cuda.synchronize()
    launches = paged_decode.launches
    sampler.sample()
    report["slo"] = {"objectives": alerts.compliance(),
                     "alerts": {"fired": alerts.fired,
                                "resolved": alerts.resolved}}
    if jsonl is not None:
        obs.log_metrics_snapshot()
    steps = sum(e.stats["decode_steps"] for e in made)
    return report, got, launches, steps, {
        "registry": obs.get_registry(), "sampler": sampler,
        "alerts": alerts, "jsonl": jsonl}


def phase_scripts_loadgen(model, params):
    """The scripts' load generator (bigdl_tpu_torch/scripts/loadgen.py)
    on the card. Its make_trace/replay/_report over an EngineRouter of
    the 43M LM at full width (the fleet phase's model: 2 engines of
    SLOTS slots, the Autoscaler up to 3, a p99 objective ticked each
    round), on _scripts_trace()'s 64 requests: three replays, two
    through K1 (the first writing its events to
    chiprun_out/scripts_loadgen.jsonl) and one on plain-path engines
    (attn_impl="torch"). Gates: the two K1 reports byte-identical; every
    status equal to the plain run's, and every greedy request's tokens;
    K1 launches == decode steps x LAYERS. Then the CLI (SCRIPTS_LG_CLI:
    the tiny LM, K1 at head dim 16) twice as subprocesses, together: the
    two JSON reports byte-identical. Returns what scripts_report reads."""
    from bigdl_tpu_torch import obs

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    jsonl = OUT_DIR / "scripts_loadgen.jsonl"
    if jsonl.exists():
        jsonl.unlink()
    prev = obs.set_enabled(True)
    try:
        walls, runs = {}, {}
        for name, impl, sink in (("kernel", "cuda", jsonl),
                                 ("kernel_again", "cuda", None),
                                 ("plain", "torch", None)):
            t0 = time.perf_counter()
            runs[name] = _scripts_replay(model, params, impl, sink)
            walls[name] = time.perf_counter() - t0
        obs.reset_all()
    finally:
        obs.set_enabled(prev)
    report, got, launches, steps, ctx = runs["kernel"]
    text = json.dumps(report, sort_keys=True)
    check(text == json.dumps(runs["kernel_again"][0], sort_keys=True),
          "scripts_loadgen: two replays' reports differ")
    check(launches > 0 and launches == steps * LAYERS,
          f"scripts_loadgen: K1 launches {launches} != decode steps "
          f"{steps} x {LAYERS}")
    plain = runs["plain"][1]
    check(runs["plain"][2] == 0, "scripts_loadgen: the plain engines "
          "launched K1")
    check(set(plain) == set(got) and all(
        got[k][0] == plain[k][0] for k in got),
          "scripts_loadgen: statuses differ from the plain engines'")
    greedy = [k for k in got if got[k][2]]
    check(greedy and all(got[k][1] == plain[k][1] for k in greedy),
          "scripts_loadgen: greedy tokens differ from the plain engines' "
          f"in {sum(got[k][1] != plain[k][1] for k in greedy)} requests")
    sampled_equal = sum(got[k][1] == plain[k][1] for k in got
                        if not got[k][2])
    # the CLI: two runs at once, on the card
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.scripts.loadgen",
           *SCRIPTS_LG_CLI]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=SCRIPTS_CLI_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        check(p.returncode == 0, f"scripts_loadgen: the CLI exited "
              f"{p.returncode}: {err[-2000:]}")
        outs.append(out)
    cli_seconds = time.perf_counter() - t0
    check(outs[0] == outs[1], "scripts_loadgen: two CLI runs' reports "
          "differ")
    cli = json.loads(outs[0])
    check(cli["by_status"] == {"done": 32}, f"scripts_loadgen: CLI "
          f"statuses {cli['by_status']}")
    emit("scripts_loadgen", requests=report["requests"],
         by_status=report["by_status"],
         goodput_tokens=report["goodput_tokens"],
         makespan_s=report["makespan_s"],
         latency_p99_s=report["latency_p99_s"],
         ttft_p99_s=report["ttft_p99_s"], prefix=report["prefix"],
         autoscale=report.get("autoscale"), slo=report["slo"],
         engines_final=report["pool"]["engines_final"],
         reports_byte_identical=True, decode_steps=steps,
         kernel_launches=launches, greedy_requests=len(greedy),
         greedy_tokens_equal_plain=True,
         sampled_requests_tokens_equal_plain=sampled_equal,
         sampled_requests=len(got) - len(greedy),
         replay_seconds=walls, cli=" ".join(SCRIPTS_LG_CLI),
         cli_by_status=cli["by_status"], cli_goodput=cli["goodput_tokens"],
         cli_byte_identical=True, cli_seconds_two_at_once=cli_seconds,
         seconds=time.perf_counter() - t_phase, card=nvidia_smi())
    return ctx


def phase_scripts_report(ctx):
    """The scripts' report surfaces (bigdl_tpu_torch/scripts/
    obs_report.py and ops_console.py) over scripts_loadgen's JSONL:
    obs_report's render (the stream parser) and ops_console's frame,
    each twice, byte-identical and holding SCRIPTS_REPORT_SECTIONS /
    SCRIPTS_CONSOLE_SECTIONS; then ops_console's `--url` source against
    an obs.ScrapeServer over the replay's registry, sampler and alert
    engine (localhost, port 0)."""
    import io

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.scripts import obs_report, ops_console

    t0 = time.perf_counter()
    path = str(ctx["jsonl"])
    texts = [obs_report.render(obs.stream_jsonl(path)) for _ in range(2)]
    check(texts[0] == texts[1], "scripts_report: two renders differ")
    missing = [s for s in SCRIPTS_REPORT_SECTIONS if s not in texts[0]]
    check(not missing, f"scripts_report: report sections {missing} "
          "missing")
    frames = [ops_console.render_frame(obs.read_jsonl(path))
              for _ in range(2)]
    check(frames[0] == frames[1], "scripts_report: two frames differ")
    missing = [s for s in SCRIPTS_CONSOLE_SECTIONS if s not in frames[0]]
    check(not missing, f"scripts_report: console sections {missing} "
          "missing")
    srv = obs.ScrapeServer(registry=ctx["registry"],
                           sampler=ctx["sampler"],
                           alert_engine=ctx["alerts"])
    port = srv.start()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = ops_console.main(["--url", f"http://127.0.0.1:{port}"])
    finally:
        srv.close()
    url_frame = buf.getvalue()
    check(rc == 0 and all(s in url_frame for s in SCRIPTS_URL_SECTIONS),
          f"scripts_report: the --url frame (exit {rc}): {url_frame[:400]}")
    emit("scripts_report", events=sum(1 for _ in obs.stream_jsonl(path)),
         report_lines=len(texts[0].splitlines()),
         console_lines=len(frames[0].splitlines()),
         url_frame_lines=len(url_frame.splitlines()),
         renders_byte_identical=True,
         seconds=time.perf_counter() - t0)


def phase_scripts_drill():
    """The scripts' fault drill (bigdl_tpu_torch/scripts/fault_drill.py)
    on the card, in this process: every serving leg (the tiny LM at head
    dim 16, its draft at 8) and the six single-process training legs.
    Gates: every leg ok but spec_adapt, whose resume gate fails on the
    JAX package too (reported, not gated); only the tensor-parallel legs
    may skip, and with one card they must (each printed with its
    reason); K1 launched at head dims 8 and 16, counted from 0 over the
    drill. The mesh legs (8 ranks, one card each) are not run here.
    Returns K1's launches by head dim."""
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.scripts import fault_drill

    names = list(fault_drill.SERVING_LEGS) \
        + list(fault_drill.SINGLE_PROCESS_TRAINING_LEGS)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    paged_decode.launches = 0
    paged_decode.launches_by_head_dim.clear()
    results = fault_drill.run_legs(names, "cuda")
    torch.cuda.synchronize()
    by_dim = dict(paged_decode.launches_by_head_dim)
    seconds = time.perf_counter() - t0
    skipped = {n: r["skipped"] for n, r in results.items()
               if "skipped" in r}
    for n, why in skipped.items():
        print(f"scripts_drill: {n} skipped: {why}", flush=True)
    tp_legs = {"fleet_tp_failover", "fleet_journey"}
    check(set(skipped) <= tp_legs, f"scripts_drill: skipped {skipped}")
    check(torch.cuda.device_count() > 1 or set(skipped) == tp_legs,
          f"scripts_drill: with one card the tp legs must skip: {skipped}")
    failed = [n for n, r in results.items()
              if not r["ok"] and n != "spec_adapt"]
    check(not failed, f"scripts_drill: legs failed: {failed}: "
          + json.dumps({n: results[n] for n in failed}, default=str)[:3000])
    check(by_dim.get(8, 0) > 0 and by_dim.get(16, 0) > 0,
          f"scripts_drill: K1 launches by head dim {by_dim}")
    sa = results["spec_adapt"]
    emit("scripts_drill", legs={n: {"ok": r["ok"],
                                    **({"skipped": r["skipped"]}
                                       if "skipped" in r else {})}
                                for n, r in results.items()},
         spec_adapt={k: sa.get(k) for k in (
             "ok", "bit_identical_to_target_only", "requests_lost",
             "collapsed_mid_run", "swap", "report_byte_identical")},
         kernel_launches_by_head_dim=by_dim, seconds=seconds,
         mesh_legs="not run: 8 ranks need 8 cards",
         card=nvidia_smi())
    return by_dim


# --------------------------------------------------- the keras surface
# BASELINE config 4's widths (RNN_VOCAB, RNN_EMBED, RNN_HIDDEN) at the
# BiLSTM trainer's batch and sequence (RNN_BATCH x RNN_SEQ)
KERAS_TRAIN_BATCHES = 6         # batches an epoch
KERAS_EPOCHS = 2
KERAS_HELD_OUT_BATCHES = 2


def _keras_data(batches, seed):
    import numpy as np

    samples = _sentiment_samples(RNN_BATCH * batches, seed)
    return (np.stack([s.feature for s in samples]).astype(np.float32),
            np.stack([s.label for s in samples]))


def _keras_recurrences(module):
    """The nn.Recurrent / nn.BiRecurrent modules inside a built keras
    module (containers and graphs walked)."""
    from bigdl_tpu_torch import nn

    found, todo = [], [module]
    while todo:
        m = todo.pop()
        if isinstance(m, (nn.Recurrent, nn.BiRecurrent)):
            found.append(m)
        todo.extend(getattr(m, "modules_", []))
        todo.extend(n.module for n in getattr(m, "_order", [])
                    if n.module is not None)
    return found


def _keras_first_step(kmodel, x, y):
    """One fp32 loss-and-grad step of a keras model's module through the
    kernels and through the plain versions (every recurrence forced to
    each), as phase_rnn_model holds the BiLSTM: |dloss| and the
    gradients' max relative difference."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import FULL_PRECISION

    module = kmodel.module
    params = module.variables["params"]
    xs = tuple(torch.as_tensor(a).cuda() for a in x) \
        if isinstance(x, (list, tuple)) else torch.as_tensor(x).cuda()
    yt = torch.as_tensor(y).cuda()
    out = {}
    for impl in ("cuda", "torch"):
        for r in _keras_recurrences(module):
            r.fused = impl
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss_call = build_train_loss(module, nn.ClassNLLCriterion(),
                                     FULL_PRECISION)
        loss, _ = loss_call(p, module.variables["state"], xs, yt, None)
        out[impl] = (float(loss.detach()),
                     torch.autograd.grad(loss, tree_leaves(p)))
    for r in _keras_recurrences(module):
        r.fused = None
    torch.cuda.synchronize()
    top = max(float(b.abs().max()) for b in out["torch"][1])
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                               TRAIN_GRAD_FLOOR * top)
              for a, b in zip(out["cuda"][1], out["torch"][1]))
    return abs(out["cuda"][0] - out["torch"][0]), rel


def _keras_leg(name, kmodel, x, y, vx, vy, counters, per_step):
    """compile -> first step kernel vs plain -> fit (bf16, counted and
    timed) -> evaluate and predict (each counted from 0)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.optim import Adam, Loss, Top1Accuracy

    def expect(n_train, n_infer):
        return {c: n_infer if "infer" in c else n_train for c in counters}

    kmodel.compile(Adam(1e-3), "nll",
                   [Top1Accuracy(), Loss(nn.ClassNLLCriterion())])
    kmodel.module.build(torch.Generator().manual_seed(0))
    first = x[:RNN_BATCH] if not isinstance(x, list) \
        else [a[:RNN_BATCH] for a in x]
    dloss, grad_rel = _keras_first_step(kmodel, first, y[:RNN_BATCH])
    check(dloss <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL,
          f"keras {name}: kernels vs plain first step |dloss| {dloss}, "
          f"grad rel {grad_rel}")
    before = kmodel.evaluate(vx, vy, batch_size=RNN_BATCH)

    def zero():
        torch.cuda.synchronize()
        for c in counters:
            setattr(fr, c, 0)

    def read():
        torch.cuda.synchronize()
        return {c: getattr(fr, c) for c in counters}

    zero()                                      # main path starts here
    t0 = time.perf_counter()
    kmodel.fit(x, y, batch_size=RNN_BATCH, epochs=KERAS_EPOCHS,
               precision="bf16")
    fit_launches = read()                       # main path ends here
    fit_s = time.perf_counter() - t0
    steps = KERAS_EPOCHS * KERAS_TRAIN_BATCHES
    check(fit_launches == expect(steps * per_step, 0),
          f"keras {name} fit launches {fit_launches}, {steps} steps")
    zero()
    after = kmodel.evaluate(vx, vy, batch_size=RNN_BATCH)
    eval_launches = read()
    zero()
    probs = kmodel.predict(vx, batch_size=RNN_BATCH)
    pred_launches = read()
    want = expect(0, KERAS_HELD_OUT_BATCHES * per_step)
    check(eval_launches == want and pred_launches == want,
          f"keras {name}: evaluate launched {eval_launches}, predict "
          f"{pred_launches}, expected {want}")
    check(math.isfinite(after["Loss"]) and after["Loss"] < before["Loss"],
          f"keras {name}: held-out loss {before['Loss']} -> "
          f"{after['Loss']} did not fall")
    check(probs.shape == (len(vy), 2) and np.isfinite(probs).all(),
          f"keras {name}: predict gave {probs.shape}")
    # the first fit pays one-time costs (the allocator's first requests
    # after the previous phase's empty_cache, the optimizer's setup);
    # one more epoch, warm, is the steady rate
    zero()
    t0 = time.perf_counter()
    kmodel.fit(x, y, batch_size=RNN_BATCH, epochs=1, precision="bf16")
    warm_launches = read()
    warm_s = time.perf_counter() - t0
    check(warm_launches == expect(KERAS_TRAIN_BATCHES * per_step, 0),
          f"keras {name} second fit launched {warm_launches}")
    return {"first_step": {"loss_abs_diff": dloss,
                           "grad_max_rel_diff": grad_rel},
            "fit_seconds": fit_s, "steps": steps,
            "samples_per_sec": steps * RNN_BATCH / fit_s,
            "warm_epoch_samples_per_sec":
                KERAS_TRAIN_BATCHES * RNN_BATCH / warm_s,
            "held_out_before": before, "held_out_after": after,
            "launches": {"fit": fit_launches, "evaluate": eval_launches,
                         "predict": pred_launches}}


def phase_keras():
    """The keras surface (bigdl_tpu_torch/keras/) at BASELINE config 4's
    widths: `Sequential([Embedding, Bidirectional(LSTM), Dense])` (K8/K9
    in training, K8's inference variant in evaluate/predict), a
    `Sequential([Embedding, GRU, Dense])` (K10/K11, K10's inference
    variant) and a two-input functional `Model` — a BiLSTM branch and a
    GRU branch merged by concatenation — each compiled with Adam and
    fit KERAS_EPOCHS epochs in bf16 over KERAS_TRAIN_BATCHES batches of
    RNN_BATCH x RNN_SEQ, then evaluated and predicted over
    KERAS_HELD_OUT_BATCHES, then fit one more epoch, warm. Gates: the
    first step through the kernels against the plain versions in fp32
    (phase_rnn_model's tolerances), every launch count exact (counted
    from 0 around each fit, evaluate and predict), the held-out loss
    falls. Reported: samples/s of the first fit (its setup included)
    and of the warm epoch, beside phase_rnn_trainer's. Returns the trained BiLSTM model and
    the launch counts."""
    from bigdl_tpu_torch import keras

    x, y = _keras_data(KERAS_TRAIN_BATCHES, 21)
    vx, vy = _keras_data(KERAS_HELD_OUT_BATCHES, 22)
    lstm_c = ("fwd_train_launches", "fwd_infer_launches", "bwd_launches")
    gru_c = ("gru_fwd_train_launches", "gru_fwd_infer_launches",
             "gru_bwd_launches")
    bilstm = keras.Sequential([
        keras.Embedding(RNN_VOCAB, RNN_EMBED, input_length=RNN_SEQ),
        keras.Bidirectional(keras.LSTM(RNN_HIDDEN)),
        keras.Dense(2, activation="log_softmax")])
    out = {"bilstm": _keras_leg("bilstm", bilstm, x, y, vx, vy, lstm_c, 1)}
    gru = keras.Sequential([
        keras.Embedding(RNN_VOCAB, RNN_EMBED, input_length=RNN_SEQ),
        keras.GRU(RNN_HIDDEN), keras.Dense(2, activation="log_softmax")])
    out["gru"] = _keras_leg("gru", gru, x, y, vx, vy, gru_c, 1)

    a, b = keras.Input((RNN_SEQ,)), keras.Input((RNN_SEQ,))
    ha = keras.Bidirectional(keras.LSTM(RNN_HIDDEN))(
        keras.Embedding(RNN_VOCAB, RNN_EMBED)(a))
    hb = keras.GRU(RNN_HIDDEN)(keras.Embedding(RNN_VOCAB, RNN_EMBED)(b))
    two = keras.Model([a, b], keras.Dense(2, activation="log_softmax")(
        keras.merge([ha, hb], mode="concat")))
    out["functional"] = _keras_leg(
        "functional", two, [x, x[:, ::-1].copy()], y,
        [vx, vx[:, ::-1].copy()], vy, lstm_c + gru_c, 1)
    ref = RESULTS["rnn_trainer"]
    emit("keras", batch=RNN_BATCH, seq=RNN_SEQ, vocab=RNN_VOCAB,
         embed=RNN_EMBED, hidden=RNN_HIDDEN, epochs=KERAS_EPOCHS,
         tolerance={"loss": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL},
         rnn_trainer_samples_per_sec=ref["samples_per_sec"], **out)
    return bilstm, {k: v["launches"] for k, v in out.items()}


# ------------------------------------------------------ module files
MODIO_RESNET_BATCH = 2
MODIO_LENET_BATCH = 64
MODIO_INTEROP_TOL = 1e-5        # from_torch vs the torch module, fp32


def _module_file_round_trip(tag, module, variables, xs, tmp):
    """save_module -> load_module on the card: seconds, file MiB, and
    whether the reloaded module's outputs equal the saved one's bit for
    bit on `xs` (eval mode, no autograd)."""
    import torch

    from bigdl_tpu_torch.serialization import load_module, save_module

    d = tmp / tag
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_module(str(d), module, variables)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, lv = load_module(str(d))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        a, _ = module.apply(variables, *xs, training=False)
        b, _ = loaded.apply(lv, *xs, training=False)
    torch.cuda.synchronize()
    check(type(loaded) is type(module) and torch.equal(a, b),
          f"module_io {tag}: the reloaded module's outputs differ")
    return {"save_s": save_s, "load_s": load_s, "mib": _dir_gib(d) * 1024,
            "bitwise": True}


def phase_module_io(keras_bilstm):
    """Module files on the card. save_module/load_module round trips of
    ResNet-50 (fp32, batch MODIO_RESNET_BATCH at 224) and of the keras
    phase's trained BiLSTM (its held-out batches), each reloaded
    module's outputs bitwise equal to the saved one's; save_t7/load_t7
    of LeNet-5 alike; from_torch of a conv/BN/ReLU/pool/Linear
    torch.nn.Sequential built here against that module's own output on
    the card (fp32, MODIO_INTEROP_TOL; the pool reduces to 1 x 1, so
    the NHWC and NCHW flattens agree). Reported: save and load seconds
    and file sizes."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bigdl_tpu_torch.models import lenet, resnet
    from bigdl_tpu_torch.utils.torch_file import load_t7, save_t7
    from bigdl_tpu_torch.utils.torch_interop import from_torch

    tmp = Path(tempfile.mkdtemp(prefix="bigdl-modio-"))
    out = {}
    try:
        g = torch.Generator().manual_seed(0)
        r50 = resnet.build_imagenet(50, 1000)
        x = torch.randn(MODIO_RESNET_BATCH, 224, 224, 3, generator=g).cuda()
        out["resnet50"] = _module_file_round_trip(
            "resnet50", r50, r50.init(torch.Generator().manual_seed(1)),
            (x,), tmp)
        del r50, x
        vx, _ = _keras_data(KERAS_HELD_OUT_BATCHES, 22)
        km = keras_bilstm.module
        out["keras_bilstm"] = _module_file_round_trip(
            "keras_bilstm", km, km.variables,
            (torch.as_tensor(vx).cuda(),), tmp)

        le = lenet.build(10)
        lv = le.init(torch.Generator().manual_seed(2))
        xs = torch.randn(MODIO_LENET_BATCH, 28, 28, 1, generator=g).cuda()
        path = tmp / "lenet.t7"
        t0 = time.perf_counter()
        save_t7(str(path), le, lv)
        t7_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm, lmv = load_t7(str(path))
        torch.cuda.synchronize()
        t7_load = time.perf_counter() - t0
        with torch.no_grad():
            a, _ = le.apply(lv, xs)
            b, _ = lm.apply(lmv, xs)
        check(torch.equal(a, b), "module_io lenet .t7: outputs differ")
        out["lenet_t7"] = {"save_s": t7_save, "load_s": t7_load,
                           "mib": path.stat().st_size / 2 ** 20,
                           "bitwise": True}

        tnn = torch.nn
        torch.manual_seed(3)
        tm = tnn.Sequential(
            tnn.Conv2d(3, 16, 3, padding=1), tnn.BatchNorm2d(16),
            tnn.ReLU(), tnn.MaxPool2d(2), tnn.Conv2d(16, 32, 3, padding=1),
            tnn.BatchNorm2d(32), tnn.ReLU(), tnn.AvgPool2d(16),
            tnn.Flatten(), tnn.Linear(32, 10)).cuda()
        with torch.no_grad():            # non-trivial running statistics
            tm(torch.randn(16, 3, 32, 32, device="cuda"))
        tm.eval()
        xi = torch.randn(8, 3, 32, 32, device="cuda")
        with torch.no_grad():
            want = tm(xi)
            m, v = from_torch(tm, input_layout="NCHW")
            got, _ = m.apply(v, xi, training=False)
        err = float((got - want).abs().max())
        check(err <= MODIO_INTEROP_TOL,
              f"module_io from_torch: {err} > {MODIO_INTEROP_TOL}")
        out["from_torch"] = {"max_abs_err": err,
                             "tolerance": MODIO_INTEROP_TOL,
                             "output": list(got.shape)}
        check(np.isfinite(err), "module_io from_torch: non-finite")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("module_io", **out)


MI_DEVICE = "cuda"
MI_IMAGE, MI_CLASSES = 224, 1000  # BASELINE config 5: VGG-16 at ImageNet's
MI_BATCH, MI_STEPS = 128, 10      # vgg_estimator's batch; timed SGD steps
MI_LR = 0.01                      # SGD, momentum 0.9 (perf.train_step's)
MI_FWD_TOL = 1e-5                 # reloaded vs source forward, fp32, of
                                  # max(1, |source output|)
MI_SEED = 19
MI_CONV_KERNEL = re.compile(r"fprop|dgrad|wgrad|[Cc]onv|implicit")
# VGG_ILSVRC_16_layers' layer names, in build(16)'s order
MI_NAMES = ("conv1_1 relu1_1 conv1_2 relu1_2 pool1 conv2_1 relu2_1 conv2_2 "
            "relu2_2 pool2 conv3_1 relu3_1 conv3_2 relu3_2 conv3_3 relu3_3 "
            "pool3 conv4_1 relu4_1 conv4_2 relu4_2 conv4_3 relu4_3 pool4 "
            "conv5_1 relu5_1 conv5_2 relu5_2 conv5_3 relu5_3 pool5 flatten "
            "fc6 relu6 drop6 fc7 relu7 drop7 fc8 prob").split()


def _mi_vgg(caffe_form: bool):
    """`models/vgg.build(16, MI_CLASSES)` with the reference's layer
    names; `caffe_form` swaps its NHWC Reshape for the Caffe loader's
    flatten idiom (Transpose((2,4),(3,4)) + Reshape((-1,)): InnerProduct
    reads C,H,W) and its LogSoftMax for SoftMax — the form a
    VGG_ILSVRC_16 caffemodel imports as."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import vgg

    base = vgg.build(16, MI_CLASSES, image_size=MI_IMAGE)
    if not caffe_form:
        for mod, name in zip(base.modules_, MI_NAMES):
            mod.set_name(name)
        return base
    m = nn.Sequential()
    for mod, name in zip(base.modules_, MI_NAMES):
        if isinstance(mod, nn.Reshape):
            m.add(nn.Transpose(((2, 4), (3, 4))).set_name(name))
            m.add(nn.Reshape((-1,), batch_mode=True).set_name(name + "_2d"))
        elif isinstance(mod, nn.LogSoftMax):
            m.add(nn.SoftMax().set_name(name))
        else:
            m.add(mod.set_name(name))
    return m


def _mi_params(module, variables) -> list:
    """Every parameter and state tensor in the graph's op order
    (utils/interop.linearize): a Caffe or TF import against its source,
    whatever containers and bias modules each wraps them in."""
    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.utils.interop import linearize

    entries, _ = linearize(module, variables)
    out = [v[part][k] for _, v, _ in entries for part in ("params", "state")
           for k in ("weight", "bias", "running_mean", "running_var")
           if k in v[part]]
    n = len(tree_leaves(variables))
    check(len(out) == n, f"model_import: {len(out)} of {n} leaves in "
          "linearize order")
    return out


def _mi_trainer(model, variables, criterion, x, y):
    """`step(i)`: perf.train_step's step (bf16 compute over fp32
    masters, SGD(MI_LR, momentum 0.9), a loss read one step late by
    the caller) on `model`'s own variables, updated in place."""
    import torch

    from bigdl_tpu_torch.models.convert import tree_leaves
    from bigdl_tpu_torch.nn.module import _fold_rng
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.precision import DEFAULT_MIXED

    method = SGD(learningrate=MI_LR, momentum=0.9, dampening=0.0)
    leaves = [t.requires_grad_() for t in tree_leaves(variables["params"])]
    slots = method.init_slots(leaves)
    loss_call = build_train_loss(model, criterion, DEFAULT_MIXED)
    params, state = variables["params"], variables["state"]
    base = torch.Generator(device=x.device).manual_seed(7)

    def step(i):
        nonlocal state
        loss, state = loss_call(params, state, x, y, _fold_rng(base, i))
        grads = torch.autograd.grad(loss, leaves)
        method.update(grads, leaves, slots, MI_LR, i)
        return loss.detach()

    return step


def _mi_timed(step) -> dict:
    t0 = time.perf_counter()
    first = float(step(0))            # warm-up; the host read fences
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, MI_STEPS + 1):
        loss = step(i)
    last = float(loss)                # depends on every step: the fence
    steady = time.perf_counter() - t0
    check(math.isfinite(first) and math.isfinite(last),
          f"model_import: losses {first}, {last}")
    return {"first_loss": first, "last_loss": last, "warmup_s": warm_s,
            "step_ms": steady / MI_STEPS * 1e3,
            "images_per_sec": MI_STEPS * MI_BATCH / steady}


def _mi_leg(tag, save, load, caffe_form, x, y, tmp, trace_dir=None):
    """One format: build the seeded source, save it to `tmp` (timed),
    reload it on the card (timed), gate the reloaded variables bit for
    bit and the fp32 forward within MI_FWD_TOL, then fine-tune the
    source and then the import, MI_STEPS steps each (with `trace_dir`,
    two more steps of the import under utils/profiler.trace)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import profiler

    src = _mi_vgg(caffe_form)
    sv = src.init(torch.Generator().manual_seed(MI_SEED), MI_DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    files = save(src, sv, tmp)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, mv = load(files)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = _mi_params(src, sv), _mi_params(model, mv)
    check(len(a) == len(b) and all(
        p.shape == q.shape and p.device == q.device and torch.equal(p, q)
        for p, q in zip(a, b)),
        f"model_import {tag}: a reloaded variable differs from its source")
    with torch.no_grad():
        want, _ = src.apply(sv, x, training=False)
        got, _ = model.apply(mv, x, training=False)
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    check(math.isfinite(err) and err <= MI_FWD_TOL * scale,
          f"model_import {tag}: forward {err} > {MI_FWD_TOL} x {scale}")
    out = {"files_mib": sum(os.path.getsize(f) for f in files) / 2 ** 20,
           "save_s": save_s, "load_s": load_s,
           "variables": len(a), "parameters": sum(t.numel() for t in a),
           "bitwise_variables": True, "fwd_max_abs_err": err,
           "fwd_bitwise": bool(torch.equal(got, want)),
           "fwd_tolerance": MI_FWD_TOL * scale,
           "imported_layers": [type(n.module).__name__
                               for n in model._order if n.module][:3]}
    del want, got
    crit = nn.ClassNLLCriterion(logProbAsInput=not caffe_form)
    out["built"] = _mi_timed(_mi_trainer(src, sv, crit, x, y))
    del src, sv
    torch.cuda.empty_cache()
    step = _mi_trainer(model, mv, crit, x, y)
    out["imported"] = _mi_timed(step)
    if trace_dir is not None:
        with profiler.trace(trace_dir):
            for i in (MI_STEPS + 1, MI_STEPS + 2):
                with profiler.step(i):
                    loss = step(i)
            float(loss)
    return out


def phase_model_import():
    """A.10's interop at VGG-16's width (BASELINE config 5, 138.4M
    parameters), on the card. (a) Caffe: the VGG_ILSVRC_16 form of
    `models/vgg.build(16)` (`_mi_vgg`) with seeded weights, persisted
    by `utils/caffe.persist` to .prototxt + .caffemodel and reloaded by
    `utils/caffe.load(device="cuda")`; (b) TensorFlow: `vgg.build(16)`
    as it is, through `utils/tf.save` to a frozen GraphDef and
    `utils/tf.load`. Both through the port's own protobuf codec. Gates
    for each: every reloaded variable equal to its source bit for bit;
    the fp32 forward of a MI_BATCH x 224 x 224 x 3 batch within
    MI_FWD_TOL of the source's (bitwise reported); MI_STEPS SGD steps
    in bf16 at MI_BATCH of the built model and then of the import, in
    this call, losses finite. Reported: save and load seconds, file
    MiB, images/s of both against vgg_estimator's native VGG-16 step.
    (c) The small utils: `Engine.device_count()` is 1 and the device of
    `Engine.default_mesh()` is this card; `profiler.trace` around two
    of (a)'s import steps writes a trace holding convolution kernels;
    `debug_nans` raises on a NaN made on the card, naming the op."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.utils import Engine, caffe, tf
    from bigdl_tpu_torch.utils.debug import debug_nans

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bigdl-mi-"))
    g = torch.Generator().manual_seed(MI_SEED)
    x = torch.rand(MI_BATCH, MI_IMAGE, MI_IMAGE, 3, generator=g) \
        .to(MI_DEVICE)
    y = torch.randint(0, MI_CLASSES, (MI_BATCH,), generator=g,
                      dtype=torch.int32).to(MI_DEVICE)

    def caffe_save(m, v, d):
        files = (str(d / "vgg16.prototxt"), str(d / "vgg16.caffemodel"))
        caffe.persist(*files, m, v, (1, 3, MI_IMAGE, MI_IMAGE),
                      name="VGG_ILSVRC_16_layers")
        return files

    def tf_save(m, v, d):
        path = str(d / "vgg16.pb")
        tf.save(m, v, path, (1, MI_IMAGE, MI_IMAGE, 3))
        return (path,)

    out = {"batch": MI_BATCH, "steps": MI_STEPS, "image": MI_IMAGE}
    try:
        trace_dir = tmp / "trace"
        out["caffe"] = _mi_leg(
            "caffe", caffe_save,
            lambda f: caffe.load(f[0], f[1], device=MI_DEVICE), True, x, y,
            tmp, trace_dir)
        torch.cuda.empty_cache()
        out["tf"] = _mi_leg(
            "tf", tf_save, lambda f: tf.load(f[0], device=MI_DEVICE), False,
            x, y, tmp)
        torch.cuda.empty_cache()
        # (c) the small utils on the card
        Engine.init()
        mesh = Engine.default_mesh(device=MI_DEVICE)
        try:
            kind = torch.cuda.get_device_name(mesh.device)
            check(Engine.device_count() == 1
                  and Engine.local_device_count() == 1
                  and kind == torch.cuda.get_device_name(0),
                  f"model_import: Engine sees {Engine.device_count()} "
                  f"devices of kind {kind!r}")
        finally:
            mesh.close()
        traces = [p for p in trace_dir.rglob("*.pt.trace.json")]
        check(len(traces) == 1, f"model_import: traces {traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        convs = sorted({k for k in kernels if MI_CONV_KERNEL.search(k)})
        steps = [e for e in events if str(e.get("name", "")).startswith(
            "train_step#")]
        check(convs and len(steps) >= 2,
              f"model_import: trace has {len(kernels)} kernels, conv "
              f"kernels {convs[:3]}, step ranges {len(steps)}")
        nan_msg = None
        z = torch.zeros(8, device=MI_DEVICE)
        try:
            with debug_nans():
                z / z
        except FloatingPointError as e:
            nan_msg = str(e)
        check(nan_msg is not None and "aten.div" in nan_msg
              and MI_DEVICE in nan_msg,
              f"model_import: debug_nans raised {nan_msg!r}")
        native = RESULTS.get("vgg_estimator", {}).get("vgg16", {}).get(
            "images_per_sec")
        for leg in ("caffe", "tf"):
            for run in ("built", "imported"):
                r = out[leg][run]
                r["vs_native"] = (r["images_per_sec"] / native
                                  if native else None)
        out["utils"] = {
            "device_count": Engine.device_count(), "device_kind": kind,
            "trace_mib": traces[0].stat().st_size / 2 ** 20,
            "trace_kernels": len(kernels),
            "trace_conv_kernels": [k[:100] for k in convs[:6]],
            "trace_step_ranges": len(steps), "debug_nans": nan_msg}
        out["native_vgg16_images_per_sec"] = native
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("model_import", **out, seconds=time.perf_counter() - t_phase)


# --------------------------------------------------- the LM at two heads
# The trainer's 43M LM (TRAIN_CONFIG) at two heads: the same widths and
# parameter count, head_dim 512 / 2 = 256, so its attention runs the
# D = 256 instantiations of the flash kernels (K2-K5) in training and
# of the paged-decode kernel (K1) in serving.
LM2H_CONFIG = dict(TRAIN_CONFIG, num_heads=2)
LM2H_WARMUP, LM2H_STEPS = 2, 10    # the trainer's
LM2H_REQUESTS = 8                  # greedy requests served afterwards
# the LM at one head: D = 512, the column-split flash kernels and K1's
# 512 tier
LM1H_CONFIG = dict(TRAIN_CONFIG, num_heads=1)
LM1H_WARMUP, LM1H_STEPS = 2, 10
LM1H_REQUESTS = 8


def _lm_at_heads(phase: str, config: dict, warmup: int, steps: int,
                 requests: int):
    """The LM built from `config`: one fp32 loss-and-grad step through
    the kernels against the plain step (the trainer's tolerances), then
    `warmup` + `steps` bf16 steps through `Optimizer(...).optimize()`
    (flash launches counted from zero, the loss must fall), then
    `requests` greedy requests served from the trained weights by
    `InferenceEngine` at the engine's knobs (K1 launches counted from
    zero, == decode steps x layers), whose tokens must equal those of a
    plain-attention engine on the same weights. Returns the launch
    counts of the three main paths."""
    import torch

    from bigdl_tpu_torch.serving import InferenceEngine, Request

    t0 = time.perf_counter()
    step = _kernel_step_check(phase, config)
    fwd, bwd, model = _timed_trainer(f"{phase}_trainer", config, warmup,
                                     steps)
    params = model.variables["params"]
    reqs = _wave(300)[:requests]
    eng = InferenceEngine(model, params, max_len=MAX_LEN, **ENGINE_KNOBS)
    check(eng.attn_impl == "cuda", f"{phase}: engine attn_impl is not cuda")
    res, dt, n_steps, launches = _timed_run(eng, reqs)   # the main path
    layers = config["num_layers"]
    check(launches > 0 and launches == n_steps * layers,
          f"{phase}: K1 launches {launches} != decode steps {n_steps} x "
          f"{layers} layers")
    plain = InferenceEngine(model, params, max_len=MAX_LEN,
                            attn_impl="torch", **ENGINE_KNOBS)
    ref = plain.run([Request(**r) for r in reqs])
    for a, b in zip(res, ref):
        check(a.status == "done" and len(a.tokens) == NEW_TOKENS,
              f"{phase}: request {a.id} {a.status}, {len(a.tokens)} "
              "tokens")
        first = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                      if x != y), None)
        check(a.tokens == b.tokens,
              f"{phase}: request {a.id}'s tokens differ from the plain "
              f"engine's from token {first}")
    n_tok = sum(len(r.tokens) for r in res)
    torch.cuda.synchronize()
    emit(phase, heads=config["num_heads"],
         head_dim=config["dim"] // config["num_heads"],
         fp32_step=step, serving={
             "requests": len(res), "new_tokens": n_tok, "seconds": dt,
             "tokens_per_sec": n_tok / dt, "decode_steps": n_steps,
             "step_ms": dt / n_steps * 1e3, "kernel_launches": launches,
             "plain_engine_tokens_equal": True},
         seconds=time.perf_counter() - t0)
    return {"fwd": fwd, "bwd": bwd, "decode": launches}


def phase_lm2h():
    """The LM at two heads (D = 256), trained and served."""
    return _lm_at_heads("lm2h", LM2H_CONFIG, LM2H_WARMUP, LM2H_STEPS,
                        LM2H_REQUESTS)


def phase_lm1h():
    """The LM at one head (D = 512: the column-split flash kernels, K1
    at its 512 tier), trained and served."""
    return _lm_at_heads("lm1h", LM1H_CONFIG, LM1H_WARMUP, LM1H_STEPS,
                        LM1H_REQUESTS)


# -------------------------------------------------------- dense decode
# TransformerLM's dense-cache decode (`init_cache`, `prefill`,
# `decode_step`) at bench.py bench_lm_decode's configuration: the 43M
# LM, one prompt of DD_CONTEXT seeded tokens, DD_NEW greedy tokens, fp32
# weights in the serving_params layout and an fp32 cache; then DD_BF16_NEW
# steps over a bf16 cache. Prefill runs K2's fp32 forward once a layer;
# decode is plain PyTorch, as the JAX step is plain jnp.
DD_CONTEXT, DD_NEW = 512, 128
DD_MAX_LEN = DD_CONTEXT + DD_NEW
DD_REPS = 3                     # timed runs after one warm-up
DD_GATED = (0, 1, 2, 3, DD_NEW - 1)  # decode steps held to the full forward
DD_LOGIT_TOL = LOGIT_TOL        # fp32 logits vs the full forward, abs
DD_BF16_NEW = 16
DD_BF16_TOL = 0.1               # a bf16 cache: TestDecodeParity's bound


def _dd_run(model, variables, prompt, cache_dtype, new):
    """One bench_lm_decode run: prefill the prompt into a fresh cache,
    then re-decode its last token and chain `new` greedy steps from it
    (the engine's protocol), each argmax on the card. Returns (prefill
    logits (1, V), step logits (new, V), prefill seconds, decode seconds
    a token)."""
    import torch

    cache = model.init_cache(1, DD_MAX_LEN, cache_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = model.prefill(variables, prompt, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = prompt[:, -1]
    pos = torch.full((1,), DD_CONTEXT - 1, dtype=torch.int32,
                     device=prompt.device)
    steps = []
    for i in range(new):
        logits, cache = model.decode_step(variables, tok, pos + i, cache)
        tok = logits.argmax(-1).int()
        steps.append(logits)
    torch.cuda.synchronize()
    return first, torch.cat(steps), t1 - t0, \
        (time.perf_counter() - t1) / new


def _dd_full_logits(model, params, prompt, tokens):
    """The model's full forward (`apply_hidden` @ `head`) over the prompt
    and the generated tokens: (S, V) logits, row p predicting p + 1."""
    import torch

    seq = torch.cat([prompt[0], torch.tensor(tokens, dtype=prompt.dtype,
                                             device=prompt.device)])
    hidden = model.apply_hidden({"params": params}, seq[None])
    return (hidden @ model.head(params))[0]


def phase_dense_decode():
    """The dense trio on the card: K2 launches of one prefill (counted
    from zero: one a layer), the prefill's logits and the gated decode
    steps' against the full forward within DD_LOGIT_TOL, the bf16
    cache's steps within DD_BF16_TOL; prefill ms and decode ms a token
    (medians of DD_REPS runs); the greedy tokens against the paged
    InferenceEngine's for the same prompt: equal, or where they first
    part and the top-2 logit margin there. Returns the K2 launches of
    one prefill."""
    import torch

    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.serving import InferenceEngine, Request
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    model = TransformerLM(TransformerConfig(
        vocab_size=VOCAB, max_len=DD_MAX_LEN, dim=DIM, num_heads=HEADS,
        num_layers=LAYERS))
    params = model.init_params(torch.Generator().manual_seed(0))
    sp = {"params": model.serving_params(params)}
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, VOCAB, (1, DD_CONTEXT), generator=g)
               .int().cuda() for _ in range(DD_REPS + 1)]
    with torch.no_grad():
        _dd_run(model, sp, prompts[0], torch.float32, 8)       # warm-up
        runs = []
        for r in range(DD_REPS):
            fa.fwd_launches = 0                  # the main path starts
            runs.append(_dd_run(model, sp, prompts[1 + r], torch.float32,
                                DD_NEW))
            if r == 0:
                launches = fa.fwd_launches       # ... and ends
        first, steps, _, _ = runs[0]
        tokens = steps.argmax(-1).tolist()
        full = _dd_full_logits(model, params, prompts[1], tokens)
        diffs = {"prefill": float((first[0] - full[DD_CONTEXT - 1]).abs()
                                  .max())}
        for i in DD_GATED:
            diffs[f"step{i}"] = float(
                (steps[i] - full[DD_CONTEXT - 1 + i]).abs().max())
        check(bool(torch.isfinite(steps).all()), "dense decode logits not "
              "finite")
        check(launches == LAYERS, f"dense decode: a prefill launched "
              f"{launches} flash forwards, not {LAYERS}")
        check(max(diffs.values()) <= DD_LOGIT_TOL,
              f"dense decode logits differ from the full forward: {diffs}")

        bf_first, bf_steps, bf_pre, bf_dec = _dd_run(
            model, sp, prompts[1], torch.bfloat16, DD_BF16_NEW)
        bf_full = _dd_full_logits(model, params, prompts[1],
                                  bf_steps.argmax(-1).tolist())
        bf_diff = max(float((bf_steps[i] - bf_full[DD_CONTEXT - 1 + i])
                            .abs().max()) for i in range(DD_BF16_NEW))
        check(bf_diff <= DD_BF16_TOL, f"dense decode, bf16 cache: logits "
              f"{bf_diff} from the full forward")

    eng = InferenceEngine(model, params, max_len=DD_MAX_LEN, **ENGINE_KNOBS)
    served = eng.run([Request(prompt=prompts[1][0].tolist(),
                              max_new_tokens=DD_NEW)])[0]
    part = next((i for i, (a, b) in enumerate(zip(tokens, served.tokens))
                 if a != b), None)
    margin = None
    if part is not None:
        top2 = steps[part].topk(2).values
        margin = float(top2[0] - top2[1])
    torch.cuda.synchronize()
    emit("dense_decode", context=DD_CONTEXT, new_tokens=DD_NEW,
         card=nvidia_smi(), prefill_launches=launches,
         prefill_ms=statistics.median(r[2] for r in runs) * 1e3,
         decode_ms_per_token=statistics.median(r[3] for r in runs) * 1e3,
         tokens_per_sec=1.0 / statistics.median(r[3] for r in runs),
         runs=[{"prefill_ms": r[2] * 1e3, "decode_ms_per_token": r[3] * 1e3}
               for r in runs],
         logits_max_abs_diff=diffs, tolerance=DD_LOGIT_TOL,
         bf16_cache={"steps": DD_BF16_NEW, "prefill_ms": bf_pre * 1e3,
                     "decode_ms_per_token": bf_dec * 1e3,
                     "logits_max_abs_diff": bf_diff,
                     "tolerance": DD_BF16_TOL},
         engine_tokens_equal=part is None and len(served.tokens) == DD_NEW,
         engine_first_difference=part, top2_margin_there=margin,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------- lint
LINT_TIMEOUT_S = 120


def phase_lint():
    """The port's static analysis (`python -m bigdl_tpu_torch.analysis`,
    pure stdlib) over the port's tree on this machine, which has no
    JAX: it must exit 0, clean against its baseline."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.analysis", "--format",
         "json", "--root", str(ROOT)], cwd=ROOT, capture_output=True,
        text=True, timeout=LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"lint: exit {proc.returncode}: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    check(not report["findings"] and not report["stale_baseline"],
          f"lint: findings {report['findings'][:5]}")
    emit("lint", seconds=seconds, counts=report["counts"])


# ------------------------------------------- the multi-process driver
# bigdl_tpu_torch/scripts/multihost_smoke.py's kill legs at one process
# on the card (the sole training process SIGKILLed once its first
# checkpoint publishes, then restarted with --resume), the two legs side
# by side, each launch under MH_LAUNCH_TIMEOUT_S
MH_LEGS = ("kill_resume", "zero2_resume")
MH_LAUNCH_TIMEOUT_S = 150


def phase_multihost():
    """The port driver's kill_resume and zero2_resume legs at one NCCL
    process on the card: each an uninterrupted 12-step run, a paced run
    SIGKILLed after checkpoint-3 publishes (zero2: its MANIFEST), and a
    restart with --resume. Gates: every leg ok, the killed process the
    sole one, the resumed sha256 equal to the uninterrupted run's,
    resumed from checkpoint-3, and zero2's first checkpoint holding one
    shard unit. The legs run concurrently, each in its own processes."""
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.scripts import multihost_smoke

    t0 = time.perf_counter()
    # each leg's work dir is removed once it passed (run_legs)
    with ThreadPoolExecutor(len(MH_LEGS)) as pool:
        futures = {leg: pool.submit(
            multihost_smoke.run_legs, [leg], "cuda", processes=1,
            timeout=MH_LAUNCH_TIMEOUT_S) for leg in MH_LEGS}
        out = {leg: f.result()[leg] for leg, f in futures.items()}
    for leg, r in out.items():
        check(r["ok"] and r["bit_identical"] and r["killed_process"] == 0
              and r["resumed_from"] == "checkpoint-3",
              f"multihost {leg}: {json.dumps(r)}")
    check(out["zero2_resume"]["shard_units_in_first_ckpt"] == 1,
          f"multihost zero2_resume: {out['zero2_resume']}")
    emit("multihost", processes=1, backend="nccl", legs=out,
         seconds=time.perf_counter() - t0, card=nvidia_smi())


# ------------------------------------------------------- the examples
# bigdl_tpu_torch/examples/: every one that runs on one card, in this
# process; the kernels each one's model reaches, by counter
EX_NAMES = ("lenet_local_train", "transfer_learning", "recommendation_ncf",
            "text_classification", "language_model", "transformer_lm",
            "treelstm_sentiment", "load_caffe_model",
            "load_tensorflow_model", "udf_predictor",
            "imagenet_records_pipeline", "serve_lm",
            "distributed_data_parallel", "moe_expert_parallel")
EX_KERNELS = {
    "language_model": ("fused_rnn.fwd_train_launches",
                       "fused_rnn.bwd_launches"),
    "transformer_lm": ("flash_attention.fwd_launches",
                       "flash_attention.bwd_launches"),
    "moe_expert_parallel": ("flash_attention.fwd_launches",
                            "flash_attention.bwd_launches"),
    "serve_lm": ("paged_decode.launches", "flash_attention.fwd_launches",
                 "flash_attention.bwd_launches"),
}
# Top1Accuracy the synthetic tasks reach (the JAX examples' and the
# port's on the CPU: 0.99-1.0)
EX_MIN_ACCURACY = 0.9


def _ex_counter(name: str, value=None):
    mod, attr = name.split(".")
    m = importlib.import_module(f"bigdl_tpu_torch.ops.{mod}")
    if value is not None:
        setattr(m, attr, value)
    return getattr(m, attr)


def _ex_cpu_stdout(name: str) -> str:
    """What the example prints when run on the CPU: the plain
    reference that a card run of the same seeded weights is held to."""
    import io

    mod = importlib.import_module(f"bigdl_tpu_torch.examples.{name}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        mod.main(["--device", "cpu"])
    return text.getvalue()


def _ex_gate(name: str, result, text: str, validations: list) -> dict:
    """The example's own result: what it printed or validated."""
    import torch

    lines = text.splitlines()

    def after(prefix):
        return [line[len(prefix):].strip() for line in lines
                if line.startswith(prefix)]

    def acc(i=-1):
        return validations[i]["Top1Accuracy"][0]

    if name == "lenet_local_train":
        check(len(validations) == 3 and acc() >= EX_MIN_ACCURACY
              and after("done; checkpoints in"), f"lenet {validations}")
        return {"top1": acc()}
    if name == "transfer_learning":
        a = float(after("transfer-learning accuracy:")[0])
        check(a >= EX_MIN_ACCURACY, f"transfer_learning accuracy {a}")
        return {"accuracy": a}
    if name == "recommendation_ncf":
        keys = ("Top1Accuracy", "HitRatio@2", "NDCG@2")
        got = {k: float(after(k)[0]) for k in keys}
        cpu_lines = _ex_cpu_stdout(name).splitlines()
        cpu = {k: float(next(line for line in cpu_lines
                             if line.startswith(k)).split()[1])
               for k in keys}
        # the plain CPU run of the same weights on the same batches: an
        # accuracy within 2 of the 256 held-out rows, NDCG within 1e-3
        # (the port's CPU test against the JAX example holds the same),
        # and above the chance of 5 uniform ratings (0.2 and 0.4)
        check(all(abs(got[k] - cpu[k]) <= tol for k, tol in
                  zip(keys, (2 / 256, 2 / 256, 1e-3)))
              and got["Top1Accuracy"] > 0.2 and got["HitRatio@2"] > 0.4,
              f"recommendation_ncf {got}, on the CPU {cpu}")
        return {**got, "cpu": cpu}
    if name in ("text_classification", "treelstm_sentiment"):
        check(len(validations) == 8 and acc() >= EX_MIN_ACCURACY,
              f"{name} {validations}")
        return {"top1": acc()}
    if name in ("language_model", "transformer_lm"):
        loss = [v["Loss"][0] for v in validations]
        check(len(loss) == 6 and all(math.isfinite(x) for x in loss)
              and loss[-1] < loss[0], f"{name} losses {loss}")
        return {"val_loss": loss}
    if name == "load_caffe_model":
        check(after("imported caffe model output:") == ["(2, 5)"],
              f"load_caffe_model: {text}")
        return {"output": "(2, 5)"}
    if name == "load_tensorflow_model":
        check(after("imported TF model output:") == ["(2, 10)"]
              and after("grad leaves:") == ["4"],
              f"load_tensorflow_model: {text}")
        return {"output": "(2, 10)", "grad_leaves": 4}
    if name == "udf_predictor":
        classes = [int(c) for c in result["predicted"]]
        cpu = [int(line.split()[-1]) for line in
               _ex_cpu_stdout(name).splitlines() if line.startswith("row ")]
        # the plain CPU run of the same seeded weights classifies alike
        check(len(after("row ")) == 6 and classes == cpu,
              f"udf_predictor: {text}, on the CPU {cpu}")
        return {"classes": classes, "cpu": cpu}
    if name == "imagenet_records_pipeline":
        check(result >= EX_MIN_ACCURACY, f"records accuracy {result}")
        return {"accuracy": result}
    if name == "serve_lm":
        check(all(r.status == "done" for r in result) and sum(
            len(r.tokens) for r in result) > 0
            and after("speculative decode:"), f"serve_lm: {text[-2000:]}")
        return {"tokens": sum(len(r.tokens) for r in result),
                "speculative": after("speculative decode:")[0]}
    if name == "distributed_data_parallel":
        flat = torch.cat([t.detach().reshape(-1).float().cpu()
                          for _, t in result.parameters()])
        check(bool(torch.isfinite(flat).all()) and after(
            "trained with ZeRO-1 DP over") == ["1 devices"],
            f"distributed_data_parallel: {text}")
        return {"params_finite": True}
    if name == "moe_expert_parallel":
        check(len(result) == 3 and all(
            math.isfinite(x) and x < math.log(256) + 0.5 for x in result),
            f"moe_expert_parallel losses {result}")
        return {"final_losses": result}
    raise AssertionError(name)


def _ex_run(name: str) -> dict:
    """One example through its `main(["--device", "cuda"])`, its output
    captured and its validations recorded; its gates (_ex_gate and the
    launches of each kernel counter of EX_KERNELS, counted from 0 over
    the run) and its seconds."""
    import io

    import torch

    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

    mod = importlib.import_module(f"bigdl_tpu_torch.examples.{name}")
    validations = []
    validate = LocalOptimizer._validate

    def recorded(self):
        out = validate(self)
        validations.append({k: r.result() for k, r in out.items()})
        return out

    LocalOptimizer._validate = recorded
    counters = EX_KERNELS.get(name, ())
    text = io.StringIO()
    try:
        torch.cuda.synchronize()
        for c in counters:                  # main path starts here
            _ex_counter(c, 0)
        start = time.perf_counter()
        with contextlib.redirect_stdout(text):
            result = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {c: _ex_counter(c) for c in counters}  # ends here
    finally:
        LocalOptimizer._validate = validate
    check(all(n > 0 for n in launches.values()),
          f"examples {name}: kernel launches {launches}")
    entry = {"seconds": seconds, "launches": launches,
             **_ex_gate(name, result, text.getvalue(), validations)}
    del result
    torch.cuda.empty_cache()
    return entry


def phase_examples():
    """Each example of bigdl_tpu_torch/examples/ that runs on one card
    (all but pipeline_parallel_lm, whose 4 stages need 4 ranks;
    distributed_data_parallel and moe_expert_parallel at world size 1)
    through _ex_run, in this process. Gates: its own result (_ex_gate:
    the accuracy, losses, outputs or tokens it prints or validates),
    and each kernel counter of EX_KERNELS launched. Reported: each
    example's seconds. The temporary directories the examples make
    (checkpoints, summaries, shards, model files) go under one that is
    removed at the end."""
    import tempfile

    t0 = time.perf_counter()
    saved = tempfile.tempdir
    with tempfile.TemporaryDirectory(prefix="chip_examples_") as tmp:
        tempfile.tempdir = tmp
        try:
            report = {name: _ex_run(name) for name in EX_NAMES}
        finally:
            tempfile.tempdir = saved
    emit("examples", examples=report,
         not_run={"pipeline_parallel_lm": "4 stages need 4 ranks (the "
                  "four-card run: torchrun --nproc_per_node 4)"},
         seconds=time.perf_counter() - t0, card=nvidia_smi())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import bigdl_tpu_torch  # noqa: F401  (fails outside the repository)

    # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    phase_build()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    kern = phase_kernel(flush)
    flash = phase_flash(flush)
    del flush
    model, params = _model()
    phase_model(model, params)
    launches, fp32_tokens = phase_engine(model, params)
    dense_launches = phase_dense_decode()
    torch.cuda.empty_cache()
    if "--profile" in sys.argv[1:]:
        phase_profile(model, params)
    engine_launches = {"engine": launches,
                       "engine_lifecycle": phase_engine_lifecycle(model,
                                                                  params)}
    phase_engine_faults(model, params)
    engine_launches.update(phase_engine_layouts(model, params, fp32_tokens))
    engine_launches.update(phase_engine_spill_handoff(model, params,
                                                      fp32_tokens))
    engine_launches["tp_serve"] = phase_tp_serve(model, params, fp32_tokens)
    engine_launches["fleet"] = phase_fleet(model, params)
    engine_launches["spec"] = phase_spec(model, params)
    engine_launches["distill"], distill_flash = phase_distill(model, params)
    torch.cuda.empty_cache()
    engine_launches["vision_fleet"] = phase_vision_fleet(model, params)
    engine_launches["sim_calibration"] = phase_sim_calibration(model, params)
    torch.cuda.empty_cache()
    scripts_ctx = phase_scripts_loadgen(model, params)
    engine_launches["scripts_loadgen"] = \
        RESULTS["scripts_loadgen"]["kernel_launches"]
    phase_scripts_report(scripts_ctx)
    del scripts_ctx
    del model, params
    torch.cuda.empty_cache()
    drill_launches = phase_scripts_drill()
    torch.cuda.empty_cache()
    phase_train_model()
    torch.cuda.empty_cache()
    fwd_launches, bwd_launches = phase_trainer()
    torch.cuda.empty_cache()
    telem_fwd, telem_bwd = phase_train_telemetry()
    if "--profile" in sys.argv[1:]:
        torch.cuda.empty_cache()
        phase_train_profile()
    torch.cuda.empty_cache()
    phase_lm_resume()
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    rnn = phase_rnn(flush)
    del flush
    torch.cuda.empty_cache()
    phase_rnn_model()
    torch.cuda.empty_cache()
    rnn_launches = phase_rnn_trainer()
    if "--profile" in sys.argv[1:]:
        torch.cuda.empty_cache()
        phase_rnn_profile()
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    gru = phase_gru(flush)
    del flush
    torch.cuda.empty_cache()
    phase_gru_model()
    torch.cuda.empty_cache()
    gru_launches = phase_gru_trainer()
    torch.cuda.empty_cache()
    phase_cnn_layers()
    torch.cuda.empty_cache()
    phase_resnet_model()
    torch.cuda.empty_cache()
    lenet_model = phase_lenet_trainer()
    torch.cuda.empty_cache()
    phase_lenet_guard()
    torch.cuda.empty_cache()
    phase_resnet_trainer()
    if "--profile" in sys.argv[1:]:
        torch.cuda.empty_cache()
        phase_resnet_profile()
    torch.cuda.empty_cache()
    phase_inception_trainer()
    if "--profile" in sys.argv[1:]:
        torch.cuda.empty_cache()
        phase_inception_profile()
    torch.cuda.empty_cache()
    phase_vgg_estimator()
    torch.cuda.empty_cache()
    phase_treelstm_trainer()
    torch.cuda.empty_cache()
    text_launches = phase_text_lm()
    torch.cuda.empty_cache()
    phase_records_trainer()
    torch.cuda.empty_cache()
    phase_lbfgs()
    phase_criterions()
    phase_eager_facade()
    torch.cuda.empty_cache()
    mha_fwd, mha_bwd = phase_mha()
    torch.cuda.empty_cache()
    phase_nn_extra()
    torch.cuda.empty_cache()
    phase_quantized(lenet_model)
    del lenet_model
    torch.cuda.empty_cache()
    phase_ncf_textcls()
    torch.cuda.empty_cache()
    phase_native_plane()
    torch.cuda.empty_cache()
    phase_distri_cli()
    torch.cuda.empty_cache()
    dist_fwd, dist_bwd = phase_distri_parity()
    torch.cuda.empty_cache()
    phase_convlstm()
    torch.cuda.empty_cache()
    moe = phase_moe_lm()
    torch.cuda.empty_cache()
    par = phase_parallel_w1(moe)
    moe_fwd, moe_bwd = moe["launches"]
    del moe
    torch.cuda.empty_cache()
    sck_fwd, sck_bwd = phase_sharded_ckpt()
    torch.cuda.empty_cache()
    keras_model, keras_launches = phase_keras()
    torch.cuda.empty_cache()
    phase_module_io(keras_model)
    del keras_model
    torch.cuda.empty_cache()
    phase_model_import()
    torch.cuda.empty_cache()
    lm2h = phase_lm2h()
    torch.cuda.empty_cache()
    lm1h = phase_lm1h()
    torch.cuda.empty_cache()
    phase_multihost()
    phase_examples()
    torch.cuda.empty_cache()
    phase_lint()
    fp32 = kern["fp32"]
    # the flash rows: the trainer's shape in its compute dtype (bf16)
    row = flash["train/bf16"]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_decode.cu",
        "design": DECODE_DESIGN,
        "replaces": "bigdl_tpu/ops/paged_decode.py:95",
        "launches": launches,
        # each serving path's own count, set to 0 just before it
        "launches_by_path": engine_launches,
        "max_abs_err": max(kern["fp32"]["max_abs_err"],
                           kern["bf16"]["max_abs_err"]),
        "ms": fp32["kernel_ms"], "plain_ms": fp32["torch_ms"],
        "bound_ms": fp32["bound_ms"], "bound_by": fp32["bound_by"],
        "library_ms": fp32["library_ms"],
    }, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "design": FLASH_DESIGN["fwd"],
        "replaces": "bigdl_tpu/ops/flash_attention.py:118",
        "launches": fwd_launches,
        # the main paths: the LM trainer, the MHA stack (mha phase),
        # the LM under DistriOptimizer (distri_parity), the MoE LM
        # (moe_lm), the parallel steps at world size 1 (parallel_w1:
        # tp, pipeline, ulysses, ep), the ZeRO-2 LM checkpointed
        # sharded (sharded_ckpt) and the dense-cache prefill of one
        # prompt (dense_decode, fp32), each counted from 0
        "launches_by_path": {"trainer": fwd_launches,
                             "dense_decode": dense_launches,
                             "train_telemetry": telem_fwd,
                             "distill": distill_flash[0], "mha": mha_fwd,
                             "distri_lm": dist_fwd, "moe_lm": moe_fwd,
                             **{f"parallel_w1_{k}": v[0]
                                for k, v in par.items()},
                             "sharded_ckpt": sck_fwd},
        "max_abs_err": row["out_max_abs_err"],
        "ms": row["fwd_ms"], "plain_ms": row["plain_fwd_ms"],
        "bound_ms": row["fwd"]["bound_ms"],
        "bound_by": row["fwd"]["bound_by"],
        "library_ms": row["sdpa_fwd_ms"],
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "design": FLASH_DESIGN["bwd"],
        "replaces": "bigdl_tpu/ops/flash_attention.py:450 :341 :374",
        "launches": bwd_launches,
        "launches_by_path": {"trainer": bwd_launches,
                             "train_telemetry": telem_bwd,
                             "distill": distill_flash[1], "mha": mha_bwd,
                             "distri_lm": dist_bwd, "moe_lm": moe_bwd,
                             **{f"parallel_w1_{k}": v[1]
                                for k, v in par.items() if v[1]},
                             "sharded_ckpt": sck_bwd},
        "max_abs_err": row["grad_max_abs_err"],
        "ms": row["bwd_ms"], "plain_ms": row["plain_bwd_ms"],
        "bound_ms": row["bwd"]["bound_ms"],
        "bound_by": row["bwd"]["bound_by"],
        "library_ms": row["sdpa_bwd_ms"],
    }]
    # the D = 256 instantiations at the LM-at-two-heads shapes: K2/K3 at
    # its trainer's (BH = 16, S = 2048, bf16), K1 at its engine's (8
    # slots, 2 heads, fp32 pool); launches from the lm2h phase's paths,
    # each counted from 0
    row, d256 = flash["train_h2/bf16"], kern["heads2/fp32"]
    kernels += [{
        "name": "paged_decode_d256", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_decode.cu",
        "design": DECODE_DESIGN,
        "replaces": "bigdl_tpu/ops/paged_decode.py:95",
        "launches": lm2h["decode"],
        "max_abs_err": max(d256["max_abs_err"],
                           kern["heads2/bf16"]["max_abs_err"]),
        "ms": d256["kernel_ms"], "plain_ms": d256["torch_ms"],
        "bound_ms": d256["bound_ms"], "bound_by": d256["bound_by"],
        "library_ms": d256["library_ms"],
    }] + [{
        # K1 at the scripts' head dims (bigdl_tpu_torch/scripts/: the
        # tiny LM's 16, its speculative draft's 8) at their shapes, fp32
        # pools; launches from the scripts_drill phase, counted from 0
        "name": f"paged_decode_d{d}", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_decode.cu",
        "design": DECODE_DESIGN,
        "replaces": "bigdl_tpu/ops/paged_decode.py:95",
        "launches": drill_launches[d],
        "max_abs_err": max(kern[f"d{d}/fp32"]["max_abs_err"],
                           kern[f"d{d}/bf16"]["max_abs_err"]),
        "ms": kern[f"d{d}/fp32"]["kernel_ms"],
        "plain_ms": kern[f"d{d}/fp32"]["torch_ms"],
        "bound_ms": kern[f"d{d}/fp32"]["bound_ms"],
        "bound_by": kern[f"d{d}/fp32"]["bound_by"],
        "library_ms": kern[f"d{d}/fp32"]["library_ms"],
    } for d in (16, 8)] + [{
        "name": f"flash_attention_{kind}_d256", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "design": FLASH_D256_DESIGN[kind],
        "replaces": {"fwd": "bigdl_tpu/ops/flash_attention.py:118",
                     "bwd": "bigdl_tpu/ops/flash_attention.py:450 :341 "
                            ":374"}[kind],
        "launches": lm2h[kind],
        "max_abs_err": row["out_max_abs_err" if kind == "fwd"
                           else "grad_max_abs_err"],
        "ms": row[f"{kind}_ms"], "plain_ms": row[f"plain_{kind}_ms"],
        "bound_ms": row[kind]["bound_ms"],
        "bound_by": row[kind]["bound_by"],
        "library_ms": row[f"sdpa_{kind}_ms"],
    } for kind in ("fwd", "bwd")]
    # above D = 256, at the LM-at-one-head shapes (D = 512): K2/K3 on
    # the column-split kernels at its trainer's (BH = 8, S = 2048,
    # bf16), K1 at its 512 tier at its engine's (8 slots, 1 head, fp32
    # pool); launches from the lm1h phase's paths, each counted from 0
    row, d512 = flash["train_h1/bf16"], kern["heads1/fp32"]
    kernels += [{
        "name": "paged_decode_d512", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_decode.cu",
        "design": DECODE_DESIGN,
        "replaces": "bigdl_tpu/ops/paged_decode.py:95",
        "launches": lm1h["decode"],
        "launches_by_path": {"lm1h": lm1h["decode"]},
        "max_abs_err": max(kern[f"{c}/{t}"]["max_abs_err"]
                           for c in ("heads1", "d20", "d48", "d80", "d320",
                                     "d1100")
                           for t in ("fp32", "bf16")),
        "ms": d512["kernel_ms"], "plain_ms": d512["torch_ms"],
        "bound_ms": d512["bound_ms"], "bound_by": d512["bound_by"],
        "library_ms": d512["library_ms"],
    }] + [{
        "name": f"flash_attention_{kind}_d512", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "design": FLASH_WIDE_DESIGN[kind],
        "replaces": {"fwd": "bigdl_tpu/ops/flash_attention.py:118",
                     "bwd": "bigdl_tpu/ops/flash_attention.py:450 :341 "
                            ":374"}[kind],
        "launches": lm1h[kind],
        "launches_by_path": {"lm1h": lm1h[kind]},
        "max_abs_err": row["out_max_abs_err" if kind == "fwd"
                           else "grad_max_abs_err"],
        "ms": row[f"{kind}_ms"], "plain_ms": row[f"plain_{kind}_ms"],
        "bound_ms": row[kind]["bound_ms"],
        "bound_by": row[kind]["bound_by"],
        "library_ms": row[f"sdpa_{kind}_ms"],
    } for kind in ("fwd", "bwd")]
    # the LSTM rows, each at the shape its main path gives it, in the
    # compute dtype (bf16): K6/K7 at the LSTM LM's (N = 32, T = 64, one
    # direction), K8/K9 at the BiLSTM trainer's (N = T = 128, two); errors
    # are the fp32 cases' largest; K6/K8 launches count the training
    # variant (the inference variant's are in the rnn_trainer phase)
    src = "bigdl_tpu_torch/ops/csrc/fused_rnn.cu"
    err_fwd = max(r["fwd_max_abs_err"] for k, r in rnn.items()
                  if k.endswith("/fp32"))
    err_bwd = max(r["grad_max_abs_err"] for k, r in rnn.items()
                  if k.endswith("/fp32"))
    for num, case, kind, counter in (
            ("K6", "lm_uni", "fwd", "fwd_train_launches"),
            ("K7", "lm_uni", "bwd", "bwd_launches"),
            ("K8", "train_bi", "fwd", "fwd_train_launches"),
            ("K9", "train_bi", "bwd", "bwd_launches")):
        r = rnn[f"{case}/bf16"]
        bound = r["train_bound" if kind == "fwd" else "bwd_bound"]
        launch = rnn_launches["uni" if case == "lm_uni" else "bi"][counter]
        # K6/K7 have two main paths: the LSTM LM on token ids
        # (rnn_trainer) and on raw text (text_lm); K8/K9 the BiLSTM
        # trainer and the keras BiLSTM and two-input models' fit; each
        # counted from 0
        by_path = {"rnn_trainer": launch,
                   "text_lm": text_launches[counter]} \
            if case == "lm_uni" else {
                "rnn_trainer": launch,
                "keras": keras_launches["bilstm"]["fit"][counter],
                "keras_functional":
                    keras_launches["functional"]["fit"][counter]}
        kernels.append({
            "name": ("bilstm_" if case == "train_bi" else "lstm_") + kind,
            "route": "cuda", "source": src,
            "design": LSTM_BWD_DESIGN if kind == "bwd" else LSTM_FWD_DESIGN,
            "replaces": {"K6": "bigdl_tpu/ops/fused_rnn.py:189 :200",
                         "K7": "bigdl_tpu/ops/fused_rnn.py:211",
                         "K8": "bigdl_tpu/ops/fused_rnn.py:375 :392",
                         "K9": "bigdl_tpu/ops/fused_rnn.py:406"}[num],
            "launches": launch,
            **({"launches_by_path": by_path} if by_path else {}),
            "max_abs_err": err_fwd if kind == "fwd" else err_bwd,
            "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": r[f"cudnn_{kind}_ms"],
            "library": "torch.nn.LSTM, bf16: " + r["library"].get(
                "bfloat16", {}).get("runs", "refused"),
        })
    # the GRU rows (K10/K11) at the BiGRU trainer's shape (N = T = H =
    # 128, one direction a launch) in bf16; K10's launches count the
    # training variant (the inference variant's are in the gru_trainer
    # phase); no library call computes BigDL's GRU (cuDNN's applies r
    # after the recurrent product), so library_ms is null
    r = gru["train/bf16"]
    for num, kind, launch in (
            ("K10", "fwd", gru_launches["gru_fwd_train_launches"]),
            ("K11", "bwd", gru_launches["gru_bwd_launches"])):
        bound = r["train_bound" if kind == "fwd" else "bwd_bound"]
        kernels.append({
            "name": "gru_" + kind, "route": "cuda", "source": src,
            "design": GRU_BWD_DESIGN if kind == "bwd" else GRU_FWD_DESIGN,
            "replaces": {"K10": "bigdl_tpu/ops/fused_rnn.py:611 :637",
                         "K11": "bigdl_tpu/ops/fused_rnn.py:643"}[num],
            "launches": launch,
            # the BiGRU trainer and the keras GRU and two-input models'
            # fit, each counted from 0
            "launches_by_path": {
                "gru_trainer": launch,
                **{f"keras_{k}": keras_launches[k]["fit"][
                    "gru_" + ("fwd_train" if kind == "fwd" else "bwd")
                    + "_launches"] for k in ("gru", "functional")}},
            "max_abs_err": max(
                g["fwd_max_abs_err" if kind == "fwd" else "grad_max_abs_err"]
                for k, g in gru.items() if k.endswith("/fp32")),
            "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None,
        })
    for k in kernels:
        check(all(isinstance(v, (str, dict))
                  or v is None and n == "library_ms"
                  or math.isfinite(v) for n, v in k.items()),
              f"{k['name']}: non-finite field")
        check(k["launches"] > 0 and all(
            n > 0 for n in k.get("launches_by_path", {}).values()),
            f"{k['name']}: no launch on a main path")
    RESULTS["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
