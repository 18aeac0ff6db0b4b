"""Continuous-batching inference engine over the paged KV cache.

Ports bigdl_tpu/serving/engine.py. The design is the same:

* **Paged KV pool + block tables.** Per-layer `(num_blocks, H,
  block_size, D)` pools (ops/kv_cache.py) plus a host `(slots,
  max_blocks)` int32 block table. A request holds one slot from prefill
  to finish; admission and eviction are block-table surgery plus
  ref-count updates (serving/kv_pool.py) between decode steps, never a
  cache copy. Block 0 is reserved scratch: inactive rows point at it.
* **Radix prefix reuse.** Admission looks the prompt up in the
  content-hashed radix tree (serving/prefix_cache.py); the longest
  cached prefix's blocks are ref-counted into the slot's table
  (copy-on-write: shared blocks are read-only) and only the SUFFIX is
  prefilled. Reuse is capped at `(len(prompt) - 1) // block_size`
  blocks, so the re-decoded last prompt token lands in an exclusive
  block: rows of a one-row (decode) gemm are not bitwise equal to the
  same rows of a many-row (prefill) gemm, so a position a decode step
  wrote is never shared. `prefix_cache=False` turns reuse off.
* **One decode step over all slots.** Per-slot clock, current token,
  sampling knobs and block-table row are (B,) operands; inactive slots
  compute garbage rows the host ignores (rows are independent).
* **Prefill buckets.** The suffix pads right to the nearest bucket
  (serving/bucketing.py); causal masking keeps real positions
  independent of the pad.
* **First token via re-decode.** Prefill only fills the cache; the slot
  enters the decode loop at clock len(prompt) - 1 with the last prompt
  token, so every generated token comes out of the same decode step.
* **Per-request determinism.** A sampled row draws from a generator
  seeded from (request seed, tokens generated so far)
  (serving/sampler.py), so a request's tokens do not depend on its slot
  or its co-batch.

The reliability layer, as in the JAX package:

* **Request lifecycle.** Every request ends in exactly one terminal
  status of `STATUSES` — done / shed / expired / poisoned / failed.
  `Request.deadline_s` is a TTL from submission enforced while queued
  and while decoding; `Request.max_queue_wait_s` bounds the time spent
  queued; `cancel()` sheds a queued or in-flight request. Times are
  read from the injectable `clock`, so expiry drills are deterministic;
  `GenerationResult.ttft_s` and `latency_s` are on that clock.
* **Admission control.** `max_queue` bounds the queue; on overload the
  `overload_policy` rejects (OverloadError), sheds the oldest queued
  request, or sheds the lowest-priority one (the newcomer itself when
  it is the lowest). Queued requests whose TTL passed expire before
  the overload check, so dead entries never cost fresh traffic.
* **Poison isolation.** The step returns a (B,) finite flag over the
  logits (utils/anomaly.rows_finite). A non-finite row evicts only its
  own request (status 'poisoned'); its freed exclusive blocks are
  scrubbed to zero and forgotten by the radix tree (a poisoned
  request's exclusive blocks are always on the device: a live slot's
  refs keep them out of the spill tier, and a re-admitted chain is a
  shared hit, which is never scrubbed).
* **Step watchdog and retries.** `step_timeout_s` runs the decode
  dispatch and its host fetch on a worker thread under a wall-clock
  budget; a trip (StepTimeout) degrades the engine: in-flight and
  queued requests fail, `submit` raises EngineDegraded, `health()`
  reports it. Arming the watchdog builds the decode kernel and runs
  one decode step on scratch rows in the constructor, so a kernel's
  first-use build (`nvcc`, tens of seconds) can never trip it. The
  worker enters `torch.no_grad()` and the engine's device and stream
  itself (all three are thread-local); an abandoned worker that wakes
  after a trip launches nothing. `step_retries` / `retry_backoff_s`
  retry a step that raised. The port writes the pools IN PLACE (the
  JAX step donates them and refuses to retry once they are consumed):
  re-running a step writes the same k/v at the same positions, because
  the host advances the clocks only after a successful fetch, so a
  retry after a Python-level error is safe. A CUDA error is sticky —
  the context cannot run anything after it — so it degrades the engine
  at once and is never retried.
* **Drain and health.** `drain()` stops admission while accepted work
  finishes (state 'draining', then 'drained'); `health()` is the
  operational snapshot with lifetime decode-step percentiles from a
  fixed-bucket histogram (obs/registry.py).
* **Layouts.** `weight_dtype="int8"` repacks the serving gemm weights
  (serving/quant.py); `cache_dtype=torch.bfloat16` halves the pool.
  Both are lossy by contract; `layout_family` names the pair.
  `swap_params` hot-swaps weights of the same structure.
* **Host spill tier.** With `spill=True`, pool pressure spills LRU
  refcount-0 prefix blocks to host numpy arrays in one batched
  device-to-host copy (bytes, never recomputation or a cast), and a
  later hit re-admits them with one host-to-device copy into fresh
  blocks plus a block-table patch — warm == cold holds bit for bit
  across the round trip. `export_tree`/`import_tree` move a radix
  tree's content between engines through the host tier.
* **Disaggregated prefill.** `role="prefill"` turns step() into admit +
  prefill + export: each filled slot leaves as a `HandoffPackage`
  (`take_handoffs()`), whose `kv` holds per-layer {'k', 'v'} numpy
  arrays (nb, H, block_size, D) — the JAX package's layout, so a
  package moves between the two packages — and `import_handoff()` on
  a decode engine seats it without a prefill. A bf16 pool's host
  arrays hold the raw bf16 bits as int16 (numpy has no bfloat16); a
  package whose arrays carry a numpy `bfloat16` dtype is read by its
  bits too.

* **Tensor parallelism.** `tp_mesh=` (with `tp_axis`, default
  "model") serves through the memoized serving/tp.py wrapper: this
  rank's pools hold H/tp heads, wq/wk/wv/w1 are split by column, and
  the tokens are bitwise the unsharded engine's. Each rank of the axis
  is a process running its own engine over identically submitted
  requests. The engine's clock is rank 0's on every rank: a step,
  submit or cancel that reads it takes one shared reading (the
  wrapper's `lockstep_clock`; `run()` one for all its submissions),
  and a decode step's end reading rides on the all-reduce that agrees
  on its watchdog or retry verdict before any rank acts on it, so
  every rank's host decisions, and so its collectives, stay in step,
  and ttft and latency are the unsharded engine's. An agreed watchdog
  trip also retires the wrapper (`TPServingLM.abandon`): a worker may
  wait in a gather no peer joins, and the next engine builds a fresh
  wrapper. (The step-latency histogram reads the clock itself: it
  measures, it decides nothing.) Host
  block arrays (spill, handoff packages, export_tree) hold every head,
  gathered over the axis, so they move between layouts. A `tp_axis`
  model without `tp_mesh`, and `weight_dtype="int8"` under `tp_mesh`,
  are refused as in the JAX engine.

On the card the decode attention is the CUDA paged-decode kernel
(`attn_impl="cuda"`, the default for a CUDA device — unlike the JAX
engine, whose default is its XLA oracle: here the kernel IS the main
path), for fp32 and bf16 pools alike. `attn_impl="torch"` runs the
plain PyTorch version instead, for comparison.
`stats["attn_kernel_launches"]` counts the kernel launches this
engine's decode steps made. One deliberate difference under `tp_mesh`:
the JAX engine refuses its Pallas kernel there (the kernel inside
shard_map was never measured on a TPU); the port has no shard_map —
each rank launches the kernel on its own H/tp heads — so a sharded
engine serves through the kernel too, with "torch" as the oracle.

Not in this slice (ROADMAP.md queue A.9): per-tenant KV quotas
(`tenant_kv_quotas`), telemetry events, spans and registry series
(`obs_label`), the router's `steal_queued` and speculative decoding's
`rollback_slot`. The constructor refuses the first two by name.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.obs.registry import LatencyHistogram
from bigdl_tpu_torch.ops import paged_decode
from bigdl_tpu_torch.parallel.collectives import all_gather
from bigdl_tpu_torch.serving.bucketing import (bucket_for, bucket_histogram,
                                               default_buckets, pad_tokens)
from bigdl_tpu_torch.serving.kv_pool import BlockPool
from bigdl_tpu_torch.serving.prefix_cache import RadixPrefixCache
from bigdl_tpu_torch.serving.quant import (params_leaves,
                                           quantize_serving_params)
from bigdl_tpu_torch.serving.sampler import row_generator, sample_logits
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.anomaly import rows_finite
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("bigdl_tpu_torch.serving")

# terminal request statuses (GenerationResult.status)
STATUSES = ("done", "shed", "expired", "poisoned", "failed")

OVERLOAD_POLICIES = ("reject", "shed-oldest", "shed-lowest-priority")

# which stats counter each terminal status bumps
_STATUS_COUNTER = {"done": "requests_done", "shed": "shed",
                   "expired": "deadline_misses", "poisoned": "poisoned",
                   "failed": "failed"}

CACHE_DTYPES = (torch.float32, torch.bfloat16)
WEIGHT_DTYPES = ("fp32", "int8")

# per-process engine index — the `metrics.engine` label of health()
_ENGINE_IDS = itertools.count()

# a decode step's outcome, worst last: the ranks of a sharded engine
# act on the largest of theirs (serving/tp.py TPServingLM.agree)
_STEP_OK, _STEP_ERROR, _STEP_STICKY, _STEP_TIMEOUT = range(4)


class OverloadError(RuntimeError):
    """submit() under overload_policy='reject' with a full queue."""


class StepTimeout(RuntimeError):
    """Decode dispatch+fetch exceeded the watchdog budget."""


class EngineDegraded(RuntimeError):
    """The engine quiesced after a watchdog trip or exhausted step
    retries; build a fresh engine."""


class EngineDraining(RuntimeError):
    """submit() on an engine in drain mode (stop-admission): accepted
    work runs to completion, new work must go elsewhere."""


def _watchdog_call(fn, timeout_s: Optional[float]):
    """Run a dispatch+fetch closure under an optional wall-clock budget
    on a daemon thread. `timeout_s=None` runs inline. Raises
    StepTimeout when the budget passes with the thread still alive (a
    device call that blocks instead of erroring); other exceptions
    propagate unchanged. PyTorch releases the GIL while it waits on the
    device, so the caller's join can time out."""
    if timeout_s is None:
        return fn()
    box: Dict[str, Any] = {}

    def boxed():
        try:
            box["r"] = fn()
        except BaseException as e:      # noqa: BLE001
            box["e"] = e

    th = threading.Thread(target=boxed, daemon=True,
                          name="bigdl-serving-step")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise StepTimeout(
            f"decode dispatch+fetch exceeded {timeout_s} s watchdog "
            "budget")
    if "e" in box:
        raise box["e"]
    return box["r"]


def _sticky_device_error(e: BaseException) -> bool:
    """True for an error the CUDA runtime reported: the context may be
    unusable after it, so the step must not be retried."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(e, torch.cuda.CudaError) \
            or (accel is not None and isinstance(e, accel)):
        return True
    msg = str(e)
    return "CUDA error" in msg or "cudaError" in msg


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy into numpy; bf16 travels as its raw bits
    (int16), since numpy has no bfloat16."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _host_bits(a: np.ndarray) -> np.ndarray:
    """A host block array as the port stores it: a numpy `bfloat16`
    array (the JAX package's) is read by its bits."""
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_device(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(_host_bits(a))).to(device)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


@dataclass
class Request:
    """One generation request. temperature <= 0 → greedy; top_k <= 0 /
    top_p >= 1 → that filter off. `stop_ids`: generation ends when one
    is sampled (the stop token is not emitted). `priority`: higher
    admits first and survives shed-lowest-priority overload, FIFO within
    a priority. `deadline_s`: TTL in clock seconds from submission,
    enforced while queued and while decoding (expiry → status
    'expired', partial tokens kept). `max_queue_wait_s`: a bound on the
    time spent queued only. `model_tag`: a label (engine groups and
    tenancy wait for the router, ROADMAP.md queue A.9)."""
    prompt: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: Sequence[int] = ()
    seed: int = 0
    id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    max_queue_wait_s: Optional[float] = None
    model_tag: Optional[str] = None


@dataclass
class HandoffPackage:
    """One prefilled request, detached from its prefill engine: the
    Request, the KV block contents its prefill wrote (per-layer
    {'k', 'v'} numpy arrays of shape (nb, H, block_size, D)), the
    original submit stamp (the importer keeps it, so TTFT and latency
    tell the whole truth across the handoff) and the source's label."""
    request: Request
    kv: Tuple[Dict[str, np.ndarray], ...]
    submit_t: float
    source: str


@dataclass
class GenerationResult:
    """`status` is the terminal lifecycle state (one of STATUSES):
    'done' (finish_reason "stop_id" | "max_tokens" | "cache_full" |
    "pool_exhausted"), 'shed' (overload victim or cancelled —
    finish_reason "shed" / "cancelled"), 'expired' (deadline or
    queue-wait TTL), 'poisoned' (non-finite logits row), 'failed'
    (engine degraded mid-request). Non-done results keep the tokens
    generated before the terminal event. `latency_s` is submit →
    terminal and `ttft_s` submit → first token, on the engine clock
    (None when unknown)."""
    id: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    status: str = "done"
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None


class InferenceEngine:
    """Continuous-batching engine over a fixed number of cache slots.

    >>> eng = InferenceEngine(model, params, slots=8)
    >>> results = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=16)])

    `variables` defaults to `model.variables`, as in the JAX engine.
    `device`: None → the GPU (raises without CUDA; pass device="cpu" for
    the plain path on the host); it must be the model's device.
    `attn_impl`: None → "cuda" on a CUDA device, "torch" on the CPU.

    Constructor arguments as in the JAX engine: `max_len` (cache length,
    default the model's positional table), `prefill_buckets`,
    `cache_dtype` (torch.float32 or torch.bfloat16), `block_size` (>= 2;
    the cache length must divide by it), `pool_blocks` (including the
    scratch block 0; default slots * cache_len // block_size + 1),
    `prefix_cache`, `spill` / `host_blocks` (the host tier; default
    capacity the device pool's), `admit_requeue_budget` (failed
    admissions before a request finishes 'pool_exhausted'),
    `max_queue` / `overload_policy`, `step_timeout_s`, `step_retries` /
    `retry_backoff_s`, `clock` (monotonic seconds for deadlines),
    `role` ("both", "prefill" or "decode"; "decode" serves like
    "both"), `weight_dtype` ("fp32" or "int8"), `model_tag`, and
    `tp_mesh`/`tp_axis` (serving/tp.py; every rank of the axis runs an
    engine over the same requests). `tenant_kv_quotas` and `obs_label`
    are refused: their features wait for ROADMAP.md queue A.9."""

    def __init__(self, model, variables: Optional[Dict[str, Any]] = None,
                 slots: int = 4,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 cache_dtype: torch.dtype = torch.float32,
                 block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 spill: bool = False,
                 host_blocks: Optional[int] = None,
                 admit_requeue_budget: int = 64,
                 max_queue: Optional[int] = None,
                 overload_policy: str = "reject",
                 step_timeout_s: Optional[float] = None,
                 step_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic,
                 obs_label: Optional[str] = None,
                 tp_mesh=None, tp_axis: str = "model",
                 role: str = "both",
                 attn_impl: Optional[str] = None,
                 weight_dtype: str = "fp32",
                 model_tag: Optional[str] = None,
                 tenant_kv_quotas: Optional[Dict[str, int]] = None,
                 device: DeviceLike = None):
        if weight_dtype != "fp32" and tp_mesh is not None:
            raise ValueError(
                "weight_dtype='int8' under tp_mesh: the sharded path "
                "pins BITWISE tp==unsharded tokens, which a lossy "
                "weight layout cannot honor — quantize unsharded "
                "engines only")
        if tp_mesh is not None:
            # memoized: engines over one (model, mesh, axis) share one
            # wrapper (serving/tp.py); a wrapper passed as `model` with
            # its own mesh passes through
            from bigdl_tpu_torch.serving.tp import tp_serving_model

            model = tp_serving_model(model, tp_mesh, tp_axis)
        elif getattr(model, "tp_axis", None) is not None:
            raise ValueError(
                f"model has tp_axis={model.tp_axis!r} armed (training "
                "tensor parallelism): serve it sharded via "
                "InferenceEngine(tp_mesh=...), which wraps it through "
                "serving/tp.py — or build a plain TransformerLM for "
                "unsharded serving")
        if tenant_kv_quotas:
            raise NotImplementedError(
                "tenant_kv_quotas: tenancy is not ported yet (ROADMAP.md "
                "queue A.9)")
        if obs_label is not None:
            raise NotImplementedError(
                "obs_label: the metrics registry and event log are not "
                "ported yet (ROADMAP.md queue A.9)")
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"the model's {model.device}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role {role!r}: expected 'both', "
                             "'prefill' or 'decode'")
        if role == "prefill" and (step_timeout_s is not None
                                  or step_retries):
            raise ValueError(
                "step_timeout_s/step_retries on a prefill-role "
                "engine: the watchdog and retry budget guard the "
                "decode dispatch, which role='prefill' never runs")
        self.role = role
        if attn_impl is None:
            attn_impl = "cuda" if self.device.type == "cuda" else "torch"
        if attn_impl not in paged_decode.IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r}: expected one of "
                             f"{paged_decode.IMPLS}")
        if attn_impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' needs a CUDA device")
        self.attn_impl = attn_impl
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype {weight_dtype!r}: "
                             "expected 'fp32' or 'int8'")
        self.weight_dtype = weight_dtype
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {cache_dtype}: expected "
                             "torch.float32 or torch.bfloat16 (the "
                             "pools the paged-decode kernel reads)")
        self.cache_dtype = cache_dtype
        self.model_tag = model_tag
        self.model = model
        # tp degree (1 = unsharded); the serving/tp.py wrapper carries
        # it and the lockstep channel, plain models neither
        self.tp = int(getattr(model, "tp", 1))
        self._tp_mesh = getattr(model, "mesh", None)
        self._tp_axis = getattr(model, "axis", None)
        self._agree = getattr(model, "agree", None)
        # a sharded engine decides on rank 0's clock readings, shared
        # over the model axis (serving/tp.py)
        self._read_shared = model.lockstep_clock(clock) \
            if self.tp > 1 else None
        if variables is None:
            variables = model.variables
        self.variables = variables
        self._params = self._build_params(variables)
        self.slots = slots
        self.cache_len = max_len if max_len is not None \
            else model.cfg.max_len
        if self.cache_len > model.cfg.max_len:
            raise ValueError(f"max_len {self.cache_len} exceeds the "
                             "model's positional table "
                             f"({model.cfg.max_len})")
        if block_size < 2:
            raise ValueError("block_size must be >= 2 (a 1-token suffix "
                             "prefill would break warm == cold)")
        if self.cache_len % block_size:
            raise ValueError(f"cache length {self.cache_len} must be a "
                             f"multiple of block_size {block_size}")
        self.block_size = block_size
        self.blocks_per_slot = self.cache_len // block_size
        if pool_blocks is None:
            pool_blocks = slots * self.blocks_per_slot + 1
        if pool_blocks < self.blocks_per_slot + 1:
            raise ValueError(
                f"pool_blocks {pool_blocks} cannot hold even one "
                f"full-length sequence ({self.blocks_per_slot} blocks "
                "+ scratch)")
        self.pool_blocks = pool_blocks
        self.prefix_cache_enabled = bool(prefix_cache)
        if spill and not prefix_cache:
            raise ValueError("spill=True without prefix_cache: the "
                             "spill tier parks radix-tree blocks — "
                             "there is nothing to spill with the tree "
                             "disabled")
        if host_blocks is not None and not spill:
            raise ValueError("host_blocks without spill=True")
        if host_blocks is not None and host_blocks < 1:
            raise ValueError("host_blocks must be >= 1 (or None for "
                             "device-pool-capacity parity)")
        self.spill_enabled = bool(spill)
        self.host_blocks = 0 if not spill else int(
            host_blocks if host_blocks is not None else pool_blocks)
        if admit_requeue_budget < 1:
            raise ValueError("admit_requeue_budget must be >= 1")
        self.admit_requeue_budget = admit_requeue_budget
        self._admit_fails: Dict[int, int] = {}
        self.pool = model.init_block_pool(pool_blocks, block_size,
                                          cache_dtype)
        self._pool_mgr = BlockPool(pool_blocks, block_size)
        self._prefix = RadixPrefixCache(self._pool_mgr,
                                        host_blocks=self.host_blocks)
        # one block's (H, block_size, D) over every head — a host block
        # array's shape, whatever this rank's share of the heads
        ref = self.pool[0]["k"]
        self._block_shape = (ref.shape[1] * self.tp,) + tuple(ref.shape[2:])
        # KV bytes one token occupies across all layers and heads
        self._kv_bytes_per_token = int(sum(
            leaf.element_size() * leaf.shape[1] * self.tp * leaf.shape[3]
            for layer in self.pool for leaf in layer.values()))
        self.buckets = tuple(sorted(
            prefill_buckets if prefill_buckets is not None
            else default_buckets(self.cache_len)))
        if max(self.buckets) > self.cache_len:
            raise ValueError(f"bucket {max(self.buckets)} exceeds cache "
                             f"length {self.cache_len}")
        if overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(f"overload_policy {overload_policy!r}: "
                             f"expected one of {OVERLOAD_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if step_retries < 0:
            raise ValueError("step_retries must be >= 0")
        self.max_queue = max_queue
        self.overload_policy = overload_policy
        self.step_timeout_s = step_timeout_s
        self.step_retries = step_retries
        self.retry_backoff_s = retry_backoff_s
        # measurements (the step-latency histogram) read the clock itself
        self._local_clock = clock
        self._now: Optional[float] = None
        self._clock = clock if self._read_shared is None \
            else self._shared_now
        self._stats: Dict[str, int] = {
            "prefill_calls": 0, "decode_steps": 0, "requests_done": 0,
            "shed": 0, "rejected": 0, "deadline_misses": 0,
            "poisoned": 0, "failed": 0, "retries": 0,
            "watchdog_trips": 0, "cancelled": 0,
            "prefix_hits": 0, "prefix_blocks_reused": 0,
            "prefix_tokens_saved": 0, "prefix_bytes_saved": 0,
            "pool_evictions": 0,
            "kv_spill_blocks": 0, "kv_readmit_blocks": 0,
            "kv_host_evictions": 0, "admit_requeue_exhausted": 0,
            "handoffs_out": 0, "handoffs_in": 0,
            "weight_swaps": 0, "attn_kernel_launches": 0,
        }
        self._name = f"engine{next(_ENGINE_IDS)}"
        # lifetime decode dispatch+fetch seconds (health() percentiles)
        self._lat = LatencyHistogram()
        # the stream every decode step runs on, also from the watchdog's
        # worker thread (the current stream is thread-local)
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.completed: Dict[int, GenerationResult] = {}
        self._queue: deque = deque()
        self._ids = itertools.count()
        self._req: List[Optional[Request]] = [None] * slots
        self._gen: List[List[int]] = [[] for _ in range(slots)]
        # block table: a row per slot, entry 0 = unassigned (scratch)
        self._table = np.zeros((slots, self.blocks_per_slot), np.int32)
        # per-slot [shared prefix-hit blocks, exclusively owned blocks]
        self._slot_blocks: List[List[List[int]]] = [
            [[], []] for _ in range(slots)]
        self._pos = np.zeros(slots, np.int32)
        self._tok = np.zeros(slots, np.int32)
        self._nout = np.zeros(slots, np.int32)   # sampling-stream clock
        self._seed = np.zeros(slots, np.int64)
        self._temp = np.zeros(slots, np.float32)
        self._topk = np.zeros(slots, np.int32)
        self._topp = np.ones(slots, np.float32)
        self._meta: Dict[int, Dict[str, float]] = {}  # id → submit time
        self._degraded: Optional[str] = None
        self._draining = False
        # prefill-role export queue, drained by take_handoffs()
        self._handoffs: List[HandoffPackage] = []
        if step_timeout_s is not None:
            # arming the watchdog builds and warms the decode path now:
            # the kernel's first use runs nvcc (tens of seconds), which
            # would trip any steady-state budget on the first step.
            # Every row is inactive (table row 0 = scratch); every slot
            # is prefilled before it decodes.
            self._dispatch_and_fetch(np.zeros(slots, bool), 0.0,
                                     watchdog=False)

    # ------------------------------------------------------------ params
    def _build_params(self, variables):
        """The serving weight layout for `variables`: per-layer views
        (`model.serving_params`), then the int8 repack when quantized.
        The constructor and `swap_params` run the same build."""
        params = self.model.serving_params(variables)
        if self.weight_dtype == "int8":
            params = quantize_serving_params(params)
        return params

    def swap_params(self, variables) -> None:
        """Hot-swap model weights: rebuild the serving layout from
        `variables` and re-point the decode and prefill steps at it. The
        new tree must have the same structure and leaf shapes; in-flight
        slots keep their KV bytes and decode their next token under the
        new weights."""
        params = self._build_params(variables)
        if _structure(params) != _structure(self._params):
            raise ValueError(
                "swap_params: new variables produce a different "
                "serving-layout structure — hot-swap is re-placement "
                "over the SAME layout, never a re-architecture")
        if [t.shape for t in params_leaves(params)] \
                != [t.shape for t in params_leaves(self._params)]:
            raise ValueError(
                "swap_params: leaf shapes changed — a different model "
                "config cannot hot-swap into a live engine")
        self.variables = variables
        self._params = params
        self._stats["weight_swaps"] += 1

    # -------------------------------------------------------------- views
    @property
    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    @property
    def degraded(self) -> Optional[str]:
        """None while healthy, else the degradation reason."""
        return self._degraded

    @property
    def draining(self) -> bool:
        """True once drain() was called (stop-admission mode)."""
        return self._draining

    @property
    def idle(self) -> bool:
        """No queued and no in-flight requests."""
        return not self._queue and all(r is None for r in self._req)

    @property
    def slots_active(self) -> int:
        """Occupied cache slots."""
        return sum(r is not None for r in self._req)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def layout_family(self) -> str:
        """'{weight_dtype}/{cache dtype}' — the numerics contract a
        request's tokens were produced under: fp32 engines pin bitwise
        token identity, a lossy layout's tokens compare only with the
        same layout's."""
        return f"{self.weight_dtype}/{_dtype_name(self.cache_dtype)}"

    def drain(self) -> None:
        """Enter stop-admission mode: subsequent submit() raises
        EngineDraining; already-accepted requests (queued and in-flight)
        keep stepping to their normal terminal status. health()['state']
        reports 'draining' until the engine empties, then 'drained'.
        Idempotent; there is no undrain."""
        self._draining = True

    def health(self) -> Dict[str, object]:
        """Operational snapshot: engine state, slot occupancy, queue
        depth and per-bucket composition, p50/p95 decode-step latency
        (from the lifetime fixed-bucket histogram; None before the first
        decode step) and every reliability counter. The key set is the
        JAX engine's; `tp` is the tensor-parallel degree."""
        def pct(q):
            v = self._lat.quantile(q)
            return None if v is None else round(v * 1e3, 3)

        if self._degraded:
            state = "degraded"
        elif self._draining:
            state = "drained" if self.idle else "draining"
        else:
            state = "ok"
        s = self._stats
        return {
            "state": state,
            "degraded_reason": self._degraded,
            "tp": self.tp,
            "role": self.role,
            "attn_impl": self.attn_impl,
            "weight_dtype": self.weight_dtype,
            "cache_dtype": _dtype_name(self.cache_dtype),
            "model_tag": self.model_tag,
            "handoffs_out": s["handoffs_out"],
            "handoffs_in": s["handoffs_in"],
            "slots": self.slots,
            "slots_active": self.slots_active,
            "queue_depth": self.queue_depth,
            "queue_buckets": bucket_histogram(
                [len(r.prompt) for r in self._queue], self.buckets),
            "decode_p50_ms": pct(0.50),
            "decode_p95_ms": pct(0.95),
            "deadline_misses": s["deadline_misses"], "shed": s["shed"],
            "rejected": s["rejected"], "poisoned": s["poisoned"],
            "retries": s["retries"],
            "watchdog_trips": s["watchdog_trips"],
            "failed": s["failed"], "cancelled": s["cancelled"],
            "requests_done": s["requests_done"],
            "decode_steps": s["decode_steps"],
            "prefix": {
                "enabled": self.prefix_cache_enabled,
                "hits": s["prefix_hits"],
                "blocks_reused": s["prefix_blocks_reused"],
                "tokens_saved": s["prefix_tokens_saved"],
                "bytes_saved": s["prefix_bytes_saved"],
                "evictions": s["pool_evictions"],
                "tree_blocks": self._prefix.num_blocks,
                "pool": self._pool_mgr.stats(),
                "spill": self.spill_enabled,
                "host_blocks": self.host_blocks,
                "host_in_use": self._prefix.host_in_use,
                "spilled": s["kv_spill_blocks"],
                "readmitted": s["kv_readmit_blocks"],
                "host_evictions": s["kv_host_evictions"],
            },
            "metrics": {
                "engine": self._name,
                "decode_step_seconds": {
                    "count": self._lat.count,
                    "sum": round(self._lat.sum, 6),
                    "p50_ms": pct(0.50), "p95_ms": pct(0.95),
                    "p99_ms": pct(0.99)},
                "requests_total": {
                    st: s[_STATUS_COUNTER[st]] for st in STATUSES},
            },
        }

    # --------------------------------------------------------------- host
    def _tick(self) -> None:
        """Start a step, submit or cancel: a sharded engine's next clock
        read takes a fresh shared reading. An unsharded engine reads its
        clock wherever it needs it."""
        self._now = None

    def _shared_now(self) -> float:
        """A sharded engine's clock: rank 0's reading, broadcast over the
        model axis at the first read since `_tick` (every rank's host
        decisions reach it at the same point), so that every rank's
        deadlines, TTLs, shedding, ttft and latency come out alike. The
        decode step's end reading comes with its agreed verdict."""
        if self._now is None:
            self._now = self._read_shared()
        return self._now

    def _in_flight(self) -> set:
        return {r.id for r in self._queue} \
            | {r.id for r in self._req if r is not None} \
            | set(self.completed)

    def submit(self, request: Request) -> int:
        self._tick()
        return self._submit(request)

    def _submit(self, request: Request) -> int:
        """`submit` on the current clock reading (`run` submits a batch
        on one)."""
        n = len(request.prompt)
        if self._degraded:
            raise EngineDegraded(
                f"engine degraded ({self._degraded}); build a fresh "
                "engine")
        if self._draining:
            raise EngineDraining(
                "engine is draining (stop-admission): route new "
                "requests to another engine")
        if n == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the engine "
                             "always samples at least one token)")
        bucket_for(n, self.buckets)      # raises if no bucket fits
        in_flight = self._in_flight()
        if request.id is None:
            rid = next(self._ids)
            while rid in in_flight:
                rid = next(self._ids)
            request.id = rid
        elif request.id in in_flight:
            raise ValueError(f"request id {request.id} already in flight "
                             "or completed-unclaimed")
        # expire stale queued requests BEFORE the overload check: dead
        # TTLs must not reject (or shed a victim from) fresh traffic
        self._expire_queued(self._clock())
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            self._overload(request)
            if request.id in self.completed:     # new request was shed
                return request.id
        self._meta[request.id] = {"t": self._clock()}
        self._queue.append(request)
        return request.id

    def _overload(self, request: Request) -> None:
        """Queue at max_queue: raise (reject), shed a queued victim, or
        shed `request` itself (shed-lowest-priority when it IS the
        lowest — its result lands in `completed`)."""
        if self.overload_policy == "reject":
            self._stats["rejected"] += 1
            raise OverloadError(
                f"queue full ({self.max_queue}); request {request.id} "
                "rejected (overload_policy='reject')")
        if self.overload_policy == "shed-lowest-priority":
            victim = min(self._queue, key=lambda r: r.priority)
            if request.priority <= victim.priority:
                self._terminal(request, "shed", "shed")
                return
            self._queue.remove(victim)
        else:                                     # shed-oldest
            victim = self._queue.popleft()
        self._terminal(victim, "shed", "shed")

    def cancel(self, request_id: int) -> GenerationResult:
        """Cancel a queued or in-flight request (between steps). The
        result (status 'shed', finish_reason 'cancelled', partial tokens
        if it was decoding) lands in `completed` and is returned.
        KeyError if the id is not queued or in flight."""
        self._tick()
        for r in self._queue:
            if r.id == request_id:
                self._queue.remove(r)
                self._stats["cancelled"] += 1
                return self._terminal(r, "cancelled", "shed")
        for i, r in enumerate(self._req):
            if r is not None and r.id == request_id:
                self._stats["cancelled"] += 1
                res = self._finish(i, "cancelled", "shed")
                self.completed[res.id] = res
                return res
        raise KeyError(f"request {request_id} is not queued or in flight")

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._req) if r is None]

    def _deadline_at(self, req: Request) -> float:
        if req.deadline_s is None or req.id not in self._meta:
            return math.inf
        return self._meta[req.id]["t"] + req.deadline_s

    def _lifecycle_times(self, req: Request
                         ) -> Tuple[Optional[float], Optional[float]]:
        """(ttft_s, latency_s) for a request reaching terminal NOW, from
        the engine clock — read BEFORE _meta is popped."""
        meta = self._meta.get(req.id)
        if meta is None or "t" not in meta:
            return None, None
        latency = self._clock() - meta["t"]
        tf = meta.get("t_first")
        return (None if tf is None else tf - meta["t"]), latency

    def _terminal(self, req: Request, reason: str, status: str
                  ) -> GenerationResult:
        """Terminal event for a request not (or no longer) in a slot —
        the result goes straight to `completed`."""
        ttft, latency = self._lifecycle_times(req)
        self._meta.pop(req.id, None)
        self._admit_fails.pop(req.id, None)
        self._stats[_STATUS_COUNTER[status]] += 1
        res = GenerationResult(req.id, list(req.prompt), [], reason,
                               status, ttft_s=ttft, latency_s=latency)
        self.completed[req.id] = res
        return res

    def _expire_queued(self, now: float) -> None:
        """Drop queued requests whose deadline or max-queue-wait TTL
        passed — status 'expired', zero tokens."""
        keep: deque = deque()
        for r in self._queue:
            t0 = self._meta[r.id]["t"]
            dl = self._deadline_at(r)
            qw = t0 + r.max_queue_wait_s \
                if r.max_queue_wait_s is not None else math.inf
            if now >= min(dl, qw):
                self._terminal(r, "expired", "expired")
            else:
                keep.append(r)
        self._queue = keep

    def _pop_next(self) -> Request:
        """Highest priority first; FIFO within a priority."""
        best_i, best_p = 0, None
        for i, r in enumerate(self._queue):
            if best_p is None or r.priority > best_p:
                best_i, best_p = i, r.priority
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    # ------------------------------------------------------------ blocks
    def _alloc_blocks(self, n: int, protect: frozenset = frozenset()
                      ) -> Optional[List[int]]:
        """Take `n` fresh blocks. Under pool pressure refcount-0 prefix
        blocks SPILL to the host tier (bytes kept, re-admitted on a
        later hit), falling back to plain LRU eviction when the tier is
        off or full; None when nothing can free enough. `protect`
        excludes the chain an in-flight re-admission holds."""
        while self._pool_mgr.free_count < n:
            if self._spill_blocks(n - self._pool_mgr.free_count,
                                  protect):
                continue
            if self._prefix.evict_one() is None:
                break
            self._stats["pool_evictions"] += 1
        return self._pool_mgr.alloc(n)

    def _gather_blocks(self, blocks: Sequence[int]) -> np.ndarray:
        """The pools' content of `blocks` as one host array (2L, n, H,
        bs, D) — keys then values of each layer — in ONE device-to-host
        copy, whatever the number of layers and blocks. A sharded
        engine gathers every rank's heads first (one all-gather)."""
        idx = torch.tensor(list(blocks), dtype=torch.long,
                           device=self.device)
        data = torch.stack([leaf[idx] for layer in self.pool
                            for leaf in (layer["k"], layer["v"])])
        if self.tp > 1:
            with self.model.bound():
                data = all_gather(data, self._tp_axis, dim=2)
        return _to_host(data)

    def _scatter_blocks(self, blocks: Sequence[int],
                        host: np.ndarray) -> None:
        """Write one host array (2L, n, H, bs, D) into the pools' rows
        `blocks` — one host-to-device copy, then a scatter per leaf. A
        sharded engine takes its own heads' slice."""
        idx = torch.tensor(list(blocks), dtype=torch.long,
                           device=self.device)
        if self.tp > 1:
            h = self._block_shape[0] // self.tp
            c = self._tp_mesh.coord(self._tp_axis)
            host = host[:, :, c * h:(c + 1) * h]
        data = _to_device(host, self.cache_dtype, self.device)
        for li, layer in enumerate(self.pool):
            layer["k"][idx] = data[2 * li]
            layer["v"][idx] = data[2 * li + 1]

    @staticmethod
    def _layer_views(data: np.ndarray, j) -> Tuple[Dict[str, np.ndarray],
                                                    ...]:
        """Per-layer {'k', 'v'} views of block(s) `j` of a gathered
        (2L, n, ...) host array — the HandoffPackage layout."""
        return tuple({"k": data[2 * li][j], "v": data[2 * li + 1][j]}
                     for li in range(data.shape[0] // 2))

    @staticmethod
    def _stack_host(kvs: Sequence[Tuple[Dict[str, np.ndarray], ...]],
                    layers: int) -> np.ndarray:
        """(2L, n, ...) from n per-block per-layer {'k','v'} tuples."""
        return np.stack([np.stack([_host_bits(kv[li][k]) for kv in kvs])
                         for li in range(layers) for k in ("k", "v")])

    def _spill_blocks(self, want: int,
                      protect: frozenset = frozenset()) -> int:
        """Spill up to `want` LRU refcount-0 prefix blocks to the host
        tier: one batched device-to-host copy for the whole victim set,
        then bookkeeping — each victim's bytes park on its tree node and
        its device block returns to the free list. A full host tier
        first evicts its LRU childless nodes. Returns the number
        spilled."""
        if not self.spill_enabled or want <= 0:
            return 0
        victims = self._prefix.spill_victims(want, protect)
        host_evicted = 0
        room = self.host_blocks - self._prefix.host_in_use
        while victims and room < len(victims):
            if not self._prefix.evict_host_one(protect):
                break
            host_evicted += 1
            room += 1
        victims = victims[:max(room, 0)]
        self._stats["kv_host_evictions"] += host_evicted
        if not victims:
            return 0
        data = self._gather_blocks([v.block for v in victims])
        for j, v in enumerate(victims):
            self._prefix.park(v, self._layer_views(data, j))
        self._stats["kv_spill_blocks"] += len(victims)
        return len(victims)

    def _readmit_chain(self, nodes) -> Optional[List[int]]:
        """Commit a matched prefix chain: ref the device-resident blocks
        (pinning them against spill and eviction), re-admit the
        host-tier nodes — fresh device blocks plus ONE host-to-device
        copy and a block-table patch — and return the chain's device
        block ids in order, each holding one ref for this request. None
        when the pool cannot cover the re-admission; the chain unwinds
        to cached parking and the caller requeues."""
        dev = [n.block for n in nodes if n.block is not None]
        self._pool_mgr.ref(dev)
        host_nodes = [n for n in nodes if n.block is None]
        if host_nodes:
            new = self._alloc_blocks(len(host_nodes),
                                     protect=frozenset(nodes))
            if new is None:
                self._pool_mgr.unref(dev)
                return None
            datas = [self._prefix.readmit(nd, b)
                     for nd, b in zip(host_nodes, new)]
            self._scatter_blocks(new, self._stack_host(datas,
                                                       len(self.pool)))
            for b in new:
                self._pool_mgr.mark_cached(b)
            self._stats["kv_readmit_blocks"] += len(new)
        return [n.block for n in nodes]

    # --------------------------------------------------------- admission
    def _admit(self) -> None:
        if not self._queue:
            return
        self._expire_queued(self._clock())
        for slot in self._free_slots():
            while self._queue:
                req = self._pop_next()
                if self._admit_into(slot, req):
                    self._admit_fails.pop(req.id, None)
                    break
                # pool pressure: requeue at the FRONT, a bounded number
                # of times — a pool that never frees must not spin the
                # request through the queue forever
                fails = self._admit_fails.pop(req.id, 0) + 1
                if fails > self.admit_requeue_budget:
                    self._stats["admit_requeue_exhausted"] += 1
                    self._terminal(req, "pool_exhausted", "done")
                    continue
                self._admit_fails[req.id] = fails
                self._queue.appendleft(req)
                return
            if not self._queue:
                return

    def _point_table_row(self, slot: int, hit: List[int],
                         new: List[int]) -> np.ndarray:
        """Zero one slot's block-table row and point it at the shared
        `hit` chain followed by the exclusive `new` blocks."""
        row = self._table[slot]
        row[:] = 0
        row[:len(hit)] = hit
        row[len(hit):len(hit) + len(new)] = new
        return row

    def _seat_slot(self, slot: int, req: Request, hit: List[int],
                   new: List[int]) -> None:
        """Seat-slot tail shared by `_admit_into` and `import_handoff`:
        register the prompt's pre-COW-cap blocks in the radix tree
        (their content is written: later readers run after it on the
        same stream), then point every per-slot host array at the
        request so the next decode step picks it up at clock
        len(prompt) - 1."""
        prompt = list(req.prompt)
        n = len(prompt)
        if self.prefix_cache_enabled:
            cap_blocks = (n - 1) // self.block_size
            if cap_blocks:
                owned = self._prefix.insert(
                    prompt,
                    [int(x) for x in self._table[slot, :cap_blocks]])
                for bid in owned:
                    self._pool_mgr.mark_cached(bid)
        self._req[slot] = req
        self._gen[slot] = []
        self._slot_blocks[slot] = [list(hit), list(new)]
        self._pos[slot] = n - 1          # re-decode the last prompt token
        self._tok[slot] = prompt[-1]
        self._nout[slot] = 0
        self._seed[slot] = req.seed
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p

    def _admit_into(self, slot: int, req: Request) -> bool:
        """Prefix lookup + block allocation + suffix prefill into
        `slot`. False = not enough pool blocks (the caller requeues)."""
        prompt = list(req.prompt)
        n = len(prompt)
        bs = self.block_size
        nodes: List[object] = []
        start = 0
        if self.prefix_cache_enabled:
            # reuse at most the full blocks strictly before the
            # re-decoded last prompt token (copy-on-write cap); the
            # chain may hold host-tier nodes, re-admitted below
            nodes = self._prefix.lookup_nodes(prompt, (n - 1) // bs)
            start = len(nodes) * bs
            # the suffix bucket must fit the table
            while nodes and start + bucket_for(n - start, self.buckets) \
                    > self.cache_len:
                nodes.pop()
                start -= bs
        suffix = prompt[start:]
        b = bucket_for(len(suffix), self.buckets)
        # pin the hit chain BEFORE allocating, so the allocator's spill
        # and eviction cannot reclaim the blocks this admission matched
        hit = self._readmit_chain(nodes)
        if hit is None:
            return False
        new = self._alloc_blocks(-(-b // bs))
        if new is None:
            self._pool_mgr.unref(hit)        # back to cached parking
            return False
        row = self._point_table_row(slot, hit, new)
        dev = self.device
        with torch.no_grad():
            self.model.prefill_paged(
                self._params,
                torch.from_numpy(pad_tokens(suffix, b)[None, :]).to(dev),
                self.pool, torch.from_numpy(row[None, :].copy()).to(dev),
                torch.tensor(new, dtype=torch.int32, device=dev), start)
        self._stats["prefill_calls"] += 1
        if start:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_blocks_reused"] += len(hit)
            self._stats["prefix_tokens_saved"] += start
            self._stats["prefix_bytes_saved"] += \
                start * self._kv_bytes_per_token
        self._seat_slot(slot, req, hit, new)
        return True

    # ----------------------------------------------------------- release
    def _finish(self, slot: int, reason: str,
                status: str = "done") -> GenerationResult:
        req = self._req[slot]
        ttft, latency = self._lifecycle_times(req)
        res = GenerationResult(req.id, list(req.prompt), self._gen[slot],
                               reason, status, ttft_s=ttft,
                               latency_s=latency)
        self._meta.pop(req.id, None)
        self._clear_slot(slot, poisoned=(status == "poisoned"))
        self._stats[_STATUS_COUNTER[status]] += 1
        return res

    def _clear_slot(self, slot: int, poisoned: bool = False) -> None:
        self._req[slot] = None
        self._gen[slot] = []
        self._temp[slot] = 0.0
        self._release_slot(slot, poisoned=poisoned)

    def _release_slot(self, slot: int, poisoned: bool = False) -> None:
        """Return a finished slot's blocks: shared prefix refs drop
        (refcount-0 tree blocks park as cached), exclusive blocks free.
        A POISONED request's freed exclusive blocks are forgotten by the
        tree (deepest first — only leaves can go) and scrubbed to zero;
        a shared block is never touched, its co-users hold content
        bit-identical to a healthy cold run."""
        hit, own = self._slot_blocks[slot]
        pool = self._pool_mgr
        freed = pool.unref(hit)
        for b in reversed(own):
            if poisoned and pool.in_tree(b) and pool.refcount(b) == 1:
                self._prefix.forget_block(b)
            freed += pool.unref([b])
        if poisoned and freed:
            idx = torch.tensor(freed, dtype=torch.long, device=self.device)
            for layer in self.pool:
                for leaf in layer.values():
                    leaf[idx] = 0
        self._slot_blocks[slot] = [[], []]
        self._table[slot, :] = 0

    def _emit(self, slot: int, tok: int, finite: bool, now: float
              ) -> Optional[GenerationResult]:
        """Apply one sampled token to `slot`: advance the sampling
        clock, evict on a non-finite row, finish on a stop id (not
        emitted), append (stamping TTFT on the first), then max_tokens /
        deadline / cache_full checks, else advance the row clock."""
        req = self._req[slot]
        self._nout[slot] += 1
        if not finite:
            return self._finish(slot, "poisoned", "poisoned")
        if tok in req.stop_ids:
            return self._finish(slot, "stop_id")
        self._gen[slot].append(tok)
        if len(self._gen[slot]) == 1 and req.id in self._meta:
            self._meta[req.id]["t_first"] = now
        if len(self._gen[slot]) >= req.max_new_tokens:
            return self._finish(slot, "max_tokens")
        if now >= self._deadline_at(req):
            return self._finish(slot, "expired", "expired")
        if self._pos[slot] + 1 >= self.cache_len:
            return self._finish(slot, "cache_full")
        self._pos[slot] += 1
        self._tok[slot] = tok
        return None

    def _ensure_blocks(self) -> List[GenerationResult]:
        """A row whose next write position crossed into an uncovered
        block gets a fresh exclusive one; if the pool cannot supply it
        the request finishes 'pool_exhausted' (impossible at the
        default pool size)."""
        done: List[GenerationResult] = []
        for i, req in enumerate(self._req):
            if req is None:
                continue
            bi = int(self._pos[i]) // self.block_size
            if self._table[i, bi] != 0:
                continue
            new = self._alloc_blocks(1)
            if new is None:
                done.append(self._finish(i, "pool_exhausted"))
                continue
            self._table[i, bi] = new[0]
            self._slot_blocks[i][1].append(new[0])
        return done

    # ------------------------------------------------------ degradation
    def quiesce(self, reason: str, watchdog: bool = False) -> None:
        """Degrade WITHOUT touching any request lifecycle: refuse
        further work and report 'degraded' while seated rows stay
        where they are. Idempotent."""
        if self._degraded:
            return
        if watchdog:
            self._stats["watchdog_trips"] += 1
        self._degraded = reason
        logger.error("serving engine quiesced: %s", reason)

    def _degrade(self, reason: str) -> List[GenerationResult]:
        """Fail every in-flight and queued request and refuse new
        submissions. Returns the failed in-flight results; queued
        failures go straight to `completed`."""
        self._degraded = reason
        logger.error("serving engine degraded: %s", reason)
        out = [self._finish(i, "failed", "failed")
               for i, r in enumerate(self._req) if r is not None]
        for r in list(self._queue):
            out.append(self._terminal(r, "failed", "failed"))
        self._queue.clear()
        return out

    # ------------------------------------------------------------ decode
    def _device_ctx(self):
        """The engine's device and stream, entered explicitly: both are
        thread-local, and the watchdog runs the step on its own thread."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _decode(self, poison: np.ndarray):
        """One decode step over all slots; returns host (tokens,
        finite) arrays — the step's one device-to-host fetch, which
        fences the step. `poison` (B,) forces those rows' logits to NaN
        (the serve_nan fault)."""
        dev = self.device
        logits, _ = self.model.decode_step_paged(
            self._params, torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._pos).to(dev), self.pool,
            torch.from_numpy(self._table).to(dev),
            attn_impl=self.attn_impl)
        if poison.any():
            logits = torch.where(
                torch.from_numpy(poison).to(dev)[:, None],
                torch.tensor(float("nan"), device=dev), logits)
        finite = rows_finite(logits)
        gens = [row_generator(int(self._seed[i]), int(self._nout[i]), dev)
                if r is not None and self._temp[i] > 0 else None
                for i, r in enumerate(self._req)]
        nxt = sample_logits(
            logits, gens, torch.from_numpy(self._temp).to(dev),
            torch.from_numpy(self._topk).to(dev),
            torch.from_numpy(self._topp).to(dev))
        return nxt.cpu().numpy(), finite.cpu().numpy()

    def _dispatch_and_fetch(self, poison: np.ndarray, slow_s: float,
                            watchdog: bool = True
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """One decode dispatch + device-to-host fetch, optionally under
        the watchdog budget. The fetch runs INSIDE the budget: the
        failure mode is a device call that blocks, not one that errors."""
        def work():
            if slow_s:
                time.sleep(slow_s)    # injected straggler/hang model
            if self._degraded is not None:
                # the watchdog already tripped while this (abandoned)
                # thread was stuck before the dispatch: launch nothing
                # nobody will consume — a late launch can still be
                # running at interpreter exit and abort the process
                return None
            with torch.no_grad(), self._device_ctx():
                return self._decode(poison)

        return _watchdog_call(work, self.step_timeout_s if watchdog
                              else None)

    def step(self) -> List[GenerationResult]:
        """Admit queued requests into free slots, run ONE decode step
        over all slots, evict finished, poisoned or expired sequences.
        Returns the requests that reached a terminal state in this step.
        A watchdog trip or an exhausted retry budget degrades the engine
        and returns every in-flight request as 'failed'."""
        if self._degraded:
            return []
        self._tick()
        if self.role == "prefill":
            return self._step_prefill()
        self._admit()
        done = self._ensure_blocks()
        if all(r is None for r in self._req):
            return done
        plan = faults.get_plan()
        stepno = self._stats["decode_steps"]
        poison = np.zeros(self.slots, bool)
        if plan.fires("serve_nan", stepno):
            active = [i for i, r in enumerate(self._req) if r is not None]
            poison[active[0]] = True    # lowest active slot: determinate
        launches0 = paged_decode.launches
        try:
            for attempt in range(self.step_retries + 1):
                # the step's verdict, agreed across a sharded engine's
                # ranks before anyone acts on it (the worst one wins)
                err: Optional[BaseException] = None
                verdict = _STEP_OK
                try:
                    plan.maybe_raise("serve_err", stepno)
                    slow_s = 0.0
                    if plan.fires("serve_slow", stepno):
                        slow_s = (self.step_timeout_s or 0.05) * 5
                    tc0 = self._local_clock()
                    nxt, finite = self._dispatch_and_fetch(poison, slow_s)
                except StepTimeout as e:
                    err, verdict = e, _STEP_TIMEOUT
                except Exception as e:          # noqa: BLE001
                    err = e
                    verdict = _STEP_STICKY if _sticky_device_error(e) \
                        else _STEP_ERROR
                t1 = self._local_clock()
                agreed = verdict
                if self._agree is not None:
                    # rank 0's end-of-step reading rides on the verdict
                    agreed, self._now = self._agree(verdict, t1)
                if agreed == _STEP_OK:
                    self._lat.observe(t1 - tc0)
                    break
                if agreed != verdict:
                    err = RuntimeError("a peer rank's step failed")
                if agreed == _STEP_TIMEOUT:
                    self._stats["watchdog_trips"] += 1
                    if self.tp > 1:
                        # a worker may wait in a gather no peer joins
                        self.model.abandon(f"watchdog trip at decode "
                                           f"step {stepno}")
                    return done + self._degrade(
                        f"watchdog trip at decode step {stepno}: {err}")
                if agreed == _STEP_STICKY:
                    return done + self._degrade(
                        f"decode step {stepno} failed with a CUDA "
                        f"error (sticky, not retryable): {err}")
                if attempt >= self.step_retries:
                    return done + self._degrade(
                        f"decode step {stepno} failed after "
                        f"{attempt + 1} attempt(s): {err}")
                self._stats["retries"] += 1
                logger.warning("decode step %d attempt %d failed "
                               "(%s); retrying", stepno, attempt + 1, err)
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        finally:
            self._stats["attn_kernel_launches"] += \
                paged_decode.launches - launches0
        self._stats["decode_steps"] += 1
        now = self._clock()
        for i, req in enumerate(self._req):
            if req is not None:
                res = self._emit(i, int(nxt[i]), bool(finite[i]), now)
                if res is not None:
                    done.append(res)
        return done

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[GenerationResult]:
        """Submit `requests` (if given), then step until queue and slots
        drain. Returns `requests`' results in submission order (or, with
        no argument, everything that finished, in id order). Results of
        other requests that finished meanwhile stay in `completed`.
        Shed, expired, poisoned and failed requests return with their
        status; a 'reject' overload raises OverloadError out of the
        submission phase."""
        if self.role == "prefill":
            raise ValueError(
                "run() on a prefill-role engine: it exports "
                "HandoffPackages instead of decoding — step() it and "
                "hand take_handoffs() to a decode engine's "
                "import_handoff()")
        self._tick()
        ids = [self._submit(r) for r in requests] if requests else None
        while not self.idle:
            for res in self.step():
                self.completed[res.id] = res
        if ids is None:
            out = sorted(self.completed.values(), key=lambda r: r.id)
            self.completed = {}
            return out
        return [self.completed.pop(i) for i in ids]

    # -------------------------------------------- disaggregated prefill
    def _step_prefill(self) -> List[GenerationResult]:
        """Prefill-tier round (role='prefill'): admit + prefill like a
        serving engine — same buckets, same prefix reuse — then export
        every filled slot as a HandoffPackage instead of decoding."""
        self._admit()
        for i, req in enumerate(self._req):
            if req is not None:
                self._export_handoff(i)
        return []

    def _export_handoff(self, slot: int) -> HandoffPackage:
        """Package one prefilled slot: fetch the prompt's KV blocks to
        the host in ONE device-to-host copy, then free the slot (its
        blocks park in this engine's radix tree)."""
        req = self._req[slot]
        n = len(req.prompt)
        nb = -(-n // self.block_size)           # blocks covering [0, n)
        data = self._gather_blocks(
            [int(b) for b in self._table[slot, :nb]])
        meta = self._meta.pop(req.id, None)
        pkg = HandoffPackage(req, self._layer_views(data, slice(None)),
                             meta["t"] if meta else self._clock(),
                             self._name)
        self._clear_slot(slot)
        self._handoffs.append(pkg)
        self._stats["handoffs_out"] += 1
        return pkg

    def take_handoffs(self) -> List[HandoffPackage]:
        """Drain the packages a prefill-role engine exported."""
        out, self._handoffs = self._handoffs, []
        return out

    def _host_layout_ok(self, a: np.ndarray) -> bool:
        """A host block array this engine's pool can take bit for bit:
        its element width is the pool's (float32; bf16 as int16 or a
        numpy bfloat16) — never a cast."""
        want = np.float32 if self.cache_dtype == torch.float32 \
            else np.int16
        return _host_bits(a).dtype == want

    def import_handoff(self, pkg: HandoffPackage) -> bool:
        """Seat a prefilled package directly into a slot, skipping
        prefill: reuse blocks this engine already caches for the prefix,
        allocate exclusive blocks for the rest, copy the package's
        content in with one host-to-device copy, point the slot's table
        row at them and enter the decode loop at clock len(prompt) - 1.
        The content is bitwise what local prefill writes, so the tokens
        are those of a one-engine run. False when no slot or blocks are
        free (retry next round)."""
        if self.role == "prefill":
            raise ValueError("import_handoff on a prefill-role engine")
        if self._degraded:
            raise EngineDegraded(
                f"engine degraded ({self._degraded}); hand off to a "
                "healthy engine")
        if self._draining:
            raise EngineDraining(
                "engine is draining (stop-admission): hand off to "
                "another engine")
        req = pkg.request
        if req.id in self._in_flight():
            raise ValueError(f"request id {req.id} already in flight "
                             "or completed-unclaimed")
        k0 = pkg.kv[0]["k"]
        ref = self.pool[0]["k"]
        if len(pkg.kv) != len(self.pool) \
                or tuple(k0.shape[1:]) != self._block_shape \
                or not self._host_layout_ok(k0):
            raise ValueError(
                f"handoff package layout {len(pkg.kv)} layers x "
                f"{tuple(k0.shape[1:])} (block_size {k0.shape[2]}, "
                f"{k0.dtype}) does not match this engine's "
                f"{len(self.pool)} layers x {self._block_shape} "
                f"(block_size {self.block_size}, {ref.dtype}) — "
                "prefill and decode tiers must share model, "
                "block_size and cache_dtype")
        free = self._free_slots()
        if not free:
            return False
        prompt = list(req.prompt)
        n = len(prompt)
        nb = int(k0.shape[0])
        if nb > self._table.shape[1]:
            return False
        nodes: List[object] = []
        if self.prefix_cache_enabled:
            nodes = self._prefix.lookup_nodes(
                prompt, (n - 1) // self.block_size)
        nh = len(nodes)
        hit = self._readmit_chain(nodes)
        if hit is None:
            return False
        new = self._alloc_blocks(nb - nh)
        if new is None:
            self._pool_mgr.unref(hit)
            return False
        slot = free[0]
        if new:
            self._scatter_blocks(new, np.stack(
                [_host_bits(layer[k])[nh:] for layer in pkg.kv
                 for k in ("k", "v")]))
        self._point_table_row(slot, hit, new)
        self._seat_slot(slot, req, hit, new)
        self._meta[req.id] = {"t": pkg.submit_t}
        if nh:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_blocks_reused"] += nh
        self._stats["handoffs_in"] += 1
        return True

    # ------------------------------------------------- tree migration
    def prefix_match_tokens(self, prompt: Sequence[int]) -> int:
        """Prompt tokens this engine's radix tree already holds (either
        tier, COW cap applied), without touching LRU stamps."""
        n = len(prompt)
        if not self.prefix_cache_enabled or n == 0:
            return 0
        return self._prefix.peek_blocks(
            prompt, (n - 1) // self.block_size) * self.block_size

    def export_tree(self) -> List[Dict[str, object]]:
        """Export the radix tree as host-side entries for warm-state
        migration: one entry per node — the full prefix tokens from the
        root plus the block's bytes in the HandoffPackage per-layer
        {'k', 'v'} layout (one (H, block_size, D) row per array).
        Device-resident blocks are fetched in ONE batched copy; host-tier
        blocks are already bytes. Parents precede children."""
        entries = self._prefix.export_entries()
        if not entries:
            return []
        dev = [node for _, node in entries if node.block is not None]
        data = self._gather_blocks([node.block for node in dev]) \
            if dev else None
        pos = {id(node): j for j, node in enumerate(dev)}
        out: List[Dict[str, object]] = []
        for toks, node in entries:
            kv = node.host if node.block is None \
                else self._layer_views(data, pos[id(node)])
            out.append({"tokens": list(toks), "kv": kv})
        return out

    def import_tree(self, entries: Sequence[Dict[str, object]]) -> int:
        """Seed migrated chains into THIS engine's HOST tier: host RAM
        only, no device work; grafted blocks re-admit on their first
        prefix hit like any spilled block. Requires `spill=True`;
        incumbents win, host capacity applies. Returns the number of
        blocks grafted."""
        if not self.spill_enabled or not entries:
            return 0
        ref = self.pool[0]["k"]
        for e in entries:
            kv = e["kv"]
            if len(kv) != len(self.pool) \
                    or tuple(kv[0]["k"].shape) != self._block_shape \
                    or not self._host_layout_ok(kv[0]["k"]):
                raise ValueError(
                    f"migrated tree entry layout {len(kv)} layers x "
                    f"{tuple(kv[0]['k'].shape)} ({kv[0]['k'].dtype}) "
                    f"does not match this engine's {len(self.pool)} "
                    f"layers x {self._block_shape} ({ref.dtype}) — "
                    "migration requires a same-layout fleet")
        grafted = 0
        for e in sorted(entries, key=lambda e: len(e["tokens"])):
            if self._prefix.graft_host(e["tokens"], e["kv"]):
                grafted += 1
        return grafted


def _structure(tree) -> object:
    """A comparable description of a params tree's structure: dict keys,
    sequence lengths and which leaves are QuantWeights."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if hasattr(tree, "deq"):
        return "QuantWeight"
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(v) for v in tree)
    return "leaf"
