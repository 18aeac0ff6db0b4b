"""Continuous-batching inference engine over the paged KV cache.

Ports the core of bigdl_tpu/serving/engine.py. The design is the same:

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
  wrote is never shared.
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
* **Poison isolation.** The step returns a (B,) finite flag over the
  logits (utils/anomaly.rows_finite). A non-finite row evicts only its
  own request (status 'poisoned'); its freed exclusive blocks are
  scrubbed to zero and forgotten by the radix tree.

On the card the decode attention is the CUDA paged-decode kernel
(`attn_impl="cuda"`, the default for a CUDA device — unlike the JAX
engine, whose default is its XLA oracle: here the kernel IS the main
path). `attn_impl="torch"` runs the plain PyTorch version instead, for
comparison. `stats["attn_kernel_launches"]` counts the kernel launches
this engine's decode steps made.

Not in this slice (later ones, see ROADMAP.md): the step watchdog and
retries, deadlines and cancellation, the shed overload policies, the
host spill tier, disaggregated prefill (`role`) and handoff, tensor
parallelism, int8 weights and bf16 caches, a cache shorter than the
positional table, switching the prefix cache off, tenancy quotas,
telemetry events and metrics, and weight hot-swap.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.ops import paged_decode
from bigdl_tpu_torch.serving.bucketing import (bucket_for, default_buckets,
                                               pad_tokens)
from bigdl_tpu_torch.serving.kv_pool import BlockPool
from bigdl_tpu_torch.serving.prefix_cache import RadixPrefixCache
from bigdl_tpu_torch.serving.sampler import row_generator, sample_logits
from bigdl_tpu_torch.utils.anomaly import rows_finite
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

# admissions a request may fail for want of pool blocks before it
# finishes 'pool_exhausted' instead of cycling through the queue forever
ADMIT_REQUEUE_BUDGET = 64


class OverloadError(RuntimeError):
    """submit() with `max_queue` requests already queued."""


@dataclass
class Request:
    """One generation request. temperature <= 0 → greedy; top_k <= 0 /
    top_p >= 1 → that filter off. `stop_ids`: generation ends when one
    is sampled (the stop token is not emitted). `priority`: higher
    admits first, FIFO within a priority."""
    prompt: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: Sequence[int] = ()
    seed: int = 0
    id: Optional[int] = None
    priority: int = 0


@dataclass
class GenerationResult:
    """`status` is 'done' (finish_reason "stop_id" | "max_tokens" |
    "cache_full" | "pool_exhausted") or 'poisoned' (a non-finite logits
    row; the tokens before it are kept)."""
    id: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    status: str = "done"


class InferenceEngine:
    """Continuous-batching engine over a fixed number of cache slots.

    >>> eng = InferenceEngine(model, params, slots=8)
    >>> results = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=16)])

    `device`: None → the GPU (raises without CUDA; pass device="cpu" for
    the plain path on the host); it must be the model's device.
    `attn_impl`: None → "cuda" on a CUDA device, "torch" on the CPU.
    Paged-cache knobs as in the JAX engine: `block_size` (>= 2; the
    model's max_len must divide by it), `pool_blocks` (including the
    scratch block 0; default slots * max_len // block_size + 1). The
    cache is fp32 and spans the model's whole positional table.
    `max_queue` bounds the queue; a submission beyond it raises
    OverloadError (the JAX engine's overload_policy='reject')."""

    def __init__(self, model, variables: Dict[str, Any], slots: int = 4,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 attn_impl: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"the model's {model.device}")
        if attn_impl is None:
            attn_impl = "cuda" if self.device.type == "cuda" else "torch"
        if attn_impl not in paged_decode.IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r}: expected one of "
                             f"{paged_decode.IMPLS}")
        if attn_impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' needs a CUDA device")
        self.attn_impl = attn_impl
        self.model = model
        self._params = model.serving_params(variables)
        self.slots = slots
        self.cache_len = model.cfg.max_len
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
        self._admit_fails: Dict[int, int] = {}
        self.pool = model.init_block_pool(pool_blocks, block_size)
        self._pool_mgr = BlockPool(pool_blocks, block_size)
        self._prefix = RadixPrefixCache(self._pool_mgr)
        self.buckets = tuple(sorted(
            prefill_buckets if prefill_buckets is not None
            else default_buckets(self.cache_len)))
        if max(self.buckets) > self.cache_len:
            raise ValueError(f"bucket {max(self.buckets)} exceeds cache "
                             f"length {self.cache_len}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.max_queue = max_queue
        self._stats: Dict[str, int] = {
            "prefill_calls": 0, "decode_steps": 0, "requests_done": 0,
            "rejected": 0, "poisoned": 0, "prefix_hits": 0,
            "prefix_blocks_reused": 0, "prefix_tokens_saved": 0,
            "pool_evictions": 0, "admit_requeue_exhausted": 0,
            "attn_kernel_launches": 0,
        }
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

    @property
    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    @property
    def idle(self) -> bool:
        """No queued and no in-flight requests."""
        return not self._queue and all(r is None for r in self._req)

    # --------------------------------------------------------------- host
    def submit(self, request: Request) -> int:
        n = len(request.prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the engine "
                             "always samples at least one token)")
        bucket_for(n, self.buckets)      # raises if no bucket fits
        in_flight = {r.id for r in self._queue} \
            | {r.id for r in self._req if r is not None} \
            | set(self.completed)
        if request.id is None:
            rid = next(self._ids)
            while rid in in_flight:
                rid = next(self._ids)
            request.id = rid
        elif request.id in in_flight:
            raise ValueError(f"request id {request.id} already in flight "
                             "or completed-unclaimed")
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            self._stats["rejected"] += 1
            raise OverloadError(
                f"queue full ({self.max_queue}); request {request.id} "
                "rejected")
        self._queue.append(request)
        return request.id

    def _pop_next(self) -> Request:
        """Highest priority first; FIFO within a priority."""
        best_i, best_p = 0, None
        for i, r in enumerate(self._queue):
            if best_p is None or r.priority > best_p:
                best_i, best_p = i, r.priority
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """`n` fresh blocks, LRU-evicting refcount-0 prefix blocks under
        pool pressure; None when nothing more can be freed."""
        while self._pool_mgr.free_count < n:
            if self._prefix.evict_one() is None:
                break
            self._stats["pool_evictions"] += 1
        return self._pool_mgr.alloc(n)

    def _admit(self) -> None:
        for slot in [i for i, r in enumerate(self._req) if r is None]:
            while self._queue:
                req = self._pop_next()
                if self._admit_into(slot, req):
                    self._admit_fails.pop(req.id, None)
                    break
                # pool pressure: requeue at the front, a bounded number
                # of times — a pool that never frees must not spin the
                # request through the queue forever
                fails = self._admit_fails.pop(req.id, 0) + 1
                if fails > ADMIT_REQUEUE_BUDGET:
                    self._stats["admit_requeue_exhausted"] += 1
                    self._stats["requests_done"] += 1
                    self.completed[req.id] = GenerationResult(
                        req.id, list(req.prompt), [], "pool_exhausted")
                    continue
                self._admit_fails[req.id] = fails
                self._queue.appendleft(req)
                return
            if not self._queue:
                return

    def _admit_into(self, slot: int, req: Request) -> bool:
        """Prefix lookup + block allocation + suffix prefill into
        `slot`. False = not enough pool blocks (the caller requeues)."""
        prompt = list(req.prompt)
        n = len(prompt)
        bs = self.block_size
        # reuse at most the full blocks strictly before the re-decoded
        # last prompt token (copy-on-write cap)
        hit = self._prefix.lookup(prompt, (n - 1) // bs)
        # the suffix bucket must fit the table
        while hit and len(hit) * bs + bucket_for(
                n - len(hit) * bs, self.buckets) > self.cache_len:
            hit.pop()
        start = len(hit) * bs
        suffix = prompt[start:]
        b = bucket_for(len(suffix), self.buckets)
        # pin the hit chain BEFORE allocating, so the allocator's LRU
        # eviction cannot reclaim the blocks this admission matched
        self._pool_mgr.ref(hit)
        new = self._alloc_blocks(-(-b // bs))
        if new is None:
            self._pool_mgr.unref(hit)
            return False
        row = self._table[slot]
        row[:] = 0
        row[:len(hit)] = hit
        row[len(hit):len(hit) + len(new)] = new
        dev = self.device
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
        # the prompt's full blocks before the cap become cacheable now:
        # their content is written (later readers run after this
        # prefill on the same stream); the hit chain is skipped
        cap_blocks = (n - 1) // bs
        if cap_blocks:
            owned = self._prefix.insert(
                prompt, [int(x) for x in row[:cap_blocks]])
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
        return True

    def _finish(self, slot: int, reason: str,
                status: str = "done") -> GenerationResult:
        req = self._req[slot]
        res = GenerationResult(req.id, list(req.prompt), self._gen[slot],
                               reason, status)
        self._req[slot] = None
        self._gen[slot] = []
        self._temp[slot] = 0.0
        self._release_slot(slot, poisoned=(status == "poisoned"))
        self._stats["poisoned" if status == "poisoned"
                    else "requests_done"] += 1
        return res

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

    def _emit(self, slot: int, tok: int, finite: bool
              ) -> Optional[GenerationResult]:
        """Apply one sampled token to `slot`: evict on a non-finite row,
        finish on a stop id (not emitted), max_tokens or a full cache,
        else advance the row clock."""
        req = self._req[slot]
        self._nout[slot] += 1
        if not finite:
            return self._finish(slot, "poisoned", "poisoned")
        if tok in req.stop_ids:
            return self._finish(slot, "stop_id")
        self._gen[slot].append(tok)
        if len(self._gen[slot]) >= req.max_new_tokens:
            return self._finish(slot, "max_tokens")
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

    def _decode(self):
        """One decode step over all slots; returns host (tokens,
        finite) arrays — the step's one device-to-host fetch."""
        dev = self.device
        launches0 = paged_decode.launches
        logits, _ = self.model.decode_step_paged(
            self._params, torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._pos).to(dev), self.pool,
            torch.from_numpy(self._table).to(dev),
            attn_impl=self.attn_impl)
        self._stats["attn_kernel_launches"] += \
            paged_decode.launches - launches0
        finite = rows_finite(logits)
        gens = [row_generator(int(self._seed[i]), int(self._nout[i]), dev)
                if r is not None and self._temp[i] > 0 else None
                for i, r in enumerate(self._req)]
        nxt = sample_logits(
            logits, gens, torch.from_numpy(self._temp).to(dev),
            torch.from_numpy(self._topk).to(dev),
            torch.from_numpy(self._topp).to(dev))
        return nxt.cpu().numpy(), finite.cpu().numpy()

    def step(self) -> List[GenerationResult]:
        """Admit queued requests into free slots, run ONE decode step
        over all slots, evict finished or poisoned sequences. Returns
        the requests that reached a terminal state in this step."""
        self._admit()
        done = self._ensure_blocks()
        if all(r is None for r in self._req):
            return done
        nxt, finite = self._decode()
        self._stats["decode_steps"] += 1
        for i, req in enumerate(self._req):
            if req is not None:
                res = self._emit(i, int(nxt[i]), bool(finite[i]))
                if res is not None:
                    done.append(res)
        return done

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[GenerationResult]:
        """Submit `requests` (if given), then step until queue and slots
        drain. Returns `requests`' results in submission order (or, with
        no argument, everything that finished, in id order). Results of
        other requests that finished meanwhile stay in `completed`."""
        ids = [self.submit(r) for r in requests] if requests else None
        while not self.idle:
            for res in self.step():
                self.completed[res.id] = res
        if ids is None:
            out = sorted(self.completed.values(), key=lambda r: r.id)
            self.completed = {}
            return out
        return [self.completed.pop(i) for i in ids]
