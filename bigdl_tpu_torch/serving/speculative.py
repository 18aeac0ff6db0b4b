"""Speculative decoding — draft-verify serving with EXACT acceptance.

Ports bigdl_tpu/serving/speculative.py. A decode step streams every
weight once to emit ONE token a slot. `SpeculativeEngine` wraps a cheap
DRAFT `InferenceEngine` and an expensive TARGET engine behind the
engine surface the EngineRouter drives. Each scheduling round the draft
decodes k tokens ahead on its own paged cache, then the target scores
all k+1 positions in ONE call, so its weight traffic is shared by every
accepted token.

Exactness
---------
The verify call is the target's own decode step (`_decode_rows`, the
paged-decode kernel on the card) with the k+1 chain positions riding
the ROW axis: row (slot, j) carries token_j at clock pos+j through the
slot's own block table. Every op of `decode_step_paged` is per row, each
layer writes all rows' k/v before any row attends, and the layer norms
and products run over tiles of B rows, the extent of the target's own
step (`decode_step_paged(row_tile=)`), so a verify row's logits are
bitwise the logits the target-only step computes for that position, at
B·(k+1) rows as at B.

Acceptance is COUPLED sampling: the sampler draws row r's token from
`row_generator(seed, n)` (serving/sampler.py), so verify row j's sample
IS the token the target-only engine emits at output index n0+j, greedy
and seeded alike. The draft proposes for that index from the SAME
generator state (common random numbers), and its proposal is accepted
iff it equals the target's sample; the first mismatch emits the
target's own sample and drops the rest, and a fully matched chain emits
the bonus k+1-th sample. Emitted tokens are the target-only stream
verbatim; the draft moves only the accept rate.

Cache discipline
----------------
Verify rows write their k/v at pos..pos+k into the slot's EXCLUSIVE
blocks (`_ensure_blocks(horizons=...)` pre-grows the table; the
copy-on-write cap keeps decode writes out of shared blocks). A rejected
suffix needs no scrub: its positions sit past the rolled-back clock,
masked on read and overwritten later; whole lookahead blocks past the
clock's block detach through `rollback_slot`. The draft shadows the
accepted sequence on its own cache; a fully accepted round leaves it
one position behind (the bonus was never proposed), which the next
round's catch-up step repairs before proposing.

Reliability: the draft is expendable — a draft watchdog trip or failure
quiesces the draft (`InferenceEngine.quiesce`: engine_degraded, no
request terminals) and the wrapper falls back to the target's own
step(), with the tokens of an undisturbed target-only run. The verify
dispatch uses the target's watchdog, retries and degradation. Each
dispatch runs on its engine's watchdog thread inside that engine's
`_device_ctx()` (its device and stream).

Adaptive lookahead: `adapt_k=True` drives `k_live` from the measured
accept rate — a per-round accepted/proposed fraction feeds a registry
histogram whose `obs/timeseries.HistogramWindow` median is evaluated
every `adapt_window` proposing rounds: >= `raise_at` steps k_live up
(ceiling `k`), < `lower_at` down (floor `k_min`), < `collapse_at`
suspends speculation (the wrapper cruises on the target's own step()
and probes with one round every `probe_every`). `swap_draft(variables)`
hot-swaps draft weights through `InferenceEngine.swap_params` and
records the accept rate before and after. Neither moves a token.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs.timeseries import HistogramWindow
from bigdl_tpu_torch.ops import paged_decode
from bigdl_tpu_torch.serving.engine import (GenerationResult,
                                            InferenceEngine, Request,
                                            StepTimeout,
                                            _sticky_device_error,
                                            _watchdog_call)
from bigdl_tpu_torch.utils import faults


class SpeculativeEngine:
    """Draft-verify wrapper over two `InferenceEngine`s.

    >>> spec = SpeculativeEngine(draft_eng, target_eng, k=4)
    >>> spec.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    >>> results = spec.run()        # tokens == target-only, faster

    Requests live in the TARGET engine (queue, slots, deadlines,
    overload, lifecycle events all under the target's label); the
    draft holds per-slot shadow mirrors of the same sequences. `k` is
    the draft lookahead CEILING per round (constructor arg, never
    env); `adapt_k=True` lets the measured accept rate move the live
    lookahead between `k_min` and `k` — and suspend speculation
    outright on a collapse (module docstring). The
    wrapper exposes the full router-driven engine surface; `health()`
    adds a "speculative" section (accept rate, draft overhead,
    fallback state) and the draft engine's health rides under
    ["speculative"]["draft"].
    """

    def __init__(self, draft: InferenceEngine, target: InferenceEngine,
                 k: int = 4, *, adapt_k: bool = False, k_min: int = 1,
                 adapt_window: int = 8, raise_at: float = 0.6,
                 lower_at: float = 0.3, collapse_at: float = 0.1,
                 probe_every: int = 64):
        if k < 1:
            raise ValueError("k must be >= 1 (the draft proposes at "
                             "least one token per round)")
        if not 1 <= k_min <= k:
            raise ValueError(f"k_min must satisfy 1 <= k_min <= k "
                             f"(got k_min={k_min}, k={k})")
        if adapt_window < 1:
            raise ValueError("adapt_window must be >= 1 proposing "
                             "rounds per evaluation")
        if probe_every < 1:
            raise ValueError("probe_every must be >= 1 (how many "
                             "suspended rounds buy one probe)")
        if not 0.0 <= collapse_at <= lower_at < raise_at <= 1.0:
            raise ValueError(
                "adaptive thresholds must satisfy 0 <= collapse_at <= "
                f"lower_at < raise_at <= 1 (got collapse_at="
                f"{collapse_at}, lower_at={lower_at}, "
                f"raise_at={raise_at}); the lower_at < raise_at gap is "
                "the hysteresis band that keeps k from oscillating")
        for name, eng in (("draft", draft), ("target", target)):
            if eng.role == "prefill":
                raise ValueError(f"{name} engine has role='prefill': "
                                 "speculation happens on the decode "
                                 "path")
            if eng.degraded:
                raise ValueError(f"{name} engine is already degraded "
                                 f"({eng.degraded})")
        if draft is target:
            raise ValueError("draft and target must be distinct "
                             "engines (self-speculation would pay the "
                             "target's weight traffic per proposal)")
        if draft.model.cfg.vocab_size != target.model.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft.model.cfg.vocab_size} != target "
                f"vocab {target.model.cfg.vocab_size}: proposals and "
                "samples must share one token space")
        if draft.slots != target.slots:
            raise ValueError(
                f"draft slots {draft.slots} != target slots "
                f"{target.slots}: the draft shadows the target's "
                "slot table one-to-one")
        if draft.cache_len != target.cache_len \
                or draft.buckets != target.buckets:
            raise ValueError(
                "draft and target must share cache length and prefill "
                f"buckets (draft {draft.cache_len}/{draft.buckets} vs "
                f"target {target.cache_len}/{target.buckets}): every "
                "admission the target accepts must mirror into the "
                "draft")
        self._d = draft
        self._t = target
        self.k = k
        # --- adaptive lookahead -------------------------
        # `k` stays the CEILING that fixes the verify pass's B*(k+1)
        # rows; `k_live` is the per-round horizon cap — purely
        # host-side.
        self._adapt = bool(adapt_k)
        self.k_min = int(k_min)
        self.k_live = int(k)
        self.adapt_window = int(adapt_window)
        self.raise_at = float(raise_at)
        self.lower_at = float(lower_at)
        self.collapse_at = float(collapse_at)
        self.probe_every = int(probe_every)
        self._suspended = False          # cruising on target.step()
        self._suspended_rounds = 0       # cruise rounds since suspend
        self._probe_next = False         # force a probe next round
        self._rounds_windowed = 0        # proposing rounds since eval
        self._adjusts = 0                # spec_k_adjust evaluations
        self._last_window_accept: Optional[float] = None
        # draft hot-swap provenance (tentpole b): records pair
        # accept-before with an accept-after measured over the next
        # `adapt_window` proposing rounds (cumulative counters, so it
        # works with adaptation off too)
        self._swaps = 0
        self._swap_records: List[Dict[str, object]] = []
        self._pending_swap: Optional[Dict[str, object]] = None
        self._swap_base = (0, 0)         # (accepted, proposed) at swap
        self._swap_rounds = 0            # proposing rounds since swap
        # draft fallback reason (None while speculating); a degraded
        # draft turns every subsequent step() into target.step() —
        # tokens stay bit-identical because the target's row state is
        # by construction the state a target-only run would hold
        self._fallback: Optional[str] = None
        # per-slot shadow bookkeeping: which request id each draft
        # slot mirrors, and whether the draft trails the target by one
        # position (the post-bonus lag a catch-up step repairs)
        self._mirror_ids: List[Optional[int]] = [None] * target.slots
        self._lag = np.zeros(target.slots, np.int32)
        self._stats: Dict[str, int] = {
            "spec_rounds": 0, "draft_steps": 0, "proposed": 0,
            "accepted": 0, "wasted": 0, "emitted": 0, "fallbacks": 0,
        }
        reg = obs.get_registry()
        labels = dict(engine=target.obs_name, draft=draft.obs_name)
        self._m_accepted = reg.counter(
            "serving_spec_accepted_tokens_total",
            "draft proposals the target's coupled sample confirmed",
            labelnames=("engine", "draft")).labels(**labels)
        self._m_wasted = reg.counter(
            "serving_spec_wasted_draft_total",
            "draft proposals rejected at verify (draft compute spent, "
            "no token emitted from it)",
            labelnames=("engine", "draft")).labels(**labels)
        # adaptation input: one observation per proposing round, the
        # round's accepted/proposed fraction. Observed UNGATED like the
        # target's _m_lat (core bookkeeping — the k ladder must keep
        # working under BIGDL_OBS=off); consumes host ints only, zero
        # device syncs. 0.05-wide buckets bound the windowed-median
        # estimate the thresholds compare against.
        self._m_accept_frac = reg.histogram(
            "serving_spec_accept_fraction",
            "per-round accepted/proposed fraction (adaptive-lookahead "
            "window input)",
            labelnames=("engine", "draft"),
            buckets=tuple(i / 20 for i in range(21))).labels(**labels)
        self._accept_window = HistogramWindow(self._m_accept_frac)

    # ------------------------------------------------- delegated surface
    @property
    def model(self):
        return self._t.model

    @property
    def slots(self) -> int:
        return self._t.slots

    @property
    def buckets(self):
        return self._t.buckets

    @property
    def cache_len(self) -> int:
        return self._t.cache_len

    @property
    def max_queue(self):
        return self._t.max_queue

    @property
    def tp(self) -> int:
        return self._t.tp

    @property
    def role(self) -> str:
        return self._t.role

    @property
    def completed(self) -> Dict[int, GenerationResult]:
        return self._t.completed

    @property
    def stats(self) -> Dict[str, int]:
        """Target-engine counters plus the speculation tallies."""
        d = self._t.stats
        d.update(self._stats)
        return d

    @property
    def degraded(self) -> Optional[str]:
        return self._t.degraded

    @property
    def draining(self) -> bool:
        return self._t.draining

    @property
    def idle(self) -> bool:
        return self._t.idle

    @property
    def slots_active(self) -> int:
        return self._t.slots_active

    @property
    def queue_depth(self) -> int:
        return self._t.queue_depth

    @property
    def obs_name(self) -> str:
        return self._t.obs_name

    @property
    def layout_family(self) -> str:
        """The TARGET's layout: coupled acceptance emits the
        target-only stream verbatim, so the draft's layout never shows
        in the tokens — router failover gates on the target family."""
        return self._t.layout_family

    @property
    def model_tag(self):
        """The TARGET's engine group — routing is by the
        model the client sees, and that is the target's."""
        return self._t.model_tag

    @property
    def draft_engine(self) -> InferenceEngine:
        return self._d

    @property
    def target_engine(self) -> InferenceEngine:
        return self._t

    @property
    def swap_records(self) -> List[Dict[str, object]]:
        """Hot-swap provenance: one record per swap_draft
        with accept_before/accept_after — copies, in swap order."""
        return [dict(r) for r in self._swap_records]

    @property
    def fallback(self) -> Optional[str]:
        """None while speculating; else why the wrapper now drives
        the target's own single-token step."""
        return self._fallback

    def submit(self, request: Request) -> int:
        return self._t.submit(request)

    def drain(self) -> None:
        self._t.drain()

    def steal_queued(self, n: int):
        return self._t.steal_queued(n)

    def _requeue(self, request: Request, t=None) -> None:
        self._t._requeue(request, t)

    def take_handoffs(self):
        return self._t.take_handoffs()

    # fleet-scale KV surface: the router's affinity probe
    # and warm-state migration see the TARGET's tree — that's where
    # the request-visible blocks live. The draft mirrors spill on
    # their own engine's tier (construct the draft with spill=True);
    # its tree never migrates: a survivor's draft re-prefills shadows
    # from the prompt, and draft bits move only accept rate, never a
    # token.
    @property
    def spill_enabled(self) -> bool:
        return self._t.spill_enabled

    def prefix_match_tokens(self, prompt: Sequence[int]) -> int:
        return self._t.prefix_match_tokens(prompt)

    def export_tree(self):
        return self._t.export_tree()

    def import_tree(self, entries) -> int:
        return self._t.import_tree(entries)

    def cancel(self, request_id: int) -> GenerationResult:
        slot = next((i for i, r in enumerate(self._t._req)
                     if r is not None and r.id == request_id), None)
        res = self._t.cancel(request_id)
        if slot is not None:
            self._release_mirror(slot)
        return res

    def import_handoff(self, pkg) -> bool:
        """Seat a disaggregated-prefill package in the target, then
        mirror the prompt into the draft by RE-PREFILLING it there
        (the package's KV are target-layer bits — useless to the
        draft model, whose shadow needs its own): handoff stays
        layout-invariant because prefill bits are."""
        if not self._t.import_handoff(pkg):
            return False
        if self._fallback is None and self._d.degraded is None:
            slot = next(i for i, r in enumerate(self._t._req)
                        if r is not None and r.id == pkg.request.id)
            self._mirror_slot(slot)
        return True

    def health(self) -> Dict[str, object]:
        h = self._t.health()
        s = self._stats
        denom = s["proposed"]
        h["speculative"] = {
            "k": self.k,
            "k_live": self.k_live,
            "k_min": self.k_min,
            "adaptive": self._adapt,
            "suspended": self._suspended,
            "k_adjusts": self._adjusts,
            "window_accept": self._last_window_accept,
            "swaps": self._swaps,
            "last_swap": (dict(self._swap_records[-1])
                          if self._swap_records else None),
            "fallback": self._fallback,
            "rounds": s["spec_rounds"],
            "draft_steps": s["draft_steps"],
            "proposed": s["proposed"],
            "accepted": s["accepted"],
            "wasted": s["wasted"],
            "emitted": s["emitted"],
            "accept_rate": (round(s["accepted"] / denom, 4)
                            if denom else None),
            "tokens_per_round": (round(s["emitted"] / s["spec_rounds"],
                                       4) if s["spec_rounds"] else None),
            # cheap-property derivation, NOT self._d.health(): this
            # rides every router/autoscaler/scrape health() call, and
            # a full second-engine snapshot (histogram quantiles +
            # registry view) for one string is ops-loop waste
            "draft": {"engine": self._d.obs_name,
                      "state": ("degraded" if self._d.degraded
                                else "ok"),
                      "tp": self._d.tp},
        }
        return h

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[GenerationResult]:
        """submit + step to drain, exactly like InferenceEngine.run."""
        ids = [self.submit(r) for r in requests] if requests else None
        t = self._t
        while t._queue or any(r is not None for r in t._req):
            for res in self.step():
                t.completed[res.id] = res
        if ids is None:
            out = sorted(t.completed.values(), key=lambda r: r.id)
            t.completed = {}
            return out
        return [t.completed.pop(i) for i in ids]

    # --------------------------------------------------- mirror plumbing
    def _mirror_slot(self, slot: int) -> bool:
        """Seat a shadow of the target's slot into the SAME draft
        slot: the draft prefills the prompt through its own radix
        prefix cache (a shared-prompt burst amortizes draft prefill
        too) and enters the decode loop at clock len(prompt)-1, like
        any admission. The clone carries the request's sampling
        fields (the draft proposes from the target's sampling streams —
        common random numbers) but no trace id: shadows must not
        appear in request journeys."""
        req = self._t._req[slot]
        clone = Request(prompt=list(req.prompt),
                        max_new_tokens=req.max_new_tokens,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, stop_ids=req.stop_ids,
                        seed=req.seed, id=req.id)
        if not self._d._admit_into(slot, clone):
            return False
        self._mirror_ids[slot] = req.id
        self._lag[slot] = 0
        return True

    def _seq_token(self, slot: int, pos: int) -> int:
        """Token at absolute position `pos` of the target's ACCEPTED
        sequence (prompt, then emitted tokens) — the catch-up replay
        input. Every accepted token is the target's own sample, so
        this is exactly what a target-only run holds at `pos`."""
        req = self._t._req[slot]
        lp = len(req.prompt)
        if pos < lp:
            return int(req.prompt[pos])
        return int(self._t._gen[slot][pos - lp])

    def _release_mirror(self, slot: int, poisoned: bool = False) -> None:
        if self._d._req[slot] is not None:
            # the quiet engine-side release: no terminal, no counter
            self._d._clear_slot(slot, poisoned=poisoned)
        self._mirror_ids[slot] = None
        self._lag[slot] = 0

    def _release_all_mirrors(self) -> None:
        for i in range(self._t.slots):
            self._release_mirror(i)

    def _enter_fallback(self, reason: str, watchdog: bool) -> None:
        """Quiesce the draft and hand every subsequent round to the
        target's own step(). The target's row state at this instant is
        bitwise the state an undisturbed target-only run holds (every
        accepted token WAS the target's own sample, every cache write
        its own bits), so the degradation is invisible in the token
        stream (the serve_spec drill)."""
        self._fallback = reason
        self._stats["fallbacks"] += 1
        self._d.quiesce(reason, watchdog=watchdog)
        self._release_all_mirrors()
        obs.emit_event("spec_fallback", plane="serving",
                       engine=self._t.obs_name,
                       draft_engine=self._d.obs_name, reason=reason)

    # ------------------------------------ adaptive lookahead
    def _evaluate_k(self) -> None:
        """One ladder evaluation: compare the HistogramWindow median of
        per-round accept fractions against the thresholds, move k_live
        one rung (hysteresis: the lower_at..raise_at band holds), or
        suspend/resume. Emits `spec_k_adjust` per evaluation — the
        event sequence is the k timeline. Pure host-side: no device
        work."""
        accept = self._accept_window.quantile(0.5)
        self._rounds_windowed = 0
        if accept is None:
            return                      # window saw no proposals: hold
        k_from = self.k_live
        if self._suspended:
            if accept >= self.raise_at:
                # probe cleared the resume bar: speculate again from
                # the floor; later evaluations climb the ladder
                self._suspended = False
                self._suspended_rounds = 0
        elif accept < self.collapse_at:
            # straight drop: a collapsed draft makes every verify row
            # past j=0 waste — stop paying for the verify pass at all
            self.k_live = self.k_min
            self._suspended = True
            self._suspended_rounds = 0
        elif accept < self.lower_at:
            self.k_live = max(self.k_min, self.k_live - 1)
        elif accept >= self.raise_at:
            self.k_live = min(self.k, self.k_live + 1)
        self._adjusts += 1
        self._last_window_accept = round(float(accept), 4)
        obs.emit_event("spec_k_adjust", plane="serving",
                       engine=self._t.obs_name,
                       draft_engine=self._d.obs_name,
                       round=self._stats["spec_rounds"],
                       k_from=k_from, k_to=self.k_live,
                       accept=self._last_window_accept,
                       suspended=self._suspended,
                       window=self.adapt_window)

    def _settle_swap(self) -> None:
        """Fill the open swap record's accept_after from the proposing
        rounds since the swap (cumulative counters, so this works with
        adaptation off too) and close it."""
        rec = self._pending_swap
        acc0, prop0 = self._swap_base
        dprop = self._stats["proposed"] - prop0
        if dprop:
            rec["accept_after"] = round(
                (self._stats["accepted"] - acc0) / dprop, 4)
        self._pending_swap = None

    def swap_draft(self, variables, source: str = "distill") -> None:
        """Hot-swap improved draft weights into the live draft engine:
        `InferenceEngine.swap_params` re-places the new variables over
        the SAME serving layout — no quiesce, requests in flight keep
        decoding. Tokens cannot move: acceptance is coupled sampling,
        so draft bits change ONLY the accept rate. Emits `draft_swap`
        with accept_before; accept_after lands on the swap record (and
        health()["speculative"]["last_swap"]) after the next
        `adapt_window` proposing rounds. A fresh accept window opens so
        pre-swap observations never dilute the post-swap ladder."""
        if self._fallback is not None:
            raise RuntimeError(
                f"swap_draft after fallback ({self._fallback}): the "
                "draft is quiesced — build a fresh wrapper instead")
        s = self._stats
        before = self._last_window_accept
        if before is None and s["proposed"]:
            before = round(s["accepted"] / s["proposed"], 4)
        if self._pending_swap is not None:
            self._settle_swap()         # back-to-back swaps: close out
        self._d.swap_params(variables)
        self._swaps += 1
        rec: Dict[str, object] = {
            "swap": self._swaps, "round": s["spec_rounds"],
            "accept_before": before, "accept_after": None,
            "source": source}
        self._swap_records.append(rec)
        self._pending_swap = rec
        self._swap_base = (s["accepted"], s["proposed"])
        self._swap_rounds = 0
        # drain the delta window: post-swap evaluations measure the
        # NEW draft only
        self._accept_window.quantile(0.5)
        self._rounds_windowed = 0
        if self._adapt and self._suspended:
            self._probe_next = True     # audition the new draft now
        obs.emit_event("draft_swap", plane="serving",
                       engine=self._t.obs_name,
                       draft_engine=self._d.obs_name,
                       swap=self._swaps, accept_before=before,
                       round=s["spec_rounds"], source=source)

    # -------------------------------------------------------- dispatches
    @staticmethod
    def _guarded(eng: InferenceEngine, rows, slow_s: float, abandon):
        """One `_decode_rows` call on `eng` under its watchdog budget, on
        the watchdog's worker thread inside the engine's device and
        stream (`_device_ctx()`), counting the kernel launches it made
        into the engine's `attn_kernel_launches`. `abandon()` true when
        the worker wakes from an injected stall means the watchdog
        already tripped: launch nothing nobody will consume."""
        def work():
            if slow_s:
                time.sleep(slow_s)    # injected straggler/hang model
            if abandon():
                return None
            launches0 = paged_decode.launches
            try:
                with torch.no_grad(), eng._device_ctx():
                    return eng._decode_rows(*rows)
            finally:
                eng._stats["attn_kernel_launches"] += \
                    paged_decode.launches - launches0

        return _watchdog_call(work, eng.step_timeout_s)

    def _draft_dispatch(self, tok, pos, nout, table, slow_s: float):
        """One draft chain step over all slots (inert rows point at the
        scratch block). Guarded by the DRAFT's watchdog budget — the
        draft is the expendable half, so a trip here becomes fallback,
        not an outage. The chain is sequential (step j+1's input token
        is step j's sample), so each draft step fetches its tokens."""
        d = self._d
        rows = (tok, pos, d._seed, nout, d._temp, d._topk, d._topp,
                np.zeros(d.slots, bool), table)
        nxt, _ = self._guarded(
            d, rows, slow_s,
            lambda: d._degraded is not None
            or self._t._degraded is not None)
        return nxt

    def _verify_dispatch(self, tok, pos, seed, nout, temp, topk, topp,
                         poison, table, slow_s: float):
        """The round's ONE target weight pass: B·(k+1) chain-position
        rows through the target's decode step (the paged-decode kernel
        launched once a layer over all of them), guarded by the
        TARGET's watchdog budget."""
        t = self._t
        return self._guarded(
            t, (tok, pos, seed, nout, temp, topk, topp, poison, table),
            slow_s, lambda: t._degraded is not None)

    # ------------------------------------------------------------- step
    def step(self) -> List[GenerationResult]:
        """One speculative scheduling round: admit + mirror, draft k
        ahead, verify all chain positions in one target pass, accept
        the longest coupled-sample match, emit, roll back the rejected
        suffix. Degrades to the target's own step() when the draft is
        gone."""
        t, d, k = self._t, self._d, self.k
        if t._degraded:
            return []
        t._tick()
        d._tick()
        if self._fallback is not None:
            return t.step()
        if d.degraded is not None:
            # the draft died outside our dispatch (external quiesce)
            self._enter_fallback(f"draft degraded ({d.degraded})",
                                 watchdog=False)
            return t.step()
        if self._adapt and self._suspended:
            # acceptance collapsed: cruise on the target's own step()
            # (true target-only cost — the verify pass, not k_live,
            # is the speculation tax, and only skipping it zeroes the
            # bill). One probe round per `probe_every` re-measures.
            self._suspended_rounds += 1
            if not (self._probe_next
                    or self._suspended_rounds % self.probe_every == 0):
                return t.step()
            self._probe_next = False
        t._admit()
        for i, req in enumerate(t._req):
            if req is not None and self._mirror_ids[i] != req.id:
                if self._mirror_ids[i] is not None:
                    # stale shadow: the slot turned over during
                    # suspended cruise rounds (terminals there happen
                    # inside t.step(), which never touches mirrors)
                    self._release_mirror(i)
                if not self._mirror_slot(i):
                    self._enter_fallback(
                        "draft pool exhausted mirroring admission",
                        watchdog=False)
                    return t.step()
        if self._adapt:
            # cruise rounds advance the target while the draft shadow
            # idles — recompute the lag from positions (the invariant
            # the incremental bookkeeping maintains in steady state;
            # identical for the lag<=1 cases, general after a cruise)
            for i, req in enumerate(t._req):
                if req is not None and self._mirror_ids[i] == req.id:
                    self._lag[i] = int(t._pos[i]) - int(d._pos[i])
        B = t.slots
        # per-slot horizons: how many proposals this round may verify.
        # A lagging slot's catch-up step does NOT shrink its horizon:
        # the catch-up consumes neither a verify row (rows = h+1) nor
        # a proposals column (j = s - lag <= k-1), so a fully-accepted
        # round keeps proposing k next round — capping at k - lag
        # would starve the high-accept regime (and stall speculation
        # entirely at k=1)
        horizons = np.zeros(B, np.int32)
        for i, req in enumerate(t._req):
            if req is None:
                continue
            head = t.cache_len - 1 - int(t._pos[i])
            remaining = req.max_new_tokens - len(t._gen[i])
            # k_live (== k unless adapt_k moved it) caps the horizon —
            # host-side only; verify rows stay B*(k+1)
            horizons[i] = max(0, min(self.k_live, head, remaining))
        done = t._ensure_blocks(horizons)
        for i in range(B):
            if t._req[i] is None and self._mirror_ids[i] is not None:
                self._release_mirror(i)       # pool_exhausted evictee
                horizons[i] = 0
        if all(r is None for r in t._req):
            return done
        # draft lookahead blocks: the chain writes cover
        # draft_pos..target_pos+h-1 (catch-up included)
        draft_h = np.maximum(horizons + self._lag - 1, 0)
        draft_h[[i for i in range(B) if t._req[i] is None]] = 0
        # exhaust='abort': a mirror must never finish 'pool_exhausted'
        # (that emits a request_terminal for a request that keeps
        # living in the target) — draft pool pressure means fallback
        if d._ensure_blocks(draft_h, exhaust="abort") is None:
            self._enter_fallback("draft pool exhausted growing "
                                 "lookahead blocks", watchdog=False)
            return done + t.step()

        plan = faults.get_plan()
        active = [i for i in range(B) if t._req[i] is not None]

        # ---- draft chain: lag catch-up steps, then proposals -------
        proposals = np.zeros((B, k), np.int32)
        steps_per_slot = np.zeros(B, np.int32)
        for i in active:
            steps_per_slot[i] = int(self._lag[i]) + int(horizons[i])
        ctok = d._tok.copy()
        cpos = d._pos.copy()
        nsteps = int(steps_per_slot.max()) if len(active) else 0
        for s in range(nsteps):
            tok_op = np.zeros(B, np.int32)
            pos_op = np.zeros(B, np.int32)
            nout_op = np.zeros(B, np.int32)
            table_op = np.zeros_like(d._table)
            live = [i for i in active if s < steps_per_slot[i]]
            for i in live:
                tok_op[i] = ctok[i]
                pos_op[i] = cpos[i]
                nout_op[i] = int(t._nout[i]) + max(s - int(self._lag[i]),
                                                   0)
                table_op[i] = d._table[i]
            dstep = d._stats["decode_steps"]
            slow_s = 0.0
            if plan.fires("serve_slow", dstep):
                slow_s = (d.step_timeout_s or 0.05) * 5
            try:
                plan.maybe_raise("serve_err", dstep)
                nxt = self._draft_dispatch(tok_op, pos_op, nout_op,
                                           table_op, slow_s)
            except StepTimeout as e:
                self._enter_fallback(
                    f"draft watchdog trip at draft step {dstep}: {e}",
                    watchdog=True)
                return done + t.step()
            except Exception as e:              # noqa: BLE001
                self._enter_fallback(
                    f"draft step {dstep} failed: {e}", watchdog=False)
                return done + t.step()
            d._bump("decode_steps")
            self._stats["draft_steps"] += 1
            for i in live:
                if s < int(self._lag[i]):
                    # catch-up wrote the already-known token at cpos;
                    # the chain advances along the ACCEPTED sequence
                    # (prompt + target gen) — for the classic lag-1
                    # case the next input IS the target's current
                    # (t._tok, t._pos), bitwise the old single-step
                    # catch-up; larger lags (post-cruise probes,
                    # adaptive lookahead) replay the intermediate tokens the
                    # target emitted while the shadow idled
                    p1 = int(cpos[i]) + 1
                    ctok[i] = self._seq_token(i, p1)
                    cpos[i] = p1
                else:
                    j = s - int(self._lag[i])
                    proposals[i, j] = int(nxt[i])
                    ctok[i] = int(nxt[i])
                    cpos[i] = cpos[i] + 1

        # ---- verify: all chain positions as rows of ONE target pass
        Bv = B * (k + 1)
        vtok = np.zeros(Bv, np.int32)
        vpos = np.zeros(Bv, np.int32)
        vseed = np.zeros(Bv, np.int64)
        vnout = np.zeros(Bv, np.int32)
        vtemp = np.zeros(Bv, np.float32)
        vtopk = np.zeros(Bv, np.int32)
        vtopp = np.ones(Bv, np.float32)
        vpoison = np.zeros(Bv, bool)
        vtable = np.zeros((Bv, t._table.shape[1]), np.int32)
        for i in active:
            base = i * (k + 1)
            for j in range(int(horizons[i]) + 1):
                r = base + j
                vtok[r] = int(t._tok[i]) if j == 0 \
                    else int(proposals[i, j - 1])
                vpos[r] = int(t._pos[i]) + j
                vseed[r] = t._seed[i]
                vnout[r] = int(t._nout[i]) + j
                vtemp[r] = t._temp[i]
                vtopk[r] = t._topk[i]
                vtopp[r] = t._topp[i]
                vtable[r] = t._table[i]
        stepno = t._stats["decode_steps"]
        if plan.fires("serve_nan", stepno):
            vpoison[active[0] * (k + 1)] = True   # lowest active slot
        for attempt in range(t.step_retries + 1):
            try:
                plan.maybe_raise("serve_err", stepno)
                slow_s = 0.0
                if plan.fires("serve_slow", stepno):
                    slow_s = (t.step_timeout_s or 0.05) * 5
                tc0 = t._local_clock()
                nxt, finite = self._verify_dispatch(
                    vtok, vpos, vseed, vnout, vtemp, vtopk, vtopp,
                    vpoison, vtable, slow_s)
                t1 = t._local_clock()
                t._m_lat.observe(t1 - tc0)
                if obs.enabled():
                    tracer = obs.get_tracer()
                    if tracer.enabled:
                        tracer.complete(
                            "spec_verify", "serving", tc0, t1,
                            args={"step": stepno, "active": len(active),
                                  "k": k})
                break
            except StepTimeout as e:
                t._bump("watchdog_trips")
                self._release_all_mirrors()
                return done + t._degrade(
                    f"watchdog trip at verify step {stepno}: {e}")
            except Exception as e:              # noqa: BLE001
                if _sticky_device_error(e):
                    self._release_all_mirrors()
                    return done + t._degrade(
                        f"verify step {stepno} failed with a CUDA "
                        f"error (sticky, not retryable): {e}")
                if attempt >= t.step_retries:
                    self._release_all_mirrors()
                    return done + t._degrade(
                        f"verify step {stepno} failed after "
                        f"{attempt + 1} attempt(s): {e}")
                t._bump("retries")
                if t.retry_backoff_s:
                    time.sleep(t.retry_backoff_s * (2 ** attempt))
        t._bump("decode_steps")
        self._stats["spec_rounds"] += 1

        # ---- coupled acceptance + multi-token emit + rollback ------
        now = t._clock()
        round_prop = round_acc = round_emit = 0
        for i in active:
            req = t._req[i]
            if req is None:
                continue
            h = int(horizons[i])
            base = i * (k + 1)
            toks: List[int] = []
            fins: List[bool] = []
            matched = 0
            for j in range(h + 1):
                g = int(nxt[base + j])
                fin = bool(finite[base + j])
                toks.append(g)
                fins.append(fin)
                if not fin:
                    break
                if j < h and g != int(proposals[i, j]):
                    break
                if j < h:
                    matched += 1
            t0_tok = int(t._tok[i])
            gen0 = len(t._gen[i])
            res = t._emit_multi(i, toks, fins, now)
            done.extend(res)
            round_prop += h
            round_acc += matched
            # count tokens that actually LEFT the engine (the
            # spec_verify contract): a terminal mid-list discards the
            # rest — stop_id/poisoned rows emit nothing themselves
            if t._req[i] is None:
                round_emit += (len(res[-1].tokens) - gen0) if res else 0
                # terminal mid-round: the mirror follows its request
                pois = bool(res and res[-1].status == "poisoned")
                self._release_mirror(i, poisoned=pois)
                continue
            round_emit += len(t._gen[i]) - gen0
            # surviving slot: _emit_multi advanced the target to
            # (pos0+m, e_m); truncate lookahead blocks past the clock
            # and re-point the draft shadow at the accepted sequence
            m = len(toks)
            t.rollback_slot(i)
            if m == h + 1:
                # fully accepted (+ bonus): the draft never proposed
                # the bonus, so its cache trails by one — catch up
                # next round
                self._lag[i] = 1
                d._pos[i] = int(t._pos[i]) - 1
                d._tok[i] = int(proposals[i, h - 1]) if h else t0_tok
            else:
                self._lag[i] = 0
                d._pos[i] = int(t._pos[i])
                d._tok[i] = int(t._tok[i])
            d._nout[i] = int(t._nout[i])
            d.rollback_slot(i)
        self._stats["proposed"] += round_prop
        self._stats["accepted"] += round_acc
        self._stats["wasted"] += round_prop - round_acc
        self._stats["emitted"] += round_emit
        if obs.enabled():
            self._m_accepted.inc(round_acc)
            self._m_wasted.inc(round_prop - round_acc)
        obs.emit_event("spec_verify", plane="serving",
                       engine=t.obs_name, draft_engine=d.obs_name,
                       step=stepno, active=len(active),
                       proposed=round_prop, accepted=round_acc,
                       emitted=round_emit)
        if round_prop:
            # one window observation per PROPOSING round (host ints
            # only; ungated — see the histogram's ctor comment)
            self._m_accept_frac.observe(round_acc / round_prop)
            self._rounds_windowed += 1
            self._swap_rounds += 1
        if self._pending_swap is not None \
                and self._swap_rounds >= self.adapt_window:
            self._settle_swap()
        if self._adapt and (self._suspended
                            or self._rounds_windowed >= self.adapt_window):
            # suspended probes evaluate immediately (the window holds
            # exactly the probe round); live speculation evaluates
            # every adapt_window proposing rounds
            self._evaluate_k()
        return done
