"""Fault drill — deterministic failure injection against the training
loop's recovery contract AND the serving plane's reliability layer
(reference anchor: the reference inherits its guarantees from Spark
task retry + lineage, arXiv 1804.05839 §4, and never tests them
directly — here every recovery path is exercised on demand,
reproducibly, by step number).

Ports scripts/fault_drill.py to bigdl_tpu_torch: every leg of
TRAINING_LEGS and SERVING_LEGS, on `--device` (default: the CUDA card;
`--device cpu` runs on the host; there is no fallback). Where a JAX
program drives several devices of one process, the port runs one
process a rank (parallel/launch.spawn): gloo ranks on the CPU, NCCL
ranks with one card each on CUDA (with fewer cards the mesh legs raise
and the tensor-parallel legs report `skipped`).

Training plane (--plane training): each leg a tiny MLP classification
run (8 ranks for the mesh legs, each holding one shard, as each device
of the JAX package's 8-device mesh does):

    nan_skip        guard policy 'skip_step', injected NaN batch at
                    step 4: the update is discarded ON DEVICE — weights
                    after the poisoned step are bit-identical to the
                    pre-step weights (LocalOptimizer path)
    nan_skip_mesh   same contract through DistriOptimizer's shard_map
                    step (psum'd health scalars, replicated ok)
    rollback        guard policy 'rollback', NaN at step 5: reload the
                    latest checkpoint, replay deterministically, finish
                    bit-identical to the clean run
    step_retry      injected step exception at step 5: DistriOptimizer
                    retry budget reloads the latest checkpoint and
                    replays (SURVEY.md §5.3 recovery path)
    data_retry      injected data-loader failure at stream position 5:
                    same retry path, entered from the iterator
    ckpt_torn       save aborted mid-write (crash model): the staging
                    dir is never published, latest() keeps pointing at
                    the previous checkpoint, resume is bit-identical
    ckpt_fallback   published checkpoint truncated after the fact (bit
                    rot): load() detects the checksum/zip damage and
                    falls back to the newest VALID checkpoint

Elastic-training legs (ZeRO-2 + async sharded checkpoints,
all on 8 ranks with `set_mesh(zero=2)` and
`set_checkpoint(sharded=True, async_save=True)`):

    preempt_resume  preempt@5 kills the worker (NOT retryable — the
                    in-process retry budget must re-raise it); a fresh
                    process resumes from the sharded checkpoint and
                    finishes BIT-IDENTICAL to the uninterrupted run
    ckpt_async_torn the background checkpoint writer is killed mid-
                    sharded-save: the torn units stay in the
                    .inprogress staging dir (never a latest()
                    candidate; the final dir is never created), the
                    error surfaces at the next save, and resume from
                    the previous checkpoint is bit-identical
    torn_shard      a PUBLISHED sharded checkpoint has one shard's npz
                    truncated (bit rot): per-shard crc32s catch it,
                    load() falls back to the newest valid checkpoint,
                    resume is bit-identical
    worldsize_resume an 8-shard ZeRO-2 checkpoint resumes onto a
                    4-device mesh (strip padding, re-pad, re-shard):
                    training completes finite and the resumed run is
                    bit-deterministic across two invocations (cross-
                    topology bit-identity is NOT promised — summation
                    order changes with the shard count)

Serving plane (--plane serving): each leg drives the continuous-
batching InferenceEngine (serving/engine.py) over a tiny LM
with utils/faults serving kinds injected by DECODE step number:

    serve_poison    serve_nan poisons one co-batched row's logits
                    inside the decode step: that request evicts with
                    status 'poisoned'; its co-batch AND the slot's
                    next occupant stay bit-identical to running alone
    serve_overload  bounded queue under all three overload policies:
                    reject raises, shed-oldest / shed-lowest-priority
                    shed the right victim with status 'shed'
    serve_deadline  deterministic (injected-clock) TTL expiry, both
                    while queued (0 tokens) and while decoding
                    (partial tokens kept), status 'expired'
    serve_retry     serve_err transient step failure absorbed by the
                    retry budget — output bit-identical to a clean
                    run; a PERSISTENT failure (xN) exhausts the
                    budget and degrades the engine
    serve_watchdog  serve_slow hangs the dispatch+fetch past
                    step_timeout_s: the watchdog trips, in-flight
                    requests fail with status 'failed', the engine
                    quiesces and health() reports the trip
    serve_prefix    paged KV prefix reuse: a cached-prefix
                    admission decodes BIT-IDENTICAL to its cold run
                    (in co-batch with a stranger); LRU eviction under
                    pool pressure then re-prefill stays bit-identical;
                    and a poisoned request's eviction scrubs only its
                    exclusive blocks — never a shared (refcount>1)
                    prefix block, whose live co-user finishes
                    bit-identical and whose content keeps serving hits

Fleet legs (the router/autoscaler layer above the engines,
serving/router.py + autoscaler.py):

    fleet_failover  serve_slow trips the watchdog on engine 0 of a
                    2-engine router MID-DECODE: every request it held
                    (in-flight and queued) fails over to engine 1 and
                    completes with tokens BIT-IDENTICAL to an
                    undisturbed single-engine run — zero requests lost
    fleet_drain     drain one engine mid-traffic: its accepted work
                    finishes normally ('draining'→'drained'), direct
                    submit raises EngineDraining, new traffic routes
                    to the survivor, and the drained engine leaves the
                    pool without losing a request
    fleet_autoscale the same deterministic loadgen burst against a
                    fixed 1-engine pool (violates the p99 target) and
                    an autoscaled pool (grows to 3, rebalances the
                    backlog, holds the target) — decision sequence and
                    load report bit-identical across runs
    fleet_tp_failover the fleet_failover invariant ACROSS
                    sharding layouts: the watchdog-tripped engine is
                    tensor-parallel (tp=2 over 2 ranks, each running
                    the leg), the survivor is UNSHARDED — rerouted
                    tokens must still be bit-identical to the
                    undisturbed run, because sharded decode is bitwise
                    == unsharded decode (serving/tp.py). Needs 2 ranks'
                    devices (2 cards under --device cuda); reports
                    skipped=... on fewer. It also pins the journey
                    layer here: ONE
                    reconstructed cross-layout journey per rerouted
                    request, zero lost hops, transitional 'failed'
                    terminals superseded
    slo_alert       the live SLO plane: a queueing burst
                    against a 1-engine pool burns a p99 objective
                    under a virtual clock — the burn-rate alert fires
                    deterministically (alert_firing), the installed
                    FlightRecorder dumps ONE slo_burn bundle naming
                    the breached window, a recovery trickle measures
                    healthy through clear_s and the alert resolves
                    (alert_resolved); two runs byte-identical in
                    report AND bundle bytes
    fleet_journey   the observability plane against the
                    full fleet: disaggregated prefill (pf0) + tp=2
                    'e0' + unsharded 'e1' under one virtual clock
                    injected everywhere (engines, router, event log,
                    registry, flight recorder); serve_slow@2 trips
                    e0's watchdog mid-decode. Pins: one journey per
                    request with zero lost hops (handoff hops seated
                    via handoff_import, failover hops crossing tp
                    layouts), the watchdog trip dumps exactly one
                    flight-recorder bundle whose event tail names the
                    failing decode step, and TWO runs produce
                    byte-identical journey JSON and bundle files

Every training leg compares parameters BIT-FOR-BIT against an
uninterrupted reference run (same init, same deterministic batch
stream, same rng folding); every serving leg compares generated
TOKENS bit-for-bit against a clean or run-alone reference — so
"recovered"/"isolated" means "indistinguishable from never having
failed", not merely "didn't crash".

drill outcomes are asserted against the unified telemetry
plane — every leg runs under a fresh event log + metrics registry
(`_telemetry()`), and "the fault fired / the guard acted / the request
reached status X" is read from structured events (fault_injected,
anomaly, checkpoint_*, request_terminal, engine_degraded), not from
stdout or private state. Each leg's JSON gains an `events` section
(counts by kind) so the machine-readable drill record is
self-describing.

Usage:
    python -m bigdl_tpu_torch.scripts.fault_drill   # all legs, the card
    ... fault_drill --plane serving                 # serving legs only
    ... fault_drill --legs nan_skip,serve_poison --device cpu

Tests: tests/test_torch_fleet_drills*.py and
tests/test_torch_training_drills*.py hold every leg to the JAX
package's on the CPU.
"""

from __future__ import annotations

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np

from bigdl_tpu_torch.scripts import loadgen

# where the legs run, and the weights they start from: None draws each
# model's weights from its torch.Generator seed; the CPU tests hand in
# the JAX package's (host arrays) through configure()
_DEVICE = "cuda"
_WEIGHTS: dict = {}
_SIM_COST = None
MESH_WORLD = 8          # the JAX package's CPU mesh: one rank a device
TP_WORLD = 2
TRAIN_SEED, SERVE_SEED, DRAFT_SEED = 3, 0, 7


def configure(device="cuda", *, train=None, lm=None, draft=None,
              sim_cost=None) -> None:
    """Set the device every leg runs on and, optionally, the initial
    weights of the drill MLP (`train`), the serving LM (`lm`) and its
    speculative draft (`draft`) as host-array trees, and the CostModel
    of scenario_chaos (`sim_cost`; default CostModel.default()).
    Clears the cached serving models."""
    global _DEVICE, _SIM_COST, _SERVE_LM, _SERVE_DRAFT_LM
    _DEVICE = str(device)
    _WEIGHTS.clear()
    _WEIGHTS.update({k: v for k, v in (("train", train), ("lm", lm),
                                       ("draft", draft)) if v is not None})
    _SIM_COST = sim_cost
    _SERVE_LM = _SERVE_DRAFT_LM = None


def _state() -> dict:
    """configure()'s arguments, for the ranks a leg spawns."""
    return dict(device=_DEVICE, sim_cost=_SIM_COST, **_WEIGHTS)


def _flat(model):
    return np.concatenate([np.ravel(a.detach().float().cpu().numpy())
                           for _, a in model.parameters()])


def _train(workdir, end_iter, *, faults="", guard=None, mesh=False,
           ckpt_iter=None, resume=False, tag="run", zero=1,
           sharded=False, async_save=False, mesh_devices=None):
    """One training run under an injection plan; returns (flat params,
    the Optimizer, the consumed FaultPlan) so legs can inspect guard
    stats / checkpoint state / which shots actually fired.
    The plan is installed fresh per run — one-shot budgets never leak
    across runs, which is what makes every leg reproducible.
    `zero`/`sharded`/`async_save` arm the elastic-training
    plane; `mesh_devices` names the world size a mesh run expects (the
    world-size-change resume leg's 4-rank group)."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.convert import params_from_jax
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils import faults as faults_mod

    rng = np.random.RandomState(11)
    samples = [Sample(rng.rand(6).astype(np.float32),
                      int(rng.randint(0, 4))) for _ in range(64)]
    model = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4),
                          nn.LogSoftMax())
    if "train" in _WEIGHTS:
        model.variables = {"params": params_from_jax(_WEIGHTS["train"],
                                                     device=_DEVICE),
                           "state": model.init_state()}
    else:
        model.build(torch.Generator().manual_seed(TRAIN_SEED),
                    device=_DEVICE)
    opt = (Optimizer(model, DataSet.array(samples),
                     nn.ClassNLLCriterion(), batch_size=8)
           .set_optim_method(Adam(learningrate=1e-2))
           .set_end_when(Trigger.max_iteration(end_iter)))
    if guard is not None:
        opt.set_anomaly_guard(guard)
    if ckpt_iter is not None:
        opt.set_checkpoint(os.path.join(workdir, tag),
                           Trigger.several_iteration(ckpt_iter),
                           sharded=sharded, async_save=async_save)
    if resume:
        opt.resume_from_checkpoint()
    m = None
    if mesh or mesh_devices:
        # the data axis spans the process group: the spawned ranks of a
        # mesh leg, or one rank in a lone process
        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh_devices and mesh_devices != world:
            raise ValueError(f"mesh_devices={mesh_devices} needs a group "
                             f"of that many ranks, not {world}")
        m = make_mesh({"data": world}, device=_DEVICE)
        opt.set_mesh(m, zero=zero)
    faults_mod.set_plan(faults_mod.FaultPlan(faults))
    try:
        trained = opt.optimize()
    finally:
        plan = faults_mod.get_plan()
        faults_mod.set_plan(None)
        if m is not None:
            m.close()                   # a group it opened, not spawn's
    return _flat(trained), opt, plan


@contextlib.contextmanager
def _telemetry(clock=None):
    """Fresh event log + metrics registry for one drilled run, so the
    leg's assertions read exactly that run's telemetry; both are
    restored to fresh defaults afterwards (no cross-leg leakage). The
    captured log stays readable through the yielded reference.
    Telemetry is force-ENABLED for the drilled run (and the previous
    switch state restored): the drills assert on events, so they must
    opt in even when the surrounding process runs BIGDL_OBS=off. `clock`
    injects the drill's virtual clock into registry, event
    log AND tracer, so event `ts` stamps — and therefore journey and
    flight-recorder bundle bytes — are identical across two runs."""
    from bigdl_tpu_torch import obs

    prev = obs.set_enabled(True)
    obs.reset_all(clock)
    try:
        yield obs.get_event_log()
    finally:
        obs.reset_all()
        obs.set_enabled(prev)


# ------------------------------------------------------------------ legs

def drill_nan_skip(workdir, mesh=False):
    """NaN batch at step 4 under 'skip_step': weights after the poisoned
    step must be bit-identical to the PRE-step weights (= a clean run
    stopped just before it), and the guard must have counted it.

    The reference runs with the guard ARMED too, as the JAX package's
    does (there arming it compiles a different graph, which shifts
    healthy-step float results at the ulp level): the guard's
    bit-identity promise is against the same armed step, not against
    an unguarded run."""
    ref, _, _ = _train(workdir, end_iter=4, guard="skip_step", mesh=mesh,
                       tag="nsr")
    with _telemetry() as log:
        got, opt, plan = _train(workdir, end_iter=5, faults="nan@4",
                                guard="skip_step", mesh=mesh, tag="nsf")
    g = opt.anomaly_guard
    injected = log.events("fault_injected", fault="nan", step=4)
    skipped = log.events("anomaly", action="skipped", step=4)
    steps = log.events("train_step")
    return {"ok": bool(np.array_equal(ref, got)) and g.skipped == 1
            and len(injected) == 1 and len(skipped) == 1
            and len(steps) == 5
            # the poisoned iteration is the last one (neval 4 at
            # consult time → train_step event step=5): its update was
            # discarded on device
            and not steps[-1]["update_applied"]
            and all(s["update_applied"] for s in steps[:-1]),
            "bit_identical_to_pre_step": bool(np.array_equal(ref, got)),
            "guard": g.stats(), "events": log.counts_by_kind()}


def drill_rollback(workdir):
    """NaN at step 5 under 'rollback': reload checkpoint-3, replay the
    stream deterministically (one-shot fault does not re-fire), finish
    bit-identical to the uninterrupted run (which also runs armed —
    see drill_nan_skip on why the reference must share the guard's
    compiled graph)."""
    ref, _, _ = _train(workdir, end_iter=8, guard="rollback", ckpt_iter=3,
                       tag="rbr")
    with _telemetry() as log:
        got, opt, plan = _train(workdir, end_iter=8, faults="nan@5",
                                guard="rollback", ckpt_iter=3, tag="rbf")
    g = opt.anomaly_guard
    injected = log.events("fault_injected", fault="nan", step=5)
    rolled = log.events("anomaly", action="rollback", step=5)
    reloads = log.events("checkpoint_load")
    return {"ok": bool(np.array_equal(ref, got)) and g.rollbacks == 1
            and len(injected) == 1 and len(rolled) == 1
            and len(reloads) == 1,         # the rollback reload itself
            "bit_identical": bool(np.array_equal(ref, got)),
            "guard": g.stats(), "events": log.counts_by_kind()}


def drill_step_retry(workdir):
    """Step exception at step 5 on the mesh path: the DistriOptimizer
    retry budget reloads checkpoint-3 and replays to a bit-identical
    finish (the reference's reload-last-checkpoint recovery)."""
    ref, _, _ = _train(workdir, end_iter=8, mesh=True, tag="srr")
    with _telemetry() as log:
        got, _, plan = _train(workdir, end_iter=8, faults="step@5",
                              mesh=True, ckpt_iter=3, tag="srf")
    injected = log.events("fault_injected", fault="step", step=5)
    reloads = log.events("checkpoint_load")
    return {"ok": bool(np.array_equal(ref, got))
            and len(injected) == 1 and len(reloads) == 1,
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind()}


def drill_data_retry(workdir):
    """Data-loader failure at stream position 5: enters the same retry
    path from the batch iterator instead of the step dispatch."""
    ref, _, _ = _train(workdir, end_iter=8, mesh=True, tag="drr")
    with _telemetry() as log:
        got, _, plan = _train(workdir, end_iter=8, faults="data@5",
                              mesh=True, ckpt_iter=3, tag="drf")
    injected = log.events("fault_injected", fault="data", step=5)
    reloads = log.events("checkpoint_load")
    return {"ok": bool(np.array_equal(ref, got))
            and len(injected) == 1 and len(reloads) == 1,
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind()}


def drill_ckpt_torn(workdir):
    """Crash mid-checkpoint-write at step 4 (staging dir half-written,
    never published): the process dies; latest() must keep pointing at
    checkpoint-2, the torn leftovers must never surface, and the resume
    finishes bit-identical."""
    from bigdl_tpu_torch.utils.faults import FaultInjected

    ref, _, _ = _train(workdir, end_iter=6, tag="ctr")
    died = False
    with _telemetry() as log:
        try:
            _train(workdir, end_iter=6, faults="ckpt_torn@4",
                   ckpt_iter=2, tag="ctf")
        except FaultInjected:
            died = True  # the modeled crash
    ckdir = os.path.join(workdir, "ctf")
    leftovers = [d for d in os.listdir(ckdir) if d.endswith(".inprogress")]
    # the torn save fired AND never published: a fault_injected event
    # with no checkpoint_save for that step
    torn = log.events("fault_injected", fault="ckpt_torn", step=4)
    torn_saves = [e for e in log.events("checkpoint_save")
                  if e["step"] == 4]
    with _telemetry() as rlog:
        got, opt, _ = _train(workdir, end_iter=6, ckpt_iter=2,
                             resume=True, tag="ctf")
    resumed = rlog.events("checkpoint_load")
    latest = opt.checkpoint.latest()
    return {"ok": died and bool(leftovers) and len(torn) == 1
            and not torn_saves and len(resumed) == 1
            and bool(np.array_equal(ref, got)),
            "crashed_mid_write": died, "staging_leftovers": leftovers,
            "latest_after_resume": os.path.basename(latest or ""),
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind(),
            "resume_events": rlog.counts_by_kind()}


def drill_ckpt_fallback(workdir):
    """checkpoint-6 published then truncated (bit-rot model): the resume
    must DETECT the damage (checksums / zip structure), skip the dir,
    fall back to checkpoint-3, and still finish bit-identical."""
    ref, _, _ = _train(workdir, end_iter=9, tag="cfr")
    _train(workdir, end_iter=7, faults="ckpt_corrupt@6", ckpt_iter=3,
           tag="cff")
    with _telemetry() as log:
        got, opt, _ = _train(workdir, end_iter=9, ckpt_iter=3,
                             resume=True, tag="cff")
    skipped_ev = log.events("checkpoint_corrupt_skipped")
    loaded_ev = log.events("checkpoint_load")
    skipped = [os.path.basename(e["path"]) for e in skipped_ev]
    resumed_from = os.path.basename(loaded_ev[0]["path"]) \
        if loaded_ev else ""
    return {"ok": "checkpoint-6" in skipped
            and resumed_from == "checkpoint-3"
            and bool(np.array_equal(ref, got)),
            "corrupt_skipped": skipped,
            "resumed_from": resumed_from,
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind()}


# --------------------------------------------------- elastic-training legs
# every leg runs the ZeRO-2 mesh step with sharded async
# checkpoints — the full preemption-tolerant training plane, not a
# simplified stand-in. References share the same compiled graph
# (zero=2) so bit-identity compares like with like.

def drill_preempt_resume(workdir):
    """preempt@5 kills the worker: the DistriOptimizer retry budget
    must RE-RAISE it (a preempted worker is dead, not a transient step
    failure — no in-process checkpoint reload), and a fresh process
    resuming from the sharded checkpoint finishes bit-identical to the
    uninterrupted run."""
    from bigdl_tpu_torch.utils.faults import Preempted

    ref, _, _ = _train(workdir, end_iter=8, mesh=True, zero=2, tag="per")
    died = False
    with _telemetry() as log:
        try:
            _train(workdir, end_iter=8, faults="preempt@5", mesh=True,
                   zero=2, ckpt_iter=3, sharded=True, async_save=True,
                   tag="pef")
        except Preempted:
            died = True  # the modeled worker kill
    injected = log.events("fault_injected", fault="preempt", step=5)
    absorbed = log.events("checkpoint_load")   # retry must NOT have run
    saves = [e for e in log.events("checkpoint_save") if "shard" not in e]
    with _telemetry() as rlog:
        got, opt, _ = _train(workdir, end_iter=8, mesh=True, zero=2,
                             ckpt_iter=3, sharded=True, async_save=True,
                             resume=True, tag="pef")
    resumed = rlog.events("checkpoint_load")
    return {"ok": died and len(injected) == 1 and not absorbed
            and len(saves) == 1 and saves[0]["async"]
            and saves[0]["nshards"] == 8
            and len(resumed) == 1 and resumed[0].get("sharded") is True
            and bool(np.array_equal(ref, got)),
            "died_unretried": died and not absorbed,
            "bit_identical": bool(np.array_equal(ref, got)),
            "resumed_from": os.path.basename(resumed[0]["path"])
            if resumed else "",
            "events": log.counts_by_kind(),
            "resume_events": rlog.counts_by_kind()}


def drill_ckpt_async_torn(workdir):
    """The background checkpoint writer is killed mid-sharded-save
    (ckpt_async_torn@4): the torn dir holds shard units but no
    MANIFEST.json, so it never becomes a latest() candidate; the
    stored writer error surfaces at the next save (failing the run —
    a dead writer must not pass silently); resume falls back to the
    previous checkpoint and finishes bit-identical."""
    from bigdl_tpu_torch.utils.faults import FaultInjected

    ref, _, _ = _train(workdir, end_iter=6, mesh=True, zero=2, tag="atr")
    died = False
    with _telemetry() as log:
        try:
            _train(workdir, end_iter=6, faults="ckpt_async_torn@4",
                   mesh=True, zero=2, ckpt_iter=2, sharded=True,
                   async_save=True, tag="atf")
        except FaultInjected:
            died = True  # surfaced from the writer thread
    # the writer died in the staging dir: checkpoint-4 itself must not
    # exist (the swap never happened), the torn units sit in
    # checkpoint-4.inprogress where latest() can never see them
    torn_dir = os.path.join(workdir, "atf", "checkpoint-4")
    torn_is_unpublished = (not os.path.isdir(torn_dir)
                           and os.path.isdir(torn_dir + ".inprogress"))
    injected = log.events("fault_injected", fault="ckpt_async_torn",
                          step=4)
    # per-shard saves for step 4 started, but the publish event never
    # fired (the final checkpoint_save record carries no "shard" field)
    shard_saves_4 = [e for e in log.events("checkpoint_save", step=4)
                     if "shard" in e]
    final_saves_4 = [e for e in log.events("checkpoint_save", step=4)
                     if "shard" not in e]
    with _telemetry() as rlog:
        got, opt, _ = _train(workdir, end_iter=6, mesh=True, zero=2,
                             ckpt_iter=2, sharded=True, async_save=True,
                             resume=True, tag="atf")
    resumed = rlog.events("checkpoint_load")
    resumed_from = os.path.basename(resumed[0]["path"]) if resumed else ""
    return {"ok": died and torn_is_unpublished and len(injected) == 1
            and len(shard_saves_4) >= 1 and not final_saves_4
            and resumed_from == "checkpoint-2"
            and bool(np.array_equal(ref, got)),
            "writer_died": died,
            "torn_never_published": torn_is_unpublished,
            "resumed_from": resumed_from,
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind(),
            "resume_events": rlog.counts_by_kind()}


def drill_torn_shard(workdir):
    """checkpoint-6 publishes, then ONE optim shard's npz is truncated
    (bit-rot model, ckpt_corrupt on the sharded path): the per-shard
    crc32 manifest catches it, load() skips the dir and falls back to
    checkpoint-3, and the resume still finishes bit-identical."""
    ref, _, _ = _train(workdir, end_iter=9, mesh=True, zero=2, tag="tsr")
    _train(workdir, end_iter=7, faults="ckpt_corrupt@6", mesh=True,
           zero=2, ckpt_iter=3, sharded=True, async_save=True, tag="tsf")
    with _telemetry() as log:
        got, opt, _ = _train(workdir, end_iter=9, mesh=True, zero=2,
                             ckpt_iter=3, sharded=True, async_save=True,
                             resume=True, tag="tsf")
    skipped_ev = log.events("checkpoint_corrupt_skipped")
    loaded_ev = log.events("checkpoint_load")
    skipped = [os.path.basename(e["path"]) for e in skipped_ev]
    resumed_from = os.path.basename(loaded_ev[0]["path"]) \
        if loaded_ev else ""
    return {"ok": "checkpoint-6" in skipped
            and resumed_from == "checkpoint-3"
            and bool(np.array_equal(ref, got)),
            "corrupt_skipped": skipped,
            "resumed_from": resumed_from,
            "bit_identical": bool(np.array_equal(ref, got)),
            "events": log.counts_by_kind()}


def drill_worldsize_resume(workdir):
    """An 8-shard ZeRO-2 sharded checkpoint resumes onto a 4-rank
    mesh: the flat slot vectors are re-concatenated, stripped of the
    old padding and re-padded for the new world size (padded length
    actually CHANGES for this model: 184 -> 180). Cross-topology
    bit-identity is not promised (summation order changes with the
    shard count); what IS pinned: the resume completes finite, loads
    the 8-shard checkpoint, and two identical resumed runs are
    bit-identical to each other.

    A port mesh spans its process group, so the leg is two spawns from
    here: MESH_WORLD ranks save, then 4 ranks resume twice (rank 0's
    parameters and telemetry)."""
    import json as _json

    _spawn("_worldsize_save_rank", MESH_WORLD, workdir)
    got1, got2, resumed, counts = _spawn("_worldsize_resume_rank", 4,
                                         workdir)[0]
    manifest = os.path.join(workdir, "wsr", "checkpoint-6",
                            "MANIFEST.json")
    with open(manifest) as f:
        man = _json.load(f)
    resharded = (man["nshards"] == 8
                 and man["optim_meta"]["padded"] != man["optim_meta"]
                 ["total"])  # old padding really was stripped on resume
    return {"ok": bool(np.isfinite(got1).all()) and resharded
            and len(resumed) == 1 and resumed[0].get("nshards") == 8
            and bool(np.array_equal(got1, got2)),
            "saved_shards": man["nshards"],
            "resumed_mesh_devices": 4,
            "finite": bool(np.isfinite(got1).all()),
            "deterministic_across_runs": bool(np.array_equal(got1, got2)),
            "events": counts}


def _worldsize_save_rank(workdir):
    _train(workdir, end_iter=6, mesh=True, zero=2, ckpt_iter=3,
           sharded=True, async_save=True, tag="wsr")


def _worldsize_resume_rank(workdir):
    # ckpt_iter=100: the resumed runs never re-save, so BOTH resume
    # from the same 8-shard checkpoint-6 (a re-save by run 1 would
    # hand run 2 a different, 4-shard starting point)
    with _telemetry() as log:
        got1, opt, _ = _train(workdir, end_iter=10, mesh_devices=4,
                              zero=2, ckpt_iter=100, sharded=True,
                              async_save=True, resume=True, tag="wsr")
    resumed = log.events("checkpoint_load")
    counts = log.counts_by_kind()
    got2, _, _ = _train(workdir, end_iter=10, mesh_devices=4, zero=2,
                        ckpt_iter=100, sharded=True, async_save=True,
                        resume=True, tag="wsr")
    return got1, got2, resumed, counts


# ------------------------------------------------------- spawned ranks

def _spawn(body: str, world: int, workdir: str, *args) -> list:
    """Run `body(workdir, *args)` (a function of this module, by name)
    on every rank of a fresh `world`-rank group, configured as this
    process is; the ranks' results in rank order. gloo ranks on the
    CPU; on CUDA an NCCL group, one card a rank (raises with fewer)."""
    import importlib

    from bigdl_tpu_torch.parallel.launch import spawn

    # by module name, so the ranks can import it when this file runs as
    # the __main__ of `python -m`
    me = importlib.import_module("bigdl_tpu_torch.scripts.fault_drill")
    os.makedirs(workdir, exist_ok=True)
    rdir = tempfile.mkdtemp(prefix=f"{body}_", dir=workdir)
    backend = "nccl" if _DEVICE.startswith("cuda") else "gloo"
    return spawn(me._rank_call, world, rdir, _state(), body, workdir,
                 *args, timeout=600, backend=backend)


def _rank_call(rank, world, state, body, workdir, *args):
    configure(**state)
    return globals()[body](workdir, *args)


def run_mesh_legs(legs, workdir) -> dict:
    """The mesh legs `legs`, in order, on one MESH_WORLD-rank group
    (each rank holding one shard), each under workdir/<leg>; {leg:
    digest}. A digest is rank 0's, its checkpoint_save counts summed
    over the ranks (each rank records the shard units it writes; the
    JAX package's one process records all of them)."""
    legs = list(legs)
    runs = _spawn("_mesh_legs_rank", MESH_WORLD, workdir, legs)
    out = {}
    for leg in legs:
        got = dict(runs[0][leg])
        for key in ("events", "resume_events"):
            if key in got and "checkpoint_save" in got[key]:
                got[key] = dict(got[key], checkpoint_save=sum(
                    r[leg][key].get("checkpoint_save", 0) for r in runs))
        out[leg] = got
    return out


def _mesh_legs_rank(workdir, legs):
    return {leg: _MESH_BODIES[leg](os.path.join(workdir, leg))
            for leg in legs}


def _mesh_leg(leg):
    def run(workdir):
        return run_mesh_legs([leg], workdir)[leg]

    return run


def _tp_skip():
    """Why the tensor-parallel legs cannot run here, or None."""
    if _DEVICE.startswith("cuda"):
        import torch

        have = torch.cuda.device_count()
        if have < TP_WORLD:
            return (f"needs {TP_WORLD} ranks' devices, one CUDA card a "
                    f"rank; torch sees {have}")
    return None


def _spmd_leg(body, workdir):
    skip = _tp_skip()
    if skip is not None:
        return {"ok": True, "skipped": skip}
    return _spawn(body, TP_WORLD, workdir)[0]


# ---------------------------------------------------------- serving legs

# one tiny LM shared by every serving leg (loadgen.LM_CONFIG: head dim
# 16, the paged-decode kernel's D = 16 on the card): engines over the
# same model object share its weights and serving layout
_SERVE_LM = None


def _serve_lm():
    global _SERVE_LM
    if _SERVE_LM is None:
        _SERVE_LM = loadgen.tiny_lm(loadgen.LM_CONFIG, SERVE_SEED, 64,
                                    _DEVICE, _WEIGHTS.get("lm"))
    return _SERVE_LM


def _engine(**kw):
    from bigdl_tpu_torch.serving import InferenceEngine

    kw.setdefault("slots", 2)
    kw.setdefault("prefill_buckets", (8,))
    kw.setdefault("device", _DEVICE)
    return InferenceEngine(_serve_lm(), **kw)


# a second tiny LM for the speculative legs' DRAFT engine
# (loadgen.DRAFT_CONFIG: head dim 8), shared like _SERVE_LM
_SERVE_DRAFT_LM = None


def _serve_draft_lm():
    global _SERVE_DRAFT_LM
    if _SERVE_DRAFT_LM is None:
        _SERVE_DRAFT_LM = loadgen.tiny_lm(
            loadgen.DRAFT_CONFIG, DRAFT_SEED, 64, _DEVICE,
            _WEIGHTS.get("draft"))
    return _SERVE_DRAFT_LM


def _draft_engine(**kw):
    from bigdl_tpu_torch.serving import InferenceEngine

    return InferenceEngine(_serve_draft_lm(), slots=2,
                           prefill_buckets=(8,), device=_DEVICE, **kw)


def _req(**kw):
    from bigdl_tpu_torch.serving import Request

    kw.setdefault("max_new_tokens", 5)
    return Request(**kw)


def _plan(spec):
    from bigdl_tpu_torch.utils import faults as fm

    fm.set_plan(fm.FaultPlan(spec))
    return fm


def drill_serve_poison(workdir):
    """serve_nan at decode step 2 poisons slot 0 (request A) inside the
    decode step: A evicts with status 'poisoned' after its 2 clean
    tokens; co-batched B's tokens are BIT-IDENTICAL to running B alone,
    and a follow-up request through A's recycled slot is bit-identical
    too (slot scrub + masked-row nan hygiene in cached_attention)."""
    A = dict(prompt=[1, 2, 3], max_new_tokens=6, temperature=0.8, seed=5)
    B = dict(prompt=[4, 5, 6, 7], max_new_tokens=6, temperature=0.9,
             seed=9)
    alone_b = _engine().run([_req(**B)])[0]
    alone_a2 = _engine().run([_req(**A)])[0]     # reuse-probe reference

    fm = _plan("serve_nan@2")
    try:
        with _telemetry() as log:
            eng = _engine()
            got_a, got_b = eng.run([_req(**A), _req(**B)])
            # slot 0 (A's) was poisoned and scrubbed — reuse it
            reuse = eng.run([_req(**A)])[0]
    finally:
        fm.set_plan(None)
    injected = log.events("fault_injected", fault="serve_nan", step=2)
    poisoned = log.events("request_terminal", status="poisoned")
    done = log.events("request_terminal", status="done")
    ok = (got_a.status == "poisoned" and len(got_a.tokens) == 2
          and got_b.status == "done" and got_b.tokens == alone_b.tokens
          and reuse.tokens == alone_a2.tokens
          and len(injected) == 1
          and len(poisoned) == 1 and poisoned[0]["tokens"] == 2
          and len(done) == 2)                # co-batch B + reuse probe
    return {"ok": bool(ok), "poisoned_status": got_a.status,
            "poisoned_tokens_kept": len(got_a.tokens),
            "cobatch_bit_identical": got_b.tokens == alone_b.tokens,
            "slot_reuse_bit_identical": reuse.tokens == alone_a2.tokens,
            "events": log.counts_by_kind()}


def drill_serve_overload(workdir):
    """Bounded queue, all three policies: reject raises OverloadError;
    shed-oldest evicts the longest-queued request; shed-lowest-priority
    evicts the lowest priority (or the newcomer when IT is lowest)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.serving import OverloadError

    with _telemetry() as log:
        # reject
        e1 = _engine(max_queue=1, overload_policy="reject")
        e1.submit(_req(prompt=[1, 2]))
        rejected = False
        try:
            e1.submit(_req(prompt=[3, 4]))
        except OverloadError:
            rejected = True
        # shed-oldest
        e2 = _engine(max_queue=2, overload_policy="shed-oldest")
        old = e2.submit(_req(prompt=[1, 2], seed=1))
        e2.submit(_req(prompt=[3, 4], seed=2))
        e2.submit(_req(prompt=[5, 6], seed=3))       # sheds `old`
        shed_oldest = (old in e2.completed
                       and e2.completed[old].status == "shed")
        done2 = e2.run()
        # shed-lowest-priority: queued low-priority victim...
        e3 = _engine(max_queue=2,
                     overload_policy="shed-lowest-priority")
        low = e3.submit(_req(prompt=[1, 2], priority=1))
        e3.submit(_req(prompt=[3, 4], priority=5))
        e3.submit(_req(prompt=[5, 6], priority=3))   # sheds `low`
        shed_low = (low in e3.completed
                    and e3.completed[low].status == "shed")
        # ...and the newcomer itself when IT is the lowest
        new = e3.submit(_req(prompt=[7, 8], priority=0))
        shed_new = (new in e3.completed
                    and e3.completed[new].status == "shed")
        e3.run()
        # outcomes from the telemetry plane: one rejection event,
        # three shed terminals, and the registry mirrors of the same
        # counters (snapshot INSIDE the capture — its exit restores a
        # fresh registry)
        snap = obs.get_registry().snapshot()["metrics"]
    shed_ev = log.events("request_terminal", status="shed")
    rej_ev = log.events("request_rejected")
    shed_reg = sum(
        s["value"] for s in snap.get("serving_requests_total",
                                     {"series": []})["series"]
        if s["labels"].get("status") == "shed")
    ok = (rejected and len(rej_ev) == 1
          and shed_oldest and shed_low and shed_new
          and len(shed_ev) == 3 and shed_reg == 3
          and all(r.status == "done" for r in done2
                  if r.status != "shed"))
    return {"ok": bool(ok), "rejected": rejected,
            "shed_oldest": shed_oldest, "shed_lowest": shed_low,
            "shed_new_lowest": shed_new,
            "shed_events": len(shed_ev),
            "shed_counter": shed_reg,
            "events": log.counts_by_kind()}


def drill_serve_deadline(workdir):
    """Injected-clock TTL expiry — bit-deterministic on CPU: a queued
    request expires with 0 tokens while both slots are busy; a decoding
    request expires mid-generation keeping its partial tokens."""
    clk = {"t": 0.0}
    with _telemetry() as log:
        # expiry while QUEUED: both slots busy with 8-token requests,
        # the queued request's 3 s TTL passes at 1 s/step
        eng = _engine(clock=lambda: clk["t"])
        eng.submit(_req(prompt=[1, 2], max_new_tokens=8, seed=1))
        eng.submit(_req(prompt=[3, 4], max_new_tokens=8, seed=2))
        qid = eng.submit(_req(prompt=[5, 6], deadline_s=3.0))
        while eng._queue or any(r is not None for r in eng._req):
            for res in eng.step():
                eng.completed[res.id] = res
            clk["t"] += 1.0
        queued_exp = eng.completed[qid]
        # expiry while DECODING: deadline 2 s passes after the 3rd
        # token
        clk["t"] = 0.0
        eng2 = _engine(clock=lambda: clk["t"])
        did = eng2.submit(_req(prompt=[1, 2, 3], max_new_tokens=8,
                               deadline_s=2.0))
        while eng2._queue or any(r is not None for r in eng2._req):
            for res in eng2.step():
                eng2.completed[res.id] = res
            clk["t"] += 1.0
        dec_exp = eng2.completed[did]
    expired = log.events("request_terminal", status="expired")
    ok = (queued_exp.status == "expired" and queued_exp.tokens == []
          and dec_exp.status == "expired" and len(dec_exp.tokens) == 3
          and len(expired) == 2
          and sorted(e["tokens"] for e in expired) == [0, 3])
    return {"ok": bool(ok), "queued_status": queued_exp.status,
            "queued_tokens": len(queued_exp.tokens),
            "decoding_status": dec_exp.status,
            "decoding_tokens_kept": len(dec_exp.tokens),
            "events": log.counts_by_kind()}


def drill_serve_retry(workdir):
    """serve_err at decode step 1: one retry redispatches and the run
    finishes BIT-IDENTICAL to an uninjected run (the transient model);
    a persistent serve_err@1x3 exhausts a 1-retry budget and degrades
    the engine with every in-flight request 'failed'."""
    A = dict(prompt=[1, 2, 3], max_new_tokens=5, temperature=0.7, seed=3)
    ref = _engine().run([_req(**A)])[0]
    fm = _plan("serve_err@1")
    try:
        with _telemetry() as log:
            eng = _engine(step_retries=1, retry_backoff_s=0.0)
            got = eng.run([_req(**A)])[0]
    finally:
        fm.set_plan(None)
    transient_ok = (got.status == "done" and got.tokens == ref.tokens
                    and eng.stats["retries"] == 1
                    and len(log.events("fault_injected",
                                       fault="serve_err", step=1)) == 1
                    and len(log.events("request_terminal",
                                       status="done")) == 1
                    and not log.events("engine_degraded"))
    fm = _plan("serve_err@1x3")
    try:
        with _telemetry() as log2:
            eng2 = _engine(step_retries=1, retry_backoff_s=0.0)
            got2 = eng2.run([_req(**A)])[0]
    finally:
        fm.set_plan(None)
    degraded_ev = log2.events("engine_degraded")
    persistent_ok = (got2.status == "failed" and len(got2.tokens) == 1
                     and len(degraded_ev) == 1
                     and len(log2.events("request_terminal",
                                         status="failed")) == 1
                     and eng2.stats["retries"] == 1)
    return {"ok": bool(transient_ok and persistent_ok),
            "transient_bit_identical": got.tokens == ref.tokens,
            "retries": eng.stats["retries"],
            "persistent_status": got2.status,
            "persistent_degraded": bool(degraded_ev),
            "events": log.counts_by_kind(),
            "persistent_events": log2.counts_by_kind()}


def drill_serve_watchdog(workdir):
    """serve_slow at decode step 1 under a 50 ms watchdog: the hung
    dispatch+fetch becomes a StepTimeout, in-flight requests fail with
    status 'failed' (keeping the deterministic token from step 0), the
    engine quiesces (submit raises EngineDegraded) and health()
    records the trip."""
    from bigdl_tpu_torch.serving import EngineDegraded

    A = dict(prompt=[1, 2, 3], max_new_tokens=5, seed=1)
    B = dict(prompt=[4, 5, 6, 7], max_new_tokens=5, seed=2)
    ref = _engine().run([_req(**A)])[0]          # clean tokens oracle
    fm = _plan("serve_slow@1")
    try:
        with _telemetry() as log:
            eng = _engine(step_timeout_s=0.05)
            got = eng.run([_req(**A), _req(**B)])
    finally:
        fm.set_plan(None)
    h = eng.health()
    quiesced = False
    try:
        eng.submit(_req(prompt=[1]))
    except EngineDegraded:
        quiesced = True
    degraded_ev = log.events("engine_degraded")
    failed_ev = log.events("request_terminal", status="failed")
    ok = (all(r.status == "failed" for r in got)
          and got[0].tokens == ref.tokens[:1]    # step-0 token kept
          and h["state"] == "degraded" and h["watchdog_trips"] == 1
          and len(degraded_ev) == 1
          and "watchdog" in degraded_ev[0]["reason"]
          and len(failed_ev) == 2
          and quiesced)
    return {"ok": bool(ok),
            "statuses": [r.status for r in got],
            "tokens_before_trip": [len(r.tokens) for r in got],
            "watchdog_trips": h["watchdog_trips"], "state": h["state"],
            "quiesced": quiesced,
            "events": log.counts_by_kind()}


def drill_serve_prefix(workdir):
    """Paged KV cache + radix prefix reuse, three checks on
    block_size=4 engines under an injected clock, all asserted from
    obs events/counters:

    (1) warm-vs-cold bit-identity: the same prompt resubmitted hits
        the radix cache (prefix_hit event, serving_prefix_* counters)
        and — co-batched with a stranger — decodes tokens
        bit-identical to the cold run;
    (2) eviction-then-reuse: a deliberately tiny pool forces LRU
        eviction of the cached prefix (prefix_evict event,
        pool_evictions counter); resubmitting re-prefills cold and is
        STILL bit-identical;
    (3) poisoned-request hygiene: a serve_nan-poisoned request sharing
        a refcount-2 prefix with a live co-batched request evicts with
        its exclusive blocks scrubbed, but the SHARED blocks survive —
        the co-user finishes bit-identical to running alone and a
        follow-up request still hits the intact prefix."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.serving import InferenceEngine

    clk = {"t": 0.0}

    def eng(**kw):
        kw.setdefault("slots", 2)
        kw.setdefault("prefill_buckets", (8, 16))
        kw.setdefault("block_size", 4)
        kw.setdefault("max_len", 32)
        kw.setdefault("clock", lambda: clk["t"])
        return InferenceEngine(_serve_lm(), device=_DEVICE, **kw)

    P = dict(prompt=[5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7],
             max_new_tokens=5, temperature=0.8, seed=11)
    S = dict(prompt=[30, 31, 32], max_new_tokens=5, temperature=0.9,
             seed=4)
    cold = eng().run([_req(**P)])[0]
    alone_s = eng().run([_req(**S)])[0]

    # --- (1) warm vs cold, in co-batch
    with _telemetry() as log1:
        e1 = eng()
        e1.run([_req(**P)])                      # cold: seeds the tree
        warm, stranger = e1.run([_req(**P), _req(**S)])
        snap = obs.get_registry().snapshot()["metrics"]
    hits_ev = log1.events("prefix_hit")

    def counter(name, metrics):
        fam = metrics.get(name, {"series": []})
        return sum(s["value"] for s in fam["series"])

    warm_ok = (warm.tokens == cold.tokens
               and stranger.tokens == alone_s.tokens
               and len(hits_ev) == 1
               and hits_ev[0]["matched_tokens"] == 12
               and counter("serving_prefix_hits_total", snap) == 1
               and counter("serving_prefix_tokens_saved_total",
                           snap) == 12
               and counter("serving_kv_pool_blocks_in_use", snap) > 0)

    # --- (2) eviction under pool pressure, then reuse
    with _telemetry() as log2:
        e2 = eng(slots=1, pool_blocks=9)         # 8 usable blocks
        e2.run([_req(**P)])                      # caches 3 blocks
        for i in range(3):                       # churn: distinct 9-tok
            e2.run([_req(prompt=[10 + i, 20 + i, 30 + i, 40 + i,
                                 11 + i, 21 + i, 31 + i, 41 + i, 2],
                         max_new_tokens=3, seed=i)])
        rerun = e2.run([_req(**P)])[0]
    evict_ev = log2.events("prefix_evict")
    evict_ok = (e2.stats["pool_evictions"] > 0 and len(evict_ev) > 0
                and rerun.tokens == cold.tokens)

    # --- (3) poisoned eviction never scrubs a shared block
    shared = [7, 3, 9, 1, 4, 8, 2, 6]
    V = dict(prompt=shared + [11, 12], max_new_tokens=6,
             temperature=0.8, seed=5)
    H = dict(prompt=shared + [13, 14, 15], max_new_tokens=6,
             temperature=0.9, seed=9)
    F = dict(prompt=shared + [16], max_new_tokens=4, temperature=0.6,
             seed=2)
    alone_h = eng().run([_req(**H)])[0]
    alone_f = eng().run([_req(**F)])[0]
    fm = _plan("serve_nan@2")
    try:
        with _telemetry() as log3:
            e3 = eng()
            # V admits first (cold, inserts the shared prefix), H
            # admits beside it and hits → the 2 shared blocks are
            # refcount-2 when V is poisoned at decode step 2
            got_v, got_h = e3.run([_req(**V), _req(**H)])
            follow = e3.run([_req(**F)])[0]
    finally:
        fm.set_plan(None)
    poisoned_ev = log3.events("request_terminal", status="poisoned")
    hit3_ev = log3.events("prefix_hit")
    poison_ok = (got_v.status == "poisoned"
                 and got_h.status == "done"
                 and got_h.tokens == alone_h.tokens
                 # the shared prefix SURVIVED the poisoned eviction:
                 # the follow-up still hits it and stays bit-identical
                 and follow.tokens == alone_f.tokens
                 and len(hit3_ev) == 2           # H + the follow-up
                 and all(e["matched_tokens"] == 8 for e in hit3_ev)
                 and len(poisoned_ev) == 1)
    ok = warm_ok and evict_ok and poison_ok
    return {"ok": bool(ok),
            "warm_bit_identical": warm.tokens == cold.tokens,
            "cobatch_stranger_bit_identical":
                stranger.tokens == alone_s.tokens,
            "prefix_hits_counter": counter(
                "serving_prefix_hits_total", snap),
            "tokens_saved_counter": counter(
                "serving_prefix_tokens_saved_total", snap),
            "evictions": e2.stats["pool_evictions"],
            "post_evict_bit_identical": rerun.tokens == cold.tokens,
            "poisoned_status": got_v.status,
            "shared_survivor_bit_identical":
                got_h.tokens == alone_h.tokens,
            "shared_block_reuse_after_poison":
                follow.tokens == alone_f.tokens,
            "events": {"warm": log1.counts_by_kind(),
                       "evict": log2.counts_by_kind(),
                       "poison": log3.counts_by_kind()}}


def drill_serve_spill(workdir):
    """The host-RAM KV spill tier end to end, twice. A
    spill-enabled block_size=4 engine with a deliberately tiny device
    pool (8 usable blocks) caches a 13-token prompt's 3-block chain,
    then a filler burst drives the pool past exhaustion — the chain
    SPILLS to pinned host numpy (kv_spill events,
    serving_kv_spill_blocks_total) instead of dying. Resubmitting the
    prompt re-admits the bytes (kv_readmit, a device_put + table
    patch, never recomputation) and decodes tokens bitwise == a
    never-spilled warm run on a large pool == a cold run. Two
    invocations are byte-identical in the leg digest (event counts,
    tokens, tier occupancy)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.serving import InferenceEngine

    def eng(**kw):
        kw.setdefault("slots", 2)
        kw.setdefault("prefill_buckets", (8, 16))
        kw.setdefault("block_size", 4)
        kw.setdefault("max_len", 32)
        return InferenceEngine(_serve_lm(), device=_DEVICE, **kw)

    P = dict(prompt=[5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7],
             max_new_tokens=5, temperature=0.8, seed=11)
    fillers = [dict(prompt=[10 + i, 20 + i, 30 + i, 40 + i, 11 + i,
                            21 + i, 31 + i, 41 + i, 2],
                    max_new_tokens=3, seed=i) for i in range(4)]
    cold = eng(prefix_cache=False).run([_req(**P)])[0]
    # never-spilled warm oracle: a large pool rides out the fillers
    # with P's chain resident on device the whole time
    e_ns = eng()
    e_ns.run([_req(**P)])
    for f in fillers:
        e_ns.run([_req(**f)])
    never_spilled = e_ns.run([_req(**P)])[0]

    def counter(name, metrics):
        fam = metrics.get(name, {"series": []})
        return sum(s["value"] for s in fam["series"])

    def run():
        with _telemetry() as log:
            e = eng(slots=1, pool_blocks=9, spill=True, host_blocks=32)
            e.run([_req(**P)])             # caches P's 3-block chain
            for f in fillers:              # pool past exhaustion
                e.run([_req(**f)])
            rerun = e.run([_req(**P)])[0]  # repeat prompt: re-admit
            h = e.health()["prefix"]
            snap = obs.get_registry().snapshot()["metrics"]
            digest = json.dumps({
                "events": log.counts_by_kind(),
                "tokens": rerun.tokens,
                "tier": {k: h[k] for k in
                         ("spilled", "readmitted", "host_evictions",
                          "host_in_use")},
            }, sort_keys=True)
            evs = (log.events("kv_spill"), log.events("kv_readmit"),
                   log.events("prefix_hit"))
        return rerun, h, snap, digest, evs

    rerun1, h1, snap1, d1, (spill_ev, readmit_ev, hit_ev) = run()
    _, _, _, d2, _ = run()

    bit_identical = (rerun1.tokens == never_spilled.tokens
                     == cold.tokens)
    ok = (bit_identical
          and h1["spilled"] > 0 and h1["readmitted"] >= 3
          and len(spill_ev) >= 1 and len(readmit_ev) >= 1
          and sum(e["blocks"] for e in spill_ev) == h1["spilled"]
          and sum(e["blocks"] for e in readmit_ev)
          == h1["readmitted"]
          # the repeat prompt HIT the spilled chain — full 3-block
          # (12-token) match, served from bytes, not recomputation
          and any(e["matched_tokens"] == 12 for e in hit_ev)
          and counter("serving_kv_spill_blocks_total", snap1)
          == h1["spilled"]
          and counter("serving_kv_readmit_blocks_total", snap1)
          == h1["readmitted"]
          and d1 == d2)
    return {"ok": bool(ok),
            "spilled_readmitted_bit_identical":
                rerun1.tokens == never_spilled.tokens,
            "cold_bit_identical": rerun1.tokens == cold.tokens,
            "spilled": h1["spilled"], "readmitted": h1["readmitted"],
            "host_in_use": h1["host_in_use"],
            "host_evictions": h1["host_evictions"],
            "report_byte_identical": d1 == d2,
            "events": json.loads(d1)["events"]}


def drill_serve_spec(workdir):
    """Speculative decoding loses its draft mid-burst,
    twice. A 6-request burst (greedy + seeded sampling) runs through a
    SpeculativeEngine — tiny draft engine (watchdog armed, 50 ms) over
    the shared tiny target. serve_slow@3 hangs a DRAFT chain dispatch
    past its budget on round 2: the draft quiesces (ONE
    engine_degraded event, ZERO request terminals from it — the
    requests live in the target), a spec_fallback event records the
    degradation, and the wrapper finishes every request target-only
    with tokens BIT-IDENTICAL to an undisturbed target-only run. Zero
    requests lost; accept-rate provenance from the rounds that DID
    speculate; two runs byte-identical in the leg digest (event
    counts, statuses, tokens, speculation tallies)."""
    from bigdl_tpu_torch.serving import SpeculativeEngine

    specs = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=6,
                  temperature=(0.8 if i % 2 else 0.0), seed=50 + i)
             for i in range(6)]
    ref = _engine(slots=2).run([_req(**s) for s in specs])

    def run():
        fm = _plan("serve_slow@3")
        try:
            with _telemetry() as log:
                draft = _draft_engine(step_timeout_s=0.05,
                                      obs_label="spec_d")
                target = _engine(obs_label="spec_t")
                eng = SpeculativeEngine(draft, target, k=3)
                got = eng.run([_req(**s) for s in specs])
                h = eng.health()["speculative"]
                digest = json.dumps({
                    "events": log.counts_by_kind(),
                    "statuses": [r.status for r in got],
                    "tokens": [r.tokens for r in got],
                    "spec": {k: h[k] for k in
                             ("rounds", "proposed", "accepted",
                              "wasted", "emitted", "accept_rate")},
                }, sort_keys=True)
                degraded_ev = log.events("engine_degraded")
                fallback_ev = log.events("spec_fallback")
                failed_ev = log.events("request_terminal",
                                       status="failed")
                done_ev = log.events("request_terminal", status="done")
        finally:
            fm.set_plan(None)
        return eng, got, digest, (degraded_ev, fallback_ev, failed_ev,
                                  done_ev)

    eng1, got1, d1, (degraded_ev, fallback_ev, failed_ev, done_ev) \
        = run()
    _, _, d2, _ = run()

    bit_identical = [g.tokens for g in got1] == [r.tokens for r in ref]
    h1 = eng1.health()["speculative"]
    ok = (eng1.fallback is not None and "watchdog" in eng1.fallback
          and eng1.draft_engine.degraded is not None
          and eng1.draft_engine.stats["watchdog_trips"] == 1
          and all(g.status == "done" for g in got1)
          and bit_identical
          and len(degraded_ev) == 1
          and degraded_ev[0]["engine"] == "spec_d"
          and len(fallback_ev) == 1
          and fallback_ev[0]["engine"] == "spec_t"
          and len(failed_ev) == 0               # zero requests lost
          and len(done_ev) == 6
          and h1["rounds"] >= 1                 # it DID speculate first
          and h1["accept_rate"] is not None
          and d1 == d2)
    return {"ok": bool(ok),
            "statuses": [g.status for g in got1],
            "bit_identical_to_target_only": bit_identical,
            "fallback": eng1.fallback,
            "draft_degraded": eng1.draft_engine.degraded,
            "rounds_before_trip": h1["rounds"],
            "accept_rate": h1["accept_rate"],
            "requests_lost": len(failed_ev),
            "report_byte_identical": d1 == d2,
            "events": json.loads(d1)["events"]}


def drill_spec_adapt(workdir):
    """The speculation flywheel closes its loop, twice. A
    6-request burst (greedy + seeded sampling) runs through an
    ADAPTIVE SpeculativeEngine whose draft is the stock random-init
    tiny LM — a planted accept collapse (~0.22 cumulative, far below
    collapse_at=0.35): a window evaluation drops k_live to k_min=1 and
    SUSPENDS speculation, and every later round cruises target-only
    (probe_every is set past the burst), so the hostile workload pays
    ~0 speculation tax while tokens stay BIT-IDENTICAL to an
    undisturbed target-only run. Between bursts a DraftDistiller-
    trained draft — distilled ONCE outside the drilled runs, from the
    target-only reference streams (the fleet's own emitted tokens),
    warm-started from the serving draft's exact init — is hot-swapped
    in: pure re-placement, zero new executables, no quiesce. The swap
    arms a probe; burst 2's first round auditions the new draft, the
    windowed accept clears raise_at=0.6 (distilled ~0.97 on the
    probe), speculation RESUMES and the ladder climbs off the floor
    back to the k=3 ceiling. The burst's TAIL may re-collapse (the
    last windows see near-empty co-batches of the hardest sampled
    requests — adaptation reacting exactly as designed), so the
    assertions read the k-timeline, not the final snapshot; the
    digest pins the whole trajectory byte-identically either way. The
    swap record's accept_after must beat accept_before; burst-2
    tokens are still bitwise the target's (coupled sampling — draft
    bits move ONLY the accept rate). Zero requests lost; two runs
    byte-identical in the leg digest (event counts, statuses, tokens,
    k-timeline, swap records, speculation tallies)."""
    from bigdl_tpu_torch.serving import DraftDistiller, SpeculativeEngine

    specs1 = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=8,
                   temperature=(0.8 if i % 2 else 0.0), seed=70 + i)
              for i in range(6)]
    specs2 = [dict(prompt=[i + 2, i + 4, i + 6], max_new_tokens=8,
                   temperature=(0.8 if i % 2 else 0.0), seed=90 + i)
              for i in range(6)]
    ref_eng = _engine(slots=2)
    ref1 = ref_eng.run([_req(**s) for s in specs1])
    ref2 = ref_eng.run([_req(**s) for s in specs2])

    # distill the better draft ONCE, outside the drilled runs: a
    # PRIVATE model (same arch + init key as _SERVE_DRAFT_LM, so the
    # shared serving draft's variables are never touched) warm-starts
    # the flywheel from the serving draft's exact weights, trained on
    # the target-only reference streams
    dmodel = loadgen.tiny_lm(
        loadgen.DRAFT_CONFIG, DRAFT_SEED, 64, _DEVICE,
        _WEIGHTS.get("draft"))
    distiller = DraftDistiller(dmodel, seq_len=8, epochs=6, seed=0)
    for r in ref1:
        distiller.ingest(r)
    new_vars = distiller.distill()

    def run():
        with _telemetry() as log:
            draft = _draft_engine(obs_label="adapt_d")
            target = _engine(obs_label="adapt_t")
            eng = SpeculativeEngine(draft, target, k=3, adapt_k=True,
                                    adapt_window=2, raise_at=0.6,
                                    lower_at=0.45, collapse_at=0.35,
                                    probe_every=10_000)
            got1 = eng.run([_req(**s) for s in specs1])
            mid = dict(eng.health()["speculative"])
            eng.swap_draft(new_vars, source="distill")
            got2 = eng.run([_req(**s) for s in specs2])
            h = eng.health()["speculative"]
            adjusts = log.events("spec_k_adjust")
            swap_ev = log.events("draft_swap")
            failed_ev = log.events("request_terminal", status="failed")
            done_ev = log.events("request_terminal", status="done")
            digest = json.dumps({
                "events": log.counts_by_kind(),
                "statuses": [r.status for r in got1 + got2],
                "tokens": [r.tokens for r in got1 + got2],
                "k_timeline": [{k: e[k] for k in
                                ("k_from", "k_to", "accept",
                                 "suspended")} for e in adjusts],
                "swaps": eng.swap_records,
                "spec": {k: h[k] for k in
                         ("rounds", "proposed", "accepted", "emitted",
                          "k_live", "suspended", "k_adjusts", "swaps",
                          "window_accept")},
            }, sort_keys=True)
        return eng, got1, got2, mid, h, digest, (adjusts, swap_ev,
                                                 failed_ev, done_ev)

    eng1, got1, got2, mid, h1, d1, (adjusts, swap_ev, failed_ev,
                                    done_ev) = run()
    _, _, _, _, _, d2, _ = run()

    bit1 = [g.tokens for g in got1] == [r.tokens for r in ref1]
    bit2 = [g.tokens for g in got2] == [r.tokens for r in ref2]
    rec = eng1.swap_records[0] if eng1.swap_records else {}
    swap_round = swap_ev[0]["round"] if swap_ev else -1
    pre = [e for e in adjusts if e["round"] <= swap_round]
    post = [e for e in adjusts if e["round"] > swap_round]
    ok = (all(g.status == "done" for g in got1 + got2)
          and len(failed_ev) == 0               # zero requests lost
          and len(done_ev) == 12
          and bit1 and bit2
          # burst 1 collapsed: floor + suspended, and the k-timeline
          # records the drop
          and mid["suspended"] and mid["k_live"] == 1
          and any(e["k_to"] == 1 and e["suspended"] for e in pre)
          # the swapped-in draft's probe clears the resume bar and the
          # ladder climbs off the floor
          and len(swap_ev) == 1
          and any(not e["suspended"] and e["accept"] >= 0.6
                  for e in post)
          and any(e["k_to"] > 1 for e in post)
          and rec.get("accept_after") is not None
          and rec.get("accept_before") is not None
          and rec["accept_after"] > rec["accept_before"]
          and eng1.fallback is None             # never a draft outage
          and d1 == d2)
    return {"ok": bool(ok),
            "statuses": [g.status for g in got1 + got2],
            "bit_identical_to_target_only": bit1 and bit2,
            "collapsed_mid_run": {"k_live": mid["k_live"],
                                  "suspended": mid["suspended"]},
            "final": {"k_live": h1["k_live"],
                      "suspended": h1["suspended"],
                      "window_accept": h1["window_accept"]},
            "swap": rec,
            "k_adjusts": len(adjusts),
            "requests_lost": len(failed_ev),
            "report_byte_identical": d1 == d2,
            "events": json.loads(d1)["events"]}


# ------------------------------------------------------------ fleet legs

def drill_fleet_failover(workdir):
    """serve_slow@2 trips the watchdog on engine 0 of a 2-engine
    router mid-decode: its in-flight requests (2 tokens deep) AND its
    queued request fail over to engine 1, re-decode from their
    prompts, and finish with tokens BIT-IDENTICAL to an undisturbed
    single-engine run — fold_in(seed, n) sampling is slot/co-batch/
    arrival independent, so the reroute is invisible in the output.
    Zero requests lost; the transitional 'failed' terminals are
    superseded, never surfaced."""
    from bigdl_tpu_torch.serving import EngineRouter

    specs = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=5,
                  temperature=0.8, seed=20 + i) for i in range(6)]
    ref = _engine(slots=2).run([_req(**s) for s in specs])
    fm = _plan("serve_slow@2")
    try:
        with _telemetry() as log:
            e0 = _engine(step_timeout_s=0.05)   # watchdog-armed
            e1 = _engine()
            router = EngineRouter([e0, e1])
            got = router.run([_req(**s) for s in specs])
    finally:
        fm.set_plan(None)
    degraded_ev = log.events("engine_degraded")
    failover_ev = log.events("router_failover")
    failed_ev = log.events("request_terminal", status="failed")
    done_ev = log.events("request_terminal", status="done")
    bit_identical = [g.tokens for g in got] == [r.tokens for r in ref]
    ok = (e0.degraded is not None and "watchdog" in e0.degraded
          and all(g.status == "done" for g in got)
          and bit_identical
          and router.stats["failover"] == 3      # 2 in-flight + 1 queued
          and router.stats["failover_lost"] == 0
          and len(failover_ev) == 3
          and len(degraded_ev) == 1
          and len(failed_ev) == 3                # superseded transitions
          and len(done_ev) == 6)                 # every request completes
    return {"ok": bool(ok),
            "statuses": [g.status for g in got],
            "bit_identical_to_undisturbed": bit_identical,
            "failovers": router.stats["failover"],
            "degraded_engine": e0.degraded,
            "events": log.counts_by_kind()}


def drill_fleet_affinity_failover(workdir):
    """Prefix-affinity routing + warm-state migration under
    an engine loss, twice. A 2-engine spill-enabled fleet under a
    virtual clock first settles ONE shared-prefix warmup request (it
    lands on e0 by index tie-break), then takes a 6-request burst of
    the same prefix with `affinity=True`: every burst request follows
    the warm radix tree onto engine 0 — load ranking alone would have
    split them. serve_slow trips e0's watchdog mid-burst — its parked
    tree MIGRATES into e1's host tier (ONE prefix_migrate event,
    router.stats migrations/migrated_blocks) BEFORE the failover
    resubmissions settle, so the survivor serves the burst with warm
    prefix hits sourced from the migrated bytes (e1 prefix_hits > 0
    AND readmitted > 0 — re-admission, not re-prefill). Zero requests
    lost, tokens bit-identical to an undisturbed run, and two
    invocations are byte-identical in the leg digest AND in the
    flight-recorder bundle bytes."""
    from bigdl_tpu_torch.obs.flightrecorder import FlightRecorder
    from bigdl_tpu_torch.serving import EngineRouter, InferenceEngine

    shared = [7, 3, 9, 1, 4, 8, 2, 6]
    specs = [dict(prompt=shared + [10 + i], max_new_tokens=4,
                  temperature=(0.8 if i % 2 else 0.0), seed=30 + i)
             for i in range(6)]

    def eng(**kw):
        kw.setdefault("slots", 2)
        kw.setdefault("prefill_buckets", (8, 16))
        kw.setdefault("block_size", 4)
        kw.setdefault("max_len", 32)
        kw.setdefault("spill", True)
        kw.setdefault("host_blocks", 32)
        return InferenceEngine(_serve_lm(), device=_DEVICE, **kw)

    ref = eng(spill=False, host_blocks=None).run(
        [_req(**s) for s in specs])

    def run(outdir):
        clk = {"t": 0.0}

        def c():
            return clk["t"]

        fm = None
        try:
            with _telemetry(clock=c) as log:
                # 0.25 s budget like the journey leg: byte-identity
                # runs must only trip on the injected 5x hang
                e0 = eng(step_timeout_s=0.25, obs_label="a0", clock=c)
                e1 = eng(obs_label="a1", clock=c)
                router = EngineRouter([e0, e1], clock=c,
                                      obs_label="ra", affinity=True)
                rec = FlightRecorder(outdir, clock=c)
                for name, e in (("a0", e0), ("a1", e1)):
                    rec.register_health_source(name, e.health)
                rec.install()
                # warmup: settle one shared-prefix request BEFORE the
                # burst so e0 alone is warm — affinity, not load,
                # must then concentrate the burst there
                got = {}
                wid = router.submit(_req(prompt=shared + [9],
                                         max_new_tokens=3,
                                         temperature=0.0, seed=99))
                rounds = 0
                while wid not in got:
                    rounds += 1
                    if rounds > 100:
                        raise RuntimeError("affinity warmup stalled")
                    clk["t"] += 0.5
                    for res in router.step():
                        got[res.id] = res
                # arm the trip two decode steps into the burst —
                # relative to e0's counter so the warmup's (fixed,
                # deterministic) step count never shifts it
                fm = _plan(
                    f"serve_slow@{e0.stats['decode_steps'] + 2}")
                ids = [router.submit(_req(**s)) for s in specs]
                while any(i not in got for i in ids):
                    rounds += 1
                    if rounds > 200:
                        raise RuntimeError(
                            "affinity drill stalled: "
                            f"{sum(i in got for i in ids)}"
                            f"/{len(ids)} settled")
                    clk["t"] += 0.5
                    for res in router.step():
                        got[res.id] = res
                rec.close()
                h1 = e1.health()["prefix"]
                digest = json.dumps({
                    "events": log.counts_by_kind(),
                    "statuses": [got[i].status for i in ids],
                    "tokens": [got[i].tokens for i in ids],
                    "router": router.stats,
                    "survivor_tier": {k: h1[k] for k in
                                      ("hits", "readmitted",
                                       "host_in_use")},
                }, sort_keys=True)
                migrate_ev = log.events("prefix_migrate")
                failed_ev = log.events("request_terminal",
                                       status="failed")
                done_ev = log.events("request_terminal", status="done")
        finally:
            if fm is not None:
                fm.set_plan(None)
        return (router, e0, e1, [got[i] for i in ids], digest,
                (migrate_ev, failed_ev, done_ev),
                _bundle_bytes(outdir))

    router, e0, e1, got1, d1, (migrate_ev, failed_ev, done_ev), b1 \
        = run(os.path.join(workdir, "run1"))
    _, _, _, _, d2, _, b2 = run(os.path.join(workdir, "run2"))

    bit_identical = [g.tokens for g in got1] == [r.tokens for r in ref]
    h1 = e1.health()["prefix"]
    ok = (e0.degraded is not None and "watchdog" in e0.degraded
          and all(g.status == "done" for g in got1)
          and bit_identical
          # affinity held the burst on e0 until the trip: the whole
          # session followed the warm tree, not the load ranking
          and e0.stats["prefix_hits"] >= 1
          and router.stats["failover"] >= 1
          and router.stats["failover_lost"] == 0
          and router.stats["migrations"] == 1
          and router.stats["migrated_blocks"] >= 1
          and len(migrate_ev) == 1
          and migrate_ev[0]["source"] == "a0"
          and migrate_ev[0]["target"] == "a1"
          # warm hit-rate survived the failover: the survivor's hits
          # re-admitted MIGRATED bytes (host tier), not re-prefill
          and e1.stats["prefix_hits"] > 0
          and h1["readmitted"] > 0
          and len(done_ev) == 7          # 6-request burst + warmup
          and d1 == d2
          and bool(b1) and b1 == b2)
    return {"ok": bool(ok),
            "statuses": [g.status for g in got1],
            "bit_identical_to_undisturbed": bit_identical,
            "failovers": router.stats["failover"],
            "migrations": router.stats["migrations"],
            "migrated_blocks": router.stats["migrated_blocks"],
            "survivor_prefix_hits": e1.stats["prefix_hits"],
            "survivor_readmitted": h1["readmitted"],
            "report_byte_identical": d1 == d2,
            "bundles_byte_identical": bool(b1) and b1 == b2,
            "events": json.loads(d1)["events"]}


def drill_fleet_tp_failover(workdir):
    """fleet_failover ACROSS sharding layouts: serve_slow@2
    trips the watchdog on a tp=2 SHARDED engine 0 of a 2-engine router
    mid-decode; its in-flight and queued requests fail over to the
    UNSHARDED engine 1 and finish with tokens BIT-IDENTICAL to an
    undisturbed single-engine run. This holds only because sharded
    decode is bitwise == unsharded decode (the tp_shard_gather
    construction, serving/tp.py) — the failover invariant never
    learned what a layout is, and this leg pins that it never has to.

    The port runs the leg on TP_WORLD ranks, every rank the whole leg
    (SPMD), and returns rank 0's digest; with fewer than TP_WORLD
    ranks' devices it reports `skipped` (the CPU tests assert that key
    is absent, so the drill cannot silently stop drilling)."""
    return _spmd_leg("_fleet_tp_failover_rank", workdir)


def _fleet_tp_failover_rank(workdir):
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import EngineRouter

    mesh = make_mesh({"model": TP_WORLD}, device=_DEVICE)
    specs = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=5,
                  temperature=0.8, seed=60 + i) for i in range(6)]
    ref = _engine(slots=2).run([_req(**s) for s in specs])
    fm = _plan("serve_slow@2")
    try:
        with _telemetry() as log:
            e0 = _engine(step_timeout_s=0.05, tp_mesh=mesh)
            e1 = _engine()
            router = EngineRouter([e0, e1])
            got = router.run([_req(**s) for s in specs])
    finally:
        fm.set_plan(None)
    degraded_ev = log.events("engine_degraded")
    failover_ev = log.events("router_failover")
    done_ev = log.events("request_terminal", status="done")
    bit_identical = [g.tokens for g in got] == [r.tokens for r in ref]
    # the journey layer must reconstruct ONE cross-engine,
    # cross-LAYOUT timeline per rerouted request from the very same
    # event log — zero lost hops, the transitional 'failed' terminals
    # recorded as superseded, never as the outcome
    from bigdl_tpu_torch.obs.journey import build_journeys, summarize_journeys

    journeys = build_journeys(log.events())
    jsum = summarize_journeys(journeys)
    crossed = [j for j in journeys if j["cross_engine"]]
    journeys_ok = (
        jsum["count"] == 6 and jsum["complete"] == 6
        and jsum["lost_hops"] == 0
        and len(crossed) == 3                  # the failed-over three
        and all(j["cross_layout"] for j in crossed)   # tp=2 -> tp=1
        and all(j["status"] == "done" for j in journeys)
        and jsum["superseded_terminals"] == 3)
    ok = (e0.tp == 2 and e1.tp == 1
          and e0.degraded is not None and "watchdog" in e0.degraded
          and all(g.status == "done" for g in got)
          and bit_identical
          and router.stats["failover"] == 3      # 2 in-flight + 1 queued
          and router.stats["failover_lost"] == 0
          and len(failover_ev) == 3
          and len(degraded_ev) == 1
          and len(done_ev) == 6
          and journeys_ok)
    return {"ok": bool(ok),
            "statuses": [g.status for g in got],
            "bit_identical_to_undisturbed": bit_identical,
            "failovers": router.stats["failover"],
            "degraded_engine": e0.degraded,
            "layouts": {"degraded_tp": e0.tp, "survivor_tp": e1.tp},
            "journeys": jsum,
            "events": log.counts_by_kind()}


def drill_fleet_drain(workdir):
    """Drain engine 0 of a 2-engine router mid-traffic: its accepted
    work (in-flight + own queue) finishes normally while direct
    submission raises EngineDraining and router traffic flows to
    engine 1 only; the health state walks 'draining'→'drained', the
    engine leaves the pool, and every token matches the undisturbed
    single-engine oracle."""
    from bigdl_tpu_torch.serving import EngineDraining, EngineRouter

    specs = [dict(prompt=[i + 2, i + 3], max_new_tokens=4,
                  temperature=0.6, seed=40 + i) for i in range(8)]
    ref = _engine(slots=2).run([_req(**s) for s in specs])
    with _telemetry() as log:
        e0, e1 = _engine(), _engine()
        router = EngineRouter([e0, e1])
        ids = [router.submit(_req(**s)) for s in specs[:6]]
        router.step()                       # both engines decoding
        router.drain(e0)
        state_mid = e0.health()["state"]
        gated = False
        try:
            e0.submit(_req(prompt=[1, 2]))
        except EngineDraining:
            gated = True
        late = [router.submit(_req(**s)) for s in specs[6:]]
        while any(not e.idle for e in router.engines):
            router.step()
        state_end = e0.health()["state"]
        removed = router.remove_engine(e0)
        res = {i: router.completed[i] for i in ids + late}
    drain_ev = log.events("engine_drain")
    removed_ev = log.events("engine_removed")
    toks = [res[i].tokens for i in ids + late]
    bit_identical = toks == [r.tokens for r in ref]
    ok = (state_mid == "draining" and state_end == "drained"
          and gated and removed is e0
          and len(router.engines) == 1
          and all(r.status == "done" for r in res.values())
          and bit_identical
          # the late submissions never touched the draining engine
          and e1.stats["requests_done"] >= 2 + 3
          and e0.stats["requests_done"] + e1.stats["requests_done"] == 8
          and len(drain_ev) == 1 and len(removed_ev) == 1)
    return {"ok": bool(ok), "state_mid": state_mid,
            "state_end": state_end, "submit_gated": gated,
            "bit_identical_to_undisturbed": bit_identical,
            "done_split": [e0.stats["requests_done"],
                           e1.stats["requests_done"]],
            "rebalanced": router.stats["rebalanced"],
            "events": log.counts_by_kind()}


def drill_fleet_autoscale(workdir):
    """One deterministic loadgen burst (24 requests at t=0), twice:
    a FIXED 1-engine pool grossly violates the 10-virtual-second p99
    target; the autoscaled pool grows to 3 engines, rebalances the
    backlog onto them, and holds the target. The autoscaled run
    executes twice more — decision sequence and full load report must
    be bit-identical (the closed loop is a pure function of registry
    state and the injected clock)."""
    def burst():
        return loadgen.make_trace(24, seed=3, arrival="bursty",
                             burst_size=24,
                             prompt_len_choices=(3, 5, 8),
                             max_new_choices=(4,), priorities=(0,))

    def run(autoscale):
        from bigdl_tpu_torch.serving import Autoscaler, EngineRouter

        with _telemetry() as log:
            clk = {"t": 0.0}

            def factory():
                return _engine(clock=lambda: clk["t"])

            router = EngineRouter([factory()], engine_factory=factory,
                                  clock=lambda: clk["t"])
            asc = Autoscaler(router, target_p99_s=10.0, max_engines=3,
                             evaluate_every_s=0.5, backlog_high=8.0) \
                if autoscale else None
            report = loadgen.replay(router, burst(), clock=clk,
                               step_dt=0.5, autoscaler=asc)
            counts = log.counts_by_kind()
        return report, counts

    fixed, _ = run(False)
    auto, auto_ev = run(True)
    auto2, _ = run(True)
    target = 10.0
    actions = [d["action"] for d in auto["autoscale"]["decisions"]]
    ok = (fixed["latency_p99_s"] > target
          and auto["latency_p99_s"] <= target
          and fixed["by_status"] == {"done": 24}
          and auto["by_status"] == {"done": 24}
          and actions[:2] == ["scale_up", "scale_up"]
          # the tail may already be scaling back down — pool peaked
          # at max_engines either way
          and max(d["engines"] for d in auto["autoscale"]["decisions"])
          == 3
          and auto["pool"]["router"]["rebalanced"] > 0
          and auto == auto2                      # bit-deterministic
          and auto_ev.get("autoscale_decision", 0) >= 2
          and auto_ev.get("engine_added", 0) == 2)
    return {"ok": bool(ok), "target_p99_s": target,
            "fixed_p99_s": fixed["latency_p99_s"],
            "autoscaled_p99_s": auto["latency_p99_s"],
            "engines_peak": max(d["engines"]
                                for d in auto["autoscale"]["decisions"]),
            "engines_final": auto["pool"]["engines_final"],
            "decisions": actions,
            "rebalanced": auto["pool"]["router"]["rebalanced"],
            "deterministic": auto == auto2,
            "events": auto_ev}


def drill_slo_alert(workdir):
    """The live SLO plane end to end, twice. A 12-request
    burst against a 1-engine router under a virtual clock grossly
    violates a 2-virtual-second p99 objective: the MetricsSampler's
    windows see the burn on both the long (4 s) and short (1 s)
    window, the burn-rate AlertRule walks inactive→firing exactly once
    (alert_firing event naming value/target/window), and the installed
    FlightRecorder dumps ONE slo_burn post-mortem bundle whose trigger
    record names the breached window. A recovery trickle of fast
    requests then measures healthy; flap suppression (clear_s=2.0)
    holds the alert through the streak and it resolves exactly once
    (alert_resolved with the firing duration). Pins: one firing, one
    resolution, one bundle, all requests done — and TWO invocations
    are byte-identical in the leg digest AND in bundle file bytes
    (the whole plane is a pure function of the event sequence and the
    injected clock)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs.flightrecorder import FlightRecorder
    from bigdl_tpu_torch.obs.slo import AlertEngine, AlertRule, SLOObjective
    from bigdl_tpu_torch.obs.timeseries import MetricsSampler
    from bigdl_tpu_torch.serving import EngineRouter

    target = 2.0
    burst = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=4,
                  temperature=0.7, seed=90 + i) for i in range(12)]
    trickle = [dict(prompt=[40 + i], max_new_tokens=1, seed=200 + i)
               for i in range(8)]

    def run(outdir):
        clk = {"t": 0.0}

        def c():
            return clk["t"]

        with _telemetry(clock=c) as log:
            eng = _engine(obs_label="s0", clock=c)
            router = EngineRouter([eng], clock=c, obs_label="r0")
            sampler = MetricsSampler(interval_s=0.5, capacity=256,
                                     clock=c)
            obj = SLOObjective(
                name="p99", kind="latency_quantile",
                metric="router_request_latency_seconds",
                target=target, q=0.99, labels={"router": "r0"})
            rule = AlertRule(name="p99_burn", objective=obj,
                             kind="burn_rate", long_window_s=4.0,
                             short_window_s=1.0, clear_s=2.0)
            aeng = AlertEngine(sampler, [rule], clock=c)
            rec = FlightRecorder(outdir, clock=c)
            rec.register_health_source("s0", eng.health)
            rec.install()
            got = {}

            def rounds_until(done, limit):
                n = 0
                while not done():
                    n += 1
                    if n > limit:
                        raise RuntimeError(
                            "slo_alert drill stalled "
                            f"({len(got)} settled)")
                    clk["t"] += 0.5
                    for res in router.step():
                        got[res.id] = res
                    sampler.tick()
                    aeng.evaluate()

            # phase 1: the burn — 12 queued requests serialize through
            # 2 slots, completed-latency p99 blows past the target on
            # both windows while the backlog drains
            ids = [router.submit(_req(**s)) for s in burst]
            rounds_until(lambda: len(got) >= len(ids), limit=300)
            # phase 2: recovery — each 1-token request completes in
            # ~1 virtual second, the windows measure healthy, and the
            # clear_s streak resolves the alert
            for s in trickle:
                rid = router.submit(_req(**s))
                rounds_until(lambda: rid in got, limit=50)
            rec.close()
            firing = log.events("alert_firing")
            resolved = log.events("alert_resolved")
            digest = json.dumps(
                {"events": log.counts_by_kind(), "firing": firing,
                 "resolved": resolved,
                 "alerts_final": aeng.alerts()}, sort_keys=True)
        return (got, firing, resolved, rec, digest,
                _bundle_bytes(outdir))

    got1, firing1, resolved1, rec1, d1, b1 = run(
        os.path.join(workdir, "run1"))
    _, _, _, _, d2, b2 = run(os.path.join(workdir, "run2"))

    fired_rec = firing1[0] if firing1 else {}
    manifest = {}
    if rec1.bundles:
        import json as _json

        with open(os.path.join(workdir, "run1", rec1.bundles[0],
                               "manifest.json")) as f:
            manifest = _json.load(f)
    names_window = (manifest.get("incident") == "slo_burn"
                    and manifest.get("trigger", {}).get("window_s")
                    == 4.0
                    and manifest.get("trigger", {}).get("alert")
                    == "p99_burn")
    ok = (all(r.status == "done" for r in got1.values())
          and len(firing1) == 1 and len(resolved1) == 1
          and fired_rec.get("value") is not None
          and fired_rec.get("value") > target
          and resolved1[0].get("firing_s", 0) > 0
          and len(rec1.bundles) == 1
          and rec1.bundles[0].endswith("slo_burn")
          and names_window
          and d1 == d2
          and bool(b1) and b1 == b2)
    return {"ok": bool(ok),
            "fired": len(firing1), "resolved": len(resolved1),
            "firing_value": fired_rec.get("value"),
            "target": target,
            "firing_s": resolved1[0].get("firing_s")
            if resolved1 else None,
            "bundles": rec1.bundles,
            "bundle_names_window": names_window,
            "report_byte_identical": d1 == d2,
            "bundles_byte_identical": bool(b1) and b1 == b2,
            "events": json.loads(d1)["events"]}


def _bundle_bytes(outdir):
    """{relative path: file bytes} over a flight-recorder output dir —
    the byte-identity surface the journey leg compares across runs."""
    out = {}
    for root, _, files in os.walk(outdir):
        for f in sorted(files):
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, outdir)] = fh.read()
    return out


def drill_fleet_journey(workdir):
    """The full observability plane against the full fleet
    plane, twice. A disaggregated-prefill router (pf0 → tp=2 'e0' +
    unsharded 'e1', fixed obs labels) serves 4 long prompts through
    the handoff path and 2 short prompts directly, under a virtual
    clock injected into engines, router, registry, event log AND the
    flight recorder; serve_slow@2 trips e0's watchdog mid-decode so
    requests also fail over ACROSS layouts. Pins:

    * journeys: ONE reconstructed journey per request, zero lost hops,
      every long prompt's hop 0 on the prefill tier with its decode
      hop seated via handoff_import, failover hops crossing tp
      layouts;
    * flight recorder: the watchdog trip dumps exactly one post-mortem
      bundle whose event tail (and manifest trigger) NAMES the failing
      decode step;
    * determinism: two runs produce byte-identical journey JSON and
      byte-identical bundle files — the whole black box is a pure
      function of the event sequence + injected clocks.

    Run as fleet_tp_failover is: SPMD on TP_WORLD ranks, rank 0's
    digest, `skipped` with fewer ranks' devices."""
    return _spmd_leg("_fleet_journey_rank", workdir)


def _fleet_journey_rank(workdir):
    from bigdl_tpu_torch.obs.flightrecorder import FlightRecorder
    from bigdl_tpu_torch.obs.journey import (build_journeys, journeys_json,
                                             summarize_journeys)
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import EngineRouter

    # ONE mesh for both runs: the serving/tp.py wrapper memoizes on
    # (model, mesh, axis), so run 2 reuses its shards
    mesh = make_mesh({"model": TP_WORLD}, device=_DEVICE)
    longs = [dict(prompt=[(7 * i + j) % 40 + 1 for j in range(8)],
                  max_new_tokens=4, temperature=0.8, seed=70 + i)
             for i in range(4)]
    shorts = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=4,
                   temperature=0.7, seed=80 + i) for i in range(2)]
    specs = longs + shorts

    def run(outdir):
        clk = {"t": 0.0}

        def c():
            return clk["t"]

        fm = _plan("serve_slow@2")
        try:
            with _telemetry(clock=c) as log:
                pf = _engine(role="prefill", obs_label="pf0", clock=c)
                # budget 0.25 s, not the 0.05 s the single-run legs
                # use: this leg compares run-to-run BYTES, so a busy
                # host real-tripping the watchdog on a healthy step in
                # ONE run (observed with a concurrent bench hogging
                # the core) would break identity — only the injected
                # 5x-budget serve_slow hang may trip
                e0 = _engine(step_timeout_s=0.25, tp_mesh=mesh,
                             obs_label="e0", clock=c)
                e1 = _engine(obs_label="e1", clock=c)
                router = EngineRouter([e0, e1], prefill_engines=[pf],
                                      handoff_len=8, clock=c,
                                      obs_label="r0")
                rec = FlightRecorder(outdir, clock=c)
                for name, eng in (("pf0", pf), ("e0", e0), ("e1", e1)):
                    rec.register_health_source(name, eng.health)
                rec.install()
                got = {}
                ids = [router.submit(_req(**s)) for s in specs]
                rounds = 0
                while len(got) < len(ids):
                    rounds += 1
                    if rounds > 200:
                        raise RuntimeError(
                            f"journey drill stalled: {len(got)}/"
                            f"{len(ids)} settled after {rounds} rounds")
                    clk["t"] += 0.5
                    for res in router.step():
                        got[res.id] = res
                rec.close()
                events = log.events()
        finally:
            fm.set_plan(None)
        return [got[i] for i in ids], events, rec, e0

    got1, ev1, rec1, e0 = run(os.path.join(workdir, "run1"))
    got2, ev2, rec2, _ = run(os.path.join(workdir, "run2"))

    j1, j2 = build_journeys(ev1), build_journeys(ev2)
    jsum = summarize_journeys(j1)
    by_req = {j["request"]: j for j in j1}
    long_ids = [r.id for r in got1[:len(longs)]]
    handoff_ok = all(
        by_req[i]["hops"][0]["engine"] == "pf0"
        and by_req[i]["hops"][0]["role"] == "prefill"
        and len(by_req[i]["hops"]) >= 2
        and by_req[i]["hops"][1]["via"] == "handoff_import"
        for i in long_ids)
    journeys_ok = (jsum["count"] == len(specs)
                   and jsum["complete"] == len(specs)
                   and jsum["lost_hops"] == 0
                   and jsum["cross_engine"] >= len(longs)
                   and jsum["cross_layout"] >= 1)
    identical_journeys = journeys_json(j1) == journeys_json(j2)

    b1 = _bundle_bytes(os.path.join(workdir, "run1"))
    b2 = _bundle_bytes(os.path.join(workdir, "run2"))
    identical_bundles = bool(b1) and b1 == b2
    # the bundle's event tail must NAME the failing step
    manifest = json.loads(b1[os.path.join(
        rec1.bundles[0], "manifest.json")]) if rec1.bundles else {}
    tail_lines = b1.get(os.path.join(
        rec1.bundles[0], "events.jsonl"), b"").decode()
    degraded_recs = [json.loads(ln) for ln in tail_lines.splitlines()
                     if '"engine_degraded"' in ln]
    names_failing_step = (
        manifest.get("incident") == "engine_degraded"
        and manifest.get("component") == "e0"
        and len(degraded_recs) == 1
        and "decode step 2" in degraded_recs[0]["reason"])

    counts = {}
    for e in ev1:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    ok = (all(r.status == "done" for r in got1)
          and e0.degraded is not None and "watchdog" in e0.degraded
          and journeys_ok and handoff_ok
          and identical_journeys
          and len(rec1.bundles) == 1 and identical_bundles
          and names_failing_step)
    return {"ok": bool(ok),
            "statuses": [r.status for r in got1],
            "journeys": jsum,
            "handoff_journeys_ok": handoff_ok,
            "journeys_byte_identical": identical_journeys,
            "bundles": rec1.bundles,
            "bundles_byte_identical": identical_bundles,
            "bundle_names_failing_step": names_failing_step,
            "events": dict(sorted(counts.items()))}


def drill_tenant_noisy(workdir):
    """Noisy-neighbor containment, twice. A 'quiet' tenant's
    4-request burst runs once alone (reference) and once co-resident
    with a 'noisy' tenant flooding 16 requests AT THE SAME INSTANT,
    both through one tenancy-armed router under a virtual clock. The
    noisy tenant is budgeted by ITS OWN TenantSpec — a 2-token bucket
    refilling at 0.5/s and a 6-deep pending bound — so the flood is
    deferred and shed by its own gate while the quiet tenant's bucket
    never empties. Pins: every quiet request finishes 'done' with
    tokens BITWISE identical to the quiet-only run (containment means
    the co-resident flood changes nothing the quiet tenant can
    observe in its output); the flood draws both 'deferred' and
    'shed' tenant_throttled events billed to the noisy tenant only;
    and TWO invocations of the mixed run produce byte-identical leg
    digests (throttle event stream, per-tenant stats, every token) —
    admission is a pure function of the trace and the injected
    clock."""
    from bigdl_tpu_torch.serving import (EngineRouter, TenancyController,
                                   TenantSpec)

    quiet = [dict(prompt=[i + 1, i + 2, i + 3], max_new_tokens=4,
                  temperature=0.7, seed=50 + i, tenant="quiet")
             for i in range(4)]
    noisy = [dict(prompt=[(3 * i) % 30 + 1, (5 * i) % 30 + 2],
                  max_new_tokens=4, temperature=0.7, seed=150 + i,
                  tenant="noisy") for i in range(16)]

    def run(include_noisy):
        clk = {"t": 0.0}

        def c():
            return clk["t"]

        with _telemetry(clock=c) as log:
            eng = _engine(slots=4, obs_label="s0", clock=c)
            ctl = TenancyController(
                [TenantSpec("quiet", bucket_capacity=8.0,
                            refill_rate=2.0),
                 TenantSpec("noisy", bucket_capacity=2.0,
                            refill_rate=0.25, max_pending=6)],
                clock=c)
            router = EngineRouter([eng], clock=c, obs_label="r0",
                                  tenancy=ctl)
            got = {}

            def step_round():
                clk["t"] += 0.5
                for res in router.step():
                    got[res.id] = res

            # wave 1: the quiet burst plus half the flood at t=0 —
            # the flood instantly drains its 2-token bucket and fills
            # its 6-deep pending bound (overflow sheds on arrival)
            ids = [router.submit(_req(**s))
                   for s in quiet + (noisy[:8] if include_noisy
                                     else [])]
            # a FIXED 4 rounds (2 virtual seconds) so wave 2 lands on
            # a drained bucket at the same instant every invocation
            for _ in range(4):
                step_round()
            # wave 2: the rest of the flood meets an empty bucket —
            # these offers are DEFERRED (throttle events) until the
            # pending bound sheds the tail
            if include_noisy:
                ids += [router.submit(_req(**s)) for s in noisy[8:]]
            rounds = 0
            while len(got) < len(ids):
                rounds += 1
                if rounds > 400:
                    raise RuntimeError(
                        f"tenant_noisy drill stalled: {len(got)}/"
                        f"{len(ids)} settled after {rounds} rounds")
                step_round()
            throttled = log.events("tenant_throttled")
            digest = json.dumps(
                {"events": log.counts_by_kind(),
                 "throttled": throttled,
                 "stats": {t: ctl.stats(t) for t in ctl.tenants},
                 "tokens": {i: got[i].tokens for i in ids}},
                sort_keys=True)
        return [got[i] for i in ids], throttled, ctl, digest

    ref, ref_throttle, _, _ = run(False)
    mixed, throttle1, ctl1, d1 = run(True)
    _, _, _, d2 = run(True)

    nq = len(quiet)
    quiet_res, noisy_res = mixed[:nq], mixed[nq:]
    quiet_tokens_identical = \
        [r.tokens for r in quiet_res] == [r.tokens for r in ref]
    actions = {e["action"] for e in throttle1}
    billed = {e["tenant"] for e in throttle1}
    nstat = ctl1.stats("noisy")
    ok = (all(r.status == "done" for r in ref)
          and not ref_throttle                 # quiet alone: no gate
          and all(r.status == "done" for r in quiet_res)
          and quiet_tokens_identical
          and {"defer", "shed"} <= actions
          and billed == {"noisy"}              # containment: the flood
          and ctl1.stats("quiet")["deferred"] == 0   # bills only itself
          and ctl1.stats("quiet")["shed"] == 0
          and nstat["shed"] > 0
          and sum(1 for r in noisy_res if r.status == "shed")
          == nstat["shed"]
          and all(r.status in ("done", "shed") for r in noisy_res)
          and d1 == d2)
    return {"ok": bool(ok),
            "quiet_tokens_identical": quiet_tokens_identical,
            "quiet_statuses": [r.status for r in quiet_res],
            "noisy_statuses": sorted(
                {r.status for r in noisy_res}),
            "noisy_stats": nstat,
            "throttle_actions": sorted(actions),
            "throttle_billed_to": sorted(billed),
            "report_byte_identical": d1 == d2,
            "events": json.loads(d1)["events"]}


def drill_scenario_chaos(workdir):
    """A compiled chaos scenario through the fleet
    SIMULATOR, twice. The builtin `chaos_smoke` scenario (two tenants,
    a 96-request steady phase, a watchdog trip on engine sim1 at
    t=6s and a 48-request tenant_flood on tenant1 at t=10s) compiles
    to one seeded trace; a two-SimulatedEngine pool (shared
    calibrated CostModel — same group identity) behind a
    tenancy-armed EngineRouter replays it on a virtual clock with a
    FlightRecorder installed. Pins:

    * the chaos timeline FIRES: both entries inject (`chaos_inject`
      events), the watchdog trip degrades exactly sim1 with reason
      'chaos_watchdog', sim1's in-flight work fails over to sim0, and
      the flood's arrivals land as tenant1 traffic;
    * the trip is an INCIDENT: exactly one flight-recorder bundle,
      manifest naming engine_degraded on sim1;
    * containment holds under chaos: every throttle (defer + the
      flood's sheds) bills to tenant1 — tenant0 finishes every
      request with zero throttles;
    * zero lost: every compiled arrival reaches a terminal status;
    * two replays are BYTE-IDENTICAL — the full report JSON (digest)
      AND every flight-recorder bundle file, byte for byte. The
      simulator's virtual clock + the scenario's single seeded stream
      make the whole ops plane a pure function of the spec."""
    from bigdl_tpu_torch.obs.flightrecorder import FlightRecorder
    from bigdl_tpu_torch.serving import (EngineRouter, TenancyController,
                                   TenantSpec)
    from bigdl_tpu_torch.serving.scenarios import compile_scenario
    from bigdl_tpu_torch.serving.sim import CostModel, SimulatedEngine

    cost = _SIM_COST if _SIM_COST is not None else CostModel.default()

    def run(outdir):
        trace = compile_scenario("chaos_smoke")
        clk = {"t": 0.0}

        def c():
            return clk["t"]

        with _telemetry(clock=c) as log:
            fc = trace["fleet"]
            # explicit obs labels: the scenario's chaos targets name
            # engines ("sim1") — the ctor's process-global fallback
            # counter would drift on the second run
            pool = [SimulatedEngine(cost, clock=c, slots=fc["slots"],
                                    max_queue=fc["max_queue"],
                                    overload_policy=fc[
                                        "overload_policy"],
                                    pacing=fc["pacing"],
                                    obs_label=f"sim{i}")
                    for i in range(fc["engines"])]
            tenancy = TenancyController(
                [TenantSpec(**kw) for kw in trace["tenants"]],
                clock=c)
            router = EngineRouter(pool, clock=c, tenancy=tenancy,
                                  obs_label="r0")
            rec = FlightRecorder(outdir, clock=c)
            for eng in pool:
                rec.register_health_source(eng.obs_name, eng.health)
            rec.install()
            report = loadgen.replay(router, trace, clock=clk)
            rec.close()
            events = log.events()
        return report, events, rec, pool

    r1, ev1, rec1, pool1 = run(os.path.join(workdir, "run1"))
    r2, ev2, rec2, _ = run(os.path.join(workdir, "run2"))
    d1 = json.dumps(r1, sort_keys=True)
    d2 = json.dumps(r2, sort_keys=True)

    chaos_ev = [e for e in ev1 if e["kind"] == "chaos_inject"]
    degraded_ev = [e for e in ev1 if e["kind"] == "engine_degraded"]
    throttle_ev = [e for e in ev1 if e["kind"] == "tenant_throttled"]
    billed = {e["tenant"] for e in throttle_ev}
    chaos_ok = (sorted(e["action"] for e in chaos_ev)
                == ["tenant_flood", "watchdog_trip"]
                and r1["scenario"]["fired"]["chaos"] == 2)
    trip_ok = (len(degraded_ev) == 1
               and degraded_ev[0]["engine"] == "sim1"
               and degraded_ev[0]["reason"] == "chaos_watchdog"
               and pool1[1].degraded == "chaos_watchdog"
               and pool1[0].degraded is None)
    t0 = r1["tenants"]["tenant0"]
    contained = (billed == {"tenant1"}
                 and t0["throttled"] == {"deferred": 0, "shed": 0}
                 and t0["done"] == t0["requests"])
    zero_lost = (sum(r1["by_status"].values()) + r1["rejected"]
                 == r1["requests"])

    b1 = _bundle_bytes(os.path.join(workdir, "run1"))
    b2 = _bundle_bytes(os.path.join(workdir, "run2"))
    identical_bundles = bool(b1) and b1 == b2
    manifest = json.loads(b1[os.path.join(
        rec1.bundles[0], "manifest.json")]) if rec1.bundles else {}
    bundle_ok = (len(rec1.bundles) == 1
                 and manifest.get("incident") == "engine_degraded"
                 and manifest.get("component") == "sim1")

    counts = {}
    for e in ev1:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    ok = (chaos_ok and trip_ok and contained and zero_lost
          and bundle_ok and identical_bundles and d1 == d2)
    return {"ok": bool(ok),
            "chaos_fired": r1["scenario"]["fired"],
            "by_status": r1["by_status"],
            "watchdog_trip_ok": trip_ok,
            "throttle_billed_to": sorted(billed),
            "tenant0_untouched": contained,
            "bundles": rec1.bundles,
            "bundles_byte_identical": identical_bundles,
            "report_byte_identical": d1 == d2,
            "events": dict(sorted(counts.items()))}


# the mesh legs' bodies, run on every rank of a MESH_WORLD group
_MESH_BODIES = {
    "nan_skip_mesh": lambda wd: drill_nan_skip(wd, mesh=True),
    "preempt_resume": drill_preempt_resume,
    "ckpt_async_torn": drill_ckpt_async_torn,
    "torn_shard": drill_torn_shard,
}

TRAINING_LEGS = {
    "nan_skip": drill_nan_skip,
    "nan_skip_mesh": _mesh_leg("nan_skip_mesh"),
    "rollback": drill_rollback,
    "step_retry": drill_step_retry,
    "data_retry": drill_data_retry,
    "ckpt_torn": drill_ckpt_torn,
    "ckpt_fallback": drill_ckpt_fallback,
    # elastic-training legs (ZeRO-2 + async sharded ckpt)
    "preempt_resume": _mesh_leg("preempt_resume"),
    "ckpt_async_torn": _mesh_leg("ckpt_async_torn"),
    "torn_shard": _mesh_leg("torn_shard"),
    "worldsize_resume": drill_worldsize_resume,
}
# the legs that run in this one process
SINGLE_PROCESS_TRAINING_LEGS = ("nan_skip", "rollback", "step_retry",
                                "data_retry", "ckpt_torn", "ckpt_fallback")

SERVING_LEGS = {
    "serve_poison": drill_serve_poison,
    "serve_overload": drill_serve_overload,
    "serve_deadline": drill_serve_deadline,
    "serve_retry": drill_serve_retry,
    "serve_watchdog": drill_serve_watchdog,
    "serve_prefix": drill_serve_prefix,
    "serve_spill": drill_serve_spill,
    "serve_spec": drill_serve_spec,
    "spec_adapt": drill_spec_adapt,
    "fleet_failover": drill_fleet_failover,
    "fleet_affinity_failover": drill_fleet_affinity_failover,
    "fleet_drain": drill_fleet_drain,
    "fleet_autoscale": drill_fleet_autoscale,
    "fleet_tp_failover": drill_fleet_tp_failover,
    "fleet_journey": drill_fleet_journey,
    "slo_alert": drill_slo_alert,
    "tenant_noisy": drill_tenant_noisy,
    "scenario_chaos": drill_scenario_chaos,
}

LEGS = {**TRAINING_LEGS, **SERVING_LEGS}

PLANES = {"training": TRAINING_LEGS, "serving": SERVING_LEGS,
          "all": LEGS}


def join_step_threads(timeout: float = 2.0) -> None:
    """Give the step threads the watchdog legs abandoned (by design —
    the thread models a hung device call) a bounded window to wind down,
    so interpreter teardown never races a live CUDA call. A thread stuck
    in a REAL hang is a daemon: the join times out and exit proceeds."""
    import threading

    for th in threading.enumerate():
        if th is not threading.current_thread() and th.daemon \
                and th.name.startswith("bigdl-serving-step"):
            th.join(timeout=timeout)


def run_legs(names, device="cuda", **weights) -> dict:
    """Run the legs `names` on `device` (configure()'s keywords pass
    through), each in a temporary directory; {leg: digest}."""
    import torch

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: torch sees no CUDA device (pass "
            "--device cpu to run the legs on the host)")
    configure(device, **weights)
    results = {}
    try:
        for name in names:
            with tempfile.TemporaryDirectory(prefix=f"fault_{name}_") as wd:
                results[name] = LEGS[name](wd)
    finally:
        join_step_threads()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plane", default="all", choices=sorted(PLANES),
                    help="which drill plane to run (default: all)")
    ap.add_argument("--legs", default=None,
                    help="comma subset of legs (overrides --plane)")
    ap.add_argument("--device", default="cuda",
                    help="where the legs run: cuda (default; raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)
    legs = args.legs.split(",") if args.legs \
        else list(PLANES[args.plane])
    results = run_legs(legs, args.device)
    for name, r in results.items():
        print(json.dumps({"leg": name, **r}))
    ok = all(r["ok"] for r in results.values())
    print(json.dumps({"ok": ok, "legs": list(results)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
