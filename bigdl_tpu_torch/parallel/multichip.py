"""The parallel strategies across ranks, one process a device: each
step against its single-device oracle, and its time.

No JAX counterpart (the JAX package's `__graft_entry__.py` multichip
legs check the same behaviours on one program's devices). Run under
torchrun, one process a card:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m bigdl_tpu_torch.parallel.multichip           # 4 cards, NCCL
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m bigdl_tpu_torch.parallel.multichip --cpu --tiny   # gloo

On 4 ranks, from seeded weights and one seeded batch, each case runs
one step then STEPS timed steps (SGD, fp32, the full log-softmax loss):
dp x tp x sp on {data: 1, model: 2, seq: 2} with ring and with zigzag
attention and on {data: 2, model: 2}; GPipe over {pipe: 4} and the
interleaved schedule with 2 virtual stages; the MoE LM's
expert-parallel step over {expert: 4}; Ulysses attention over {seq: 4}
against `ops.flash_attention` on the whole sequence (ULYSSES_TOL);
and tensor-parallel serving (serving/tp.py): the 43M LM serves the
repository's serving wave (16 ragged greedy requests through 8 slots,
prefill buckets 256/512, 64 new tokens each) through
`InferenceEngine(model, tp_mesh=mesh)` on {data: 2, model: 2} (a mesh
spans the world: each data row serves the wave alike) and on {model:
4}, against the unsharded engine on rank 0 — every rank's tokens and
statuses bitwise equal, the paged-decode kernel's launches exact, the
serving tree resharded tp 2 -> host -> tp 4 bit for bit; decode ms a
step, tokens/s and each rank's pool bytes; with `--profile`, where
PROFILE_STEPS decode steps of a third wave spend their time
(torch.profiler: the top self-CPU and device rows a step, and the
engine's lockstep round trips a step). The tp_stall leg serves the
wave on {data: 2, model: 2} under the step watchdog with the ranks of
model coordinate 1 stalled before their dispatch at decode step 3, so
the others' gathers wait for peers that never come: every rank must
degrade with one watchdog trip, retire the wrapper, and then serve the
wave through a fresh engine on the same mesh with the oracle's tokens
(STALL_DEADLINE_S ends a rank that hangs). `--legs tp_serve` runs only
that leg.
Rank 0 computes each oracle on its own device (the single-device loss; for the expert
step the mean of the per-rank-chunk losses, each chunk routed alone as
the rank routes it). The first loss must agree within LOSS_TOL
relative, or the run fails. Rank 0 prints one JSON line — the cards'
`nvidia-smi` names and power limits, per case the losses, the oracle,
ms a step and the flash launches of the first step — and writes it to chiprun_out/multichip.json under the working
directory.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import (make_mesh, make_moe_lm_train_step,
                                      make_pipeline_train_step,
                                      make_ring_attention,
                                      make_transformer_train_step,
                                      shard_params, to_virtual_layout)

# the 43M LM (bench.py bench_lm(512, 8, 8, 8, 2048, ...)), batch 8
FULL = dict(vocab_size=32000, max_len=2048, dim=512, num_heads=8,
            num_layers=8)
TINY = dict(vocab_size=101, max_len=32, dim=32, num_heads=4, num_layers=8)
BATCH, STEPS, LR = 8, 3, 0.1
MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
LOSS_TOL = 1e-4
# Ulysses vs one flash call: the flash kernels' bf16 output tolerance
# (chip_smoke.py FLASH_TOL), fp32 on the CPU
ULYSSES_TOL = {"cuda": 2e-2, "cpu": 1e-5}
# the serving wave (chip_smoke.py phase_engine's): prompt lengths, new
# tokens, slots, prefill buckets, block size and cache length; TINY's
# fits the toy model's 32 positions
SERVE_FULL = dict(lens=(512, 253, 495, 170), new=64, slots=8,
                  buckets=(256, 512), block=16, max_len=592)
SERVE_TINY = dict(lens=(12, 7, 10, 5), new=8, slots=8, buckets=(8, 16),
                  block=4, max_len=32)
LEGS = ("train", "ulysses", "tp_serve", "tp_stall")
PROFILE_STEPS = 20
# the tp_stall leg's watchdog budget and the stalled ranks' sleep (5x),
# and the wall-clock limit after which a rank ends itself
STALL_TIMEOUT_S, STALL_DEADLINE_S = 2.0, 240.0


def _flash_counts():
    # the module, not the function `bigdl_tpu_torch.ops` exports
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")
    return fa.fwd_launches, fa.bwd_launches


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()


def _run(step, params, tokens, targets, device):
    """One step, then STEPS timed: (losses, ms a step, the first step's
    flash launches)."""
    slots = SGD(LR, momentum=0.9, dampening=0.0).init_slots(
        tree_leaves(params))
    losses, t0 = [], None
    for i in range(STEPS + 1):
        f0, b0 = _flash_counts()
        params, slots, loss = step(params, slots, tokens, targets, LR, i,
                                   None)
        losses.append(float(loss))
        if i == 0:
            f1, b1 = _flash_counts()
            launches = (f1 - f0, b1 - b0)
            _sync(device)
            t0 = time.perf_counter()
    _sync(device)
    return losses, (time.perf_counter() - t0) / STEPS * 1e3, launches


def _full_loss(cfg, params, tokens, targets):
    logp, _ = TransformerLM(cfg, device=tokens.device).apply(
        {"params": params}, tokens)
    return float(-logp.gather(-1, targets.long()[..., None]).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU")
    ap.add_argument("--tiny", action="store_true",
                    help="toy widths, for rehearsals")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated subset of {LEGS}")
    ap.add_argument("--profile", action="store_true",
                    help="profile the tp_serve leg's decode steps")
    args = ap.parse_args(argv)
    legs = set(args.legs.split(","))
    if legs - set(LEGS):
        raise SystemExit(f"unknown legs {sorted(legs - set(LEGS))}")
    device = torch.device("cpu") if args.cpu else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300))
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        raise SystemExit(f"multichip runs on 4 ranks, got {world}")
    widths = TINY if args.tiny else FULL
    cfg = TransformerConfig(**widths)
    moe_cfg = TransformerConfig(**widths, **MOE)
    g = torch.Generator().manual_seed(0)
    init = TransformerLM(cfg, device="cpu").init_params(g)
    moe_init = TransformerLM(moe_cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    seq = widths["max_len"]
    data = torch.randint(0, widths["vocab_size"], (2, BATCH, seq),
                         generator=torch.Generator().manual_seed(2))
    tokens, targets = (t.to(device) for t in data)
    out = {"world": world, "backend": dist.get_backend(),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           # every card's name and power limit: a capped card runs slower
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60, check=True).stdout.strip().splitlines()
           if device.type == "cuda" else None,
           "widths": widths, "batch": BATCH, "steps": STEPS}

    def case(name, axes, build, tree, oracle):
        mesh = make_mesh(axes, device)
        step, tree = build(mesh, tree)
        params = shard_params(mesh, step.specs, tree)
        losses, ms, launches = _run(step, params, tokens, targets, device)
        want = oracle() if rank == 0 else None
        rel = None if want is None else abs(losses[0] - want) / abs(want)
        out[name] = {"mesh": axes, "losses": losses, "oracle": want,
                     "loss_rel_diff": rel, "step_ms": ms,
                     "launches": {"fwd": launches[0], "bwd": launches[1]}}
        if rel is not None and rel > LOSS_TOL:
            raise SystemExit(f"multichip {name}: loss {losses[0]} vs "
                             f"single-device {want}")

    def tp(mode):
        def build(mesh, tree):
            model = TransformerLM(cfg, device=device, tp_axis="model",
                                  sp_axis="seq" if "seq" in mesh.shape
                                  and mesh.shape["seq"] > 1 else None,
                                  sp_mode=mode)
            return make_transformer_train_step(
                model, SGD(LR, momentum=0.9, dampening=0.0), mesh, "data",
                "model", model.sp_axis), tree
        return build

    def pipe(v):
        def build(mesh, tree):
            step = make_pipeline_train_step(
                TransformerLM(cfg, device=device),
                SGD(LR, momentum=0.9, dampening=0.0), mesh, "pipe",
                microbatches=BATCH, virtual_stages=v)
            return step, to_virtual_layout(tree, 4, v) if v > 1 else tree
        return build

    def ep(mesh, tree):
        model = TransformerLM(moe_cfg, device=device, ep_axis="expert")
        return make_moe_lm_train_step(
            model, SGD(LR, momentum=0.9, dampening=0.0), mesh,
            "expert"), tree

    def dense_oracle():
        return _full_loss(cfg, tree_map(lambda t: t.to(device), init),
                          tokens, targets)

    def ep_oracle():
        model = TransformerLM(moe_cfg, device=device)
        p = tree_map(lambda t: t.to(device), moe_init)
        with torch.no_grad():
            return sum(float(model.loss({"params": p}, x, y))
                       for x, y in zip(tokens.chunk(4), targets.chunk(4))) / 4

    if "train" in legs:
        case("tp_sp_ring", {"data": 1, "model": 2, "seq": 2}, tp("ring"),
             init, dense_oracle)
        case("tp_sp_zigzag", {"data": 1, "model": 2, "seq": 2},
             tp("zigzag"), init, dense_oracle)
        case("dp_tp", {"data": 2, "model": 2}, tp("ring"), init,
             dense_oracle)
        case("gpipe", {"pipe": 4}, pipe(1), init, dense_oracle)
        case("interleaved", {"pipe": 4}, pipe(2), init, dense_oracle)
        case("ep", {"expert": 4}, ep, moe_init, ep_oracle)
    if "ulysses" in legs:
        _ulysses(out, widths, device)
    knobs = SERVE_TINY if args.tiny else SERVE_FULL
    if "tp_serve" in legs:
        out["tp_serve"] = _tp_serve(cfg, init, device, knobs, args.profile)
    if "tp_stall" in legs:
        out["tp_stall"] = _tp_stall(cfg, init, device, knobs)
    if rank == 0:
        line = json.dumps(out)
        print(line, flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "multichip.json"), "w") as f:
            f.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _ulysses(out, widths, device) -> None:
    """Ulysses over the seq axis: the flash kernels on 2 heads of the
    whole sequence each, against one flash call over every head."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention

    seq = widths["max_len"]
    mesh = make_mesh({"seq": 4}, device)
    h = widths["num_heads"]
    qkv = torch.randn(3, BATCH, h, seq, widths["dim"] // h,
                      generator=torch.Generator().manual_seed(3)).to(
        device, torch.bfloat16 if device.type == "cuda" else torch.float32)
    fn = make_ring_attention(mesh, "seq", causal=True, mode="ulysses")
    got = fn(*qkv)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        fn(*qkv)
    _sync(device)
    want = flash_attention(*qkv, causal=True)
    out["ulysses"] = {"shape": list(qkv.shape[1:]),
                      "max_abs_diff": float((got - want).abs().max()),
                      "ms": (time.perf_counter() - t0) / STEPS * 1e3}
    if out["ulysses"]["max_abs_diff"] > ULYSSES_TOL[device.type]:
        raise SystemExit(f"multichip ulysses: {out['ulysses']}")


def _serving(cfg, init, device, knobs):
    """(model, params, engine keywords, wave(seed), sync) of the
    serving legs: the wave is 2 x slots ragged greedy requests."""
    import numpy as np

    from bigdl_tpu_torch.serving import Request

    model = TransformerLM(cfg, device=device)
    params = tree_map(lambda t: t.to(device), init)
    eng_kw = dict(slots=knobs["slots"], prefill_buckets=knobs["buckets"],
                  block_size=knobs["block"], max_len=knobs["max_len"],
                  device=device)

    def wave(seed):
        rng = np.random.RandomState(seed)
        lens = (list(knobs["lens"]) * 4)[:2 * knobs["slots"]]
        return [Request(prompt=[int(t) for t in rng.randint(
            1, cfg.vocab_size, n)], max_new_tokens=knobs["new"],
            seed=seed + i) for i, n in enumerate(lens)]

    def sync():            # this rank only: rank 0 times the oracle alone
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return model, params, eng_kw, wave, sync


def _oracle(model, params, eng_kw, wave):
    """Rank 0's unsharded engine on wave(100), broadcast to every rank
    as (status, finish reason, tokens) per request."""
    from bigdl_tpu_torch.serving import InferenceEngine

    box = [None]
    if dist.get_rank() == 0:
        box = [[(r.status, r.finish_reason, r.tokens) for r in
                InferenceEngine(model, params, **eng_kw).run(wave(100))]]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _profiled(eng, wave, sync, device):
    """Where PROFILE_STEPS decode steps of a full batch spend their time,
    per step: wall ms, lockstep round trips, the top self-CPU and
    device rows of torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for r in wave(200):
        eng.submit(r)
    while eng.queue_depth:              # admit (prefill) the first slots
        eng.step()
    sync()
    n0 = getattr(eng.model, "rendezvous", 0)   # 0: unsharded
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])) \
            as prof:
        if eng.tp > 1:
            # every rank serves: start the steps together, not while a
            # peer still brings its profiler up
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        sync()
        ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    trips = getattr(eng.model, "rendezvous", 0) - n0
    eng.run()
    rows = [(e.key, e.count / PROFILE_STEPS,
             e.self_cpu_time_total / PROFILE_STEPS / 1e3,
             (getattr(e, "self_device_time_total", 0) or 0)
             / PROFILE_STEPS / 1e3) for e in prof.key_averages()]
    return {"step_ms": ms,
            "lockstep_per_step": trips / PROFILE_STEPS,
            "top_self_cpu_ms": sorted(rows, key=lambda r: -r[2])[:14],
            "top_device_ms": sorted(rows, key=lambda r: -r[3])[:8]}


def _tp_serve(cfg, init, device, knobs, profiled=False):
    """The serving wave through the unsharded engine (rank 0, the
    oracle) and through `InferenceEngine(tp_mesh=...)` on
    {data: 2, model: 2} and {model: 4}; the tp 2 -> tp 4 reshard."""
    import numpy as np

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import (InferenceEngine,
                                         gather_serving_params,
                                         shard_serving_params)

    model, params, eng_kw, wave, sync = _serving(cfg, init, device, knobs)

    def timed(eng):
        """(results, decode steps, seconds, K1 launches) of the timed
        wave after a warm-up wave; launches counted from 0."""
        eng.run(wave(0))
        sync()
        steps0 = eng.stats["decode_steps"]
        paged_decode.launches = 0
        t0 = time.perf_counter()
        res = eng.run(wave(100))
        sync()
        return (res, eng.stats["decode_steps"] - steps0,
                time.perf_counter() - t0, paged_decode.launches)

    def summary(res, steps, dt, launches, eng):
        n_tok = sum(len(r.tokens) for r in res)
        return {"decode_steps": steps, "step_ms": dt / steps * 1e3,
                "tokens_per_sec": n_tok / dt, "launches": launches,
                "pool_bytes": sum(t.numel() * t.element_size()
                                  for layer in eng.pool
                                  for t in layer.values())}

    result = {"knobs": knobs}
    oracle = None
    if dist.get_rank() == 0:
        ref = InferenceEngine(model, params, **eng_kw)
        res, steps, dt, launches = timed(ref)
        oracle = [(r.status, r.finish_reason, r.tokens) for r in res]
        result["unsharded"] = summary(res, steps, dt, launches, ref)
        if profiled:
            result["unsharded"]["profile"] = _profiled(ref, wave, sync,
                                                       device)
        del ref
    box = [oracle]
    dist.broadcast_object_list(box, src=0)
    oracle = box[0]
    hosts = {}
    for name, axes in (("tp2", {"data": 2, "model": 2}),
                       ("tp4", {"model": 4})):
        mesh = make_mesh(axes, device)
        eng = InferenceEngine(model, params, tp_mesh=mesh, **eng_kw)
        res, steps, dt, launches = timed(eng)
        got = [(r.status, r.finish_reason, r.tokens) for r in res]
        # the kernel on the card; the CPU engine serves the plain version
        if launches != (steps * cfg.num_layers
                        if device.type == "cuda" else 0):
            raise SystemExit(f"multichip tp_serve {name}: {launches} "
                             f"kernel launches, {steps} steps")
        if got != oracle:
            bad = sum(a != b for a, b in zip(got, oracle))
            raise SystemExit(f"multichip tp_serve {name}: {bad} of "
                             f"{len(got)} requests differ from the "
                             "unsharded engine's")
        # every rank's pool bytes, gathered to each rank
        mine = summary(res, steps, dt, launches, eng)
        pools = [None] * dist.get_world_size()
        dist.all_gather_object(pools, mine["pool_bytes"])
        result[name] = {"mesh": axes, **mine, "pool_bytes": pools,
                        "tokens_bitwise": True}
        if profiled:
            result[name]["profile"] = _profiled(eng, wave, sync, device)
        hosts[name] = (mesh, eng._params)
    mesh2, sp2 = hosts["tp2"]
    mesh4, _ = hosts["tp4"]
    host2 = gather_serving_params(sp2, mesh2)
    host4 = gather_serving_params(shard_serving_params(mesh4, host2),
                                  mesh4)
    whole = gather_serving_params(model.serving_params(params))
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(tree_leaves(host2), tree_leaves(host4),
                                  tree_leaves(whole)))
    if not same:
        raise SystemExit("multichip tp_serve: the tp 2 -> tp 4 reshard "
                         "moved a bit")
    result["reshard_bitwise"] = True
    return result


def _tp_stall(cfg, init, device, knobs):
    """The one-sided straggler (see the module docstring)."""
    import threading

    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.utils import faults

    model, params, eng_kw, wave, sync = _serving(cfg, init, device, knobs)
    oracle = _oracle(model, params, eng_kw, wave)
    mesh = make_mesh({"data": 2, "model": 2}, device)
    stalled = mesh.coord("model") == 1
    limit = threading.Timer(STALL_DEADLINE_S, os._exit, (7,))
    limit.daemon = True
    limit.start()
    eng = InferenceEngine(model, params, tp_mesh=mesh,
                          step_timeout_s=STALL_TIMEOUT_S, **eng_kw)
    if stalled:
        faults.set_plan(faults.FaultPlan("serve_slow@3"))
    t0 = time.perf_counter()
    try:
        res = eng.run(wave(100))
    finally:
        faults.set_plan(None)
    trip_s = time.perf_counter() - t0
    waiting = [th for th in threading.enumerate()
               if th.name == "bigdl-serving-step"]
    # NCCL: the aborted communicator frees a waiting gather; gloo
    # cannot abort, its gather ends when the peers' groups close
    t1 = time.perf_counter()
    for th in waiting if mesh.backend == "nccl" else ():
        th.join(STALL_DEADLINE_S / 4)
    freed_s = time.perf_counter() - t1
    left = sum(th.is_alive() for th in waiting) \
        if mesh.backend == "nccl" else 0
    if eng.health()["state"] != "degraded" \
            or eng.stats["watchdog_trips"] != 1 \
            or {r.status for r in res} != {"failed"} or left:
        raise SystemExit(f"multichip tp_stall: state "
                         f"{eng.health()['state']}, trips "
                         f"{eng.stats['watchdog_trips']}, statuses "
                         f"{sorted({r.status for r in res})}, {left} "
                         "abandoned step thread(s) still waiting")
    fresh = InferenceEngine(model, params, tp_mesh=mesh, **eng_kw)
    if fresh.model is eng.model:
        raise SystemExit("multichip tp_stall: the abandoned wrapper "
                         "was served again")
    got = [(r.status, r.finish_reason, r.tokens)
           for r in fresh.run(wave(100))]
    sync()
    limit.cancel()
    if got != oracle:
        raise SystemExit("multichip tp_stall: the fresh engine's tokens "
                         "differ from the unsharded engine's")
    # per rank: stalled or not, whether its own watchdog tripped (the
    # others' steps waited in a gather), step threads still alive when
    # run() returned and how long they took to end
    mine = {"stalled": stalled, "own_trip": "exceeded" in
            eng.health()["degraded_reason"], "trip_s": trip_s,
            "threads_alive_after": len(waiting),
            "threads_freed_s": freed_s}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"mesh": dict(mesh.shape), "ranks": ranks,
            "fresh_tokens_bitwise": True}


if __name__ == "__main__":
    sys.exit(main())
