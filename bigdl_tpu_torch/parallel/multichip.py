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
against `ops.flash_attention` on the whole sequence (ULYSSES_TOL).
Rank 0 computes each oracle on its own device (the single-device loss; for the expert
step the mean of the per-rank-chunk losses, each chunk routed alone as
the rank routes it). The first loss must agree within LOSS_TOL
relative, or the run fails. Rank 0 prints one JSON line — per case
the losses, the oracle, ms a step and the flash launches of the first
step — and writes it to chiprun_out/multichip.json under the working
directory.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
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
    args = ap.parse_args(argv)
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

    case("tp_sp_ring", {"data": 1, "model": 2, "seq": 2}, tp("ring"), init,
         dense_oracle)
    case("tp_sp_zigzag", {"data": 1, "model": 2, "seq": 2}, tp("zigzag"),
         init, dense_oracle)
    case("dp_tp", {"data": 2, "model": 2}, tp("ring"), init, dense_oracle)
    case("gpipe", {"pipe": 4}, pipe(1), init, dense_oracle)
    case("interleaved", {"pipe": 4}, pipe(2), init, dense_oracle)
    case("ep", {"expert": 4}, ep, moe_init, ep_oracle)

    # Ulysses over the seq axis: the flash kernels on 2 heads of the
    # whole sequence each, against one flash call over every head
    from bigdl_tpu_torch.ops.flash_attention import flash_attention

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
    if rank == 0:
        line = json.dumps(out)
        print(line, flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "multichip.json"), "w") as f:
            f.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
