#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --profile  # also: where decode and train steps go

It drives `bigdl_tpu_torch` only (never JAX or the JAX package):

1. device — the card's name and `nvidia-smi` name/power limit;
2. build  — compiles every CUDA kernel from the sources in the checkout
   (`bigdl_tpu_torch/ops/_build.py`: one nvcc per source for sm_90a, all
   started together) and reports ptxas registers/spills;
3. kernel — the paged-decode kernel against its plain PyTorch version
   at the engine's shape (B=8, H=8, 37 blocks of 16, D=64) with
   shuffled tables, ragged clocks including 0 and S-1 and a NaN
   scratch block 0, for fp32 and bf16 pools (max abs err <= 2e-5);
   each row of a B=8 launch must be BITWISE the same row launched
   alone; times with CUDA events, L2 flushed before each launch;
4. flash  — the flash-attention kernels (forward; backward = dk/dv +
   dq launches) against their plain versions on FLASH_CASES: the
   training shape (BH=64, S=2048, D=64, causal), a long sequence
   (BH=8, S=8192), ragged lengths with Sq != Sk and fully masked rows,
   D = 32/128, no mask, sm_scale = 0; fp32 and bf16; bf16 also element
   by element (in bf16 ulps) against the plain versions that round
   where the kernels round, while the same versions without the
   roundings must fail that check; two backward runs bitwise equal;
   gradients through both outputs of flash_attention_with_lse, kernels
   vs plain; kernel, plain and SDPA (library yardstick) times at the
   first two;
5. model  — the 43M Transformer-LM at full width: `decode_step_paged`
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
9. kernels — one JSON line per the port's kernel table.

Every phase prints one JSON line; any failed check raises and the
script exits non-zero. The last lines are the `nvidia-smi` name/power
limit and `{"ok": true, "device": {...}}`. Full results, with the
compiler's register report, go to chiprun_out/chip_smoke.json.
TF32 is off for matmuls and cuDNN, so fp32 means fp32 throughout.
"""

from __future__ import annotations

import json
import math
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

KERNEL_SOURCES = ("paged_decode", "flash_attention")
BF16_FLOPS_PER_S = 989e12       # dense tensor-core bf16 peak (data sheet)

# flash-attention cases: (name, BH, Sq, Sk, D, causal, sm_scale or None).
# "train" is the trainer's shape (B=8 x H=8, S=2048, D=64); "long" a long
# sequence, the JAX package's split-backward route; the rest ragged
# lengths (not multiples of the 64-row tile), Sq > Sk with fully masked
# rows, D = 32/128, no causal mask, and sm_scale == 0.
FLASH_CASES = (
    ("train", 64, 2048, 2048, 64, True, None),
    ("long", 8, 8192, 8192, 64, True, None),
    ("ragged", 6, 1000, 1500, 128, True, None),
    ("masked_rows", 4, 1500, 1000, 32, True, None),
    ("noncausal", 4, 777, 777, 64, False, None),
    ("zero_scale", 2, 300, 300, 64, True, 0.0),
)
FLASH_TIMED = ("train", "long")
# kernel vs plain: forward out (max abs), lse (fp32, max abs), backward
# (max abs relative to each gradient's max)
FLASH_TOL = {"fp32": {"out": 2e-5, "lse": 2e-5, "grad": 1e-4},
             "bf16": {"out": 2e-2, "lse": 2e-5, "grad": 5e-2}}
# bf16, element by element: the kernels against the tiled plain versions
# that round where the kernels round (ops.flash_attention.
# flash_forward_tiled / flash_backward_tiled, fp32 results). At most
# BF16_MISMATCH_TOL of the elements may differ from the plain value
# rounded once to bf16, and every element lies within BF16_ULP_TOL bf16
# ulps of it. The ulp is that of max(|value|, its row's RMS, 2^-8 of
# the tensor's RMS): near-zero elements of a row that cancels, and rows
# that are zero in exact arithmetic (dq of a query that sees one key),
# are measured on a scale their fp32 noise cannot reach. The ulp limit
# leaves room for one p or ds that the two fp32 sums round to
# neighbouring bf16 values: in a row of few terms that moves the result
# by up to about two ulps. The control is the same plain versions
# without the roundings: wherever a rounding changes a value (every
# case but zero_scale) its mismatch share must exceed
# BF16_MISMATCH_TOL, or the check could not see a rounding left out.
BF16_ULP_TOL, BF16_MISMATCH_TOL = 4.0, 0.02
# fp32 gradients through both outputs of flash_attention_with_lse,
# kernels vs plain, relative to each gradient's max (FLASH_TOL "grad")
WITH_LSE_CASES = ("ragged", "masked_rows")

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

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
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
    pools and weights, so the real caller finds L2 cold."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phases
def phase_build():
    from bigdl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)             # one nvcc per source, together
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOG.get(
        name, "").splitlines() if "registers" in ln or "spill" in ln]
        for name in KERNEL_SOURCES}
    RESULTS["build_log"] = _build.BUILD_LOG
    emit("build", seconds=seconds, kernels=list(KERNEL_SOURCES),
         ptxas={name: lines[:8] for name, lines in ptxas.items()})


def _decode_case(pool_dtype, dev, B=SLOTS, H=HEADS, nb=MAX_LEN // BLOCK,
                 bs=BLOCK, D=DIM // HEADS, seed=0):
    """Engine-shaped paged-decode inputs on the card: every row's table
    a shuffled chain of pool blocks, entries past the row's clock
    pointing at the NaN scratch block 0, ragged clocks with 0 and
    S - 1 among them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = B * nb + 1
    k = torch.randn(n, H, bs, D, generator=g)
    v = torch.randn(n, H, bs, D, generator=g)
    k[0] = float("nan")
    v[0] = float("nan")
    table = (torch.randperm(n - 1, generator=g)[:B * nb] + 1).reshape(B, nb)
    seq = nb * bs
    pos = torch.randint(0, seq, (B,), generator=g)
    pos[0], pos[1] = 0, seq - 1
    for r in range(B):
        table[r, int(pos[r]) // bs + 1:] = 0
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
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops.kv_cache import gather_block_cache
    from bigdl_tpu_torch.ops.paged_decode import paged_decode_attention

    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, table, pos = _decode_case(dtype, flush.device)
        got = paged_decode_attention(q, k, v, table, pos, impl="cuda")
        ref = paged_decode_attention(q, k, v, table, pos, impl="torch")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"{name}: kernel output not finite")
        err = float((got - ref).abs().max())
        check(err <= KERNEL_TOL, f"{name}: max abs err {err} > "
              f"{KERNEL_TOL}")
        for r in range(q.shape[0]):
            alone = paged_decode_attention(
                q[r:r + 1], k, v, table[r:r + 1].contiguous(),
                pos[r:r + 1].contiguous(), impl="cuda")
            check(torch.equal(alone, got[r:r + 1]),
                  f"{name}: row {r} alone differs from the B=8 launch")
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
        out[name] = res
    emit("kernel", shape={"B": SLOTS, "H": HEADS, "nb": MAX_LEN // BLOCK,
                          "bs": BLOCK, "D": DIM // HEADS},
         tolerance=KERNEL_TOL, **out)
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


def _ulp_stats(got, ref) -> dict:
    """got (bf16) against ref (fp32): the largest error in bf16 ulps of
    max(|ref|, the RMS of ref's row, 2^-8 of ref's RMS), and the share
    of elements unequal to ref rounded to bf16."""
    import torch

    r = ref.float()
    mag = torch.maximum(r.abs(), r.pow(2).mean(-1, keepdim=True).sqrt())
    mag = torch.maximum(mag, 2.0 ** -8 * r.pow(2).mean().sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return {"max_ulps": float(((got.float() - r).abs() / ulp).max()),
            "mismatch": float((got != r.to(got.dtype)).float().mean())}


def _bf16_rounding(fa, where, q, k, v, o, lse, do, grads, causal, scale,
                   gate_control: bool) -> dict:
    """The bf16 kernels' out and dq/dk/dv against the tiled plain
    versions with the kernels' roundings ("matched") and without them
    ("control"), on the same inputs (the backward's o and lse are the
    kernel's)."""
    res = {}
    for label, rounded in (("matched", True), ("control", False)):
        fo, _ = fa.flash_forward_tiled(q, k, v, causal, scale,
                                       round_operands=rounded)
        fg = fa.flash_backward_tiled(q, k, v, o, lse, do, causal, scale,
                                     round_operands=rounded)
        res[label] = {n: _ulp_stats(a, b) for n, a, b in zip(
            ("out", "dq", "dk", "dv"), (o, *grads), (fo, *fg))}
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

    from bigdl_tpu_torch.ops import flash_attention as fa

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
            o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
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
            del q, k, v, do, o, lse, ro, rlse, grads, again, refs
    torch.cuda.empty_cache()
    summary = {key: {k: r[k] for k in (
        "out_max_abs_err", "lse_max_abs_err", "grad_rel_err",
        "with_lse_grad_rel_err", "fwd_ms", "bwd_ms", "plain_fwd_ms",
        "plain_bwd_ms", "sdpa_fwd_ms", "sdpa_bwd_ms") if k in r}
        for key, r in out.items()}
    for key, r in out.items():
        if "rounding" in r:      # the worst tensor of each reading
            summary[key]["rounding"] = {
                label: {st: max(x[st] for x in r["rounding"][label]
                                .values())
                        for st in ("max_ulps", "mismatch")}
                for label in ("matched", "control")}
    emit("flash", cases={c[0]: dict(zip(("BH", "Sq", "Sk", "D", "causal"),
                                        c[1:6])) for c in FLASH_CASES},
         tolerance=FLASH_TOL, bitwise_backward=True,
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


def phase_engine(model, params):
    import torch

    from bigdl_tpu_torch.ops import paged_decode
    from bigdl_tpu_torch.serving import InferenceEngine, Request

    knobs = ENGINE_KNOBS
    eng = InferenceEngine(model, params, **knobs)
    check(eng.attn_impl == "cuda", "engine default attn_impl is not cuda")
    eng.run([Request(**r) for r in _wave(0)])              # warm-up
    timed = _wave(100)
    torch.cuda.synchronize()
    steps0 = eng.stats["decode_steps"]
    hits0 = eng.stats["prefix_hits"]
    paged_decode.launches = 0                     # main path starts here
    t0 = time.perf_counter()
    res = eng.run([Request(**r) for r in timed])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = paged_decode.launches              # main path ends here
    steps = eng.stats["decode_steps"] - steps0
    check(launches > 0 and launches == steps * LAYERS,
          f"kernel launches {launches} != decode steps {steps} x "
          f"{LAYERS} layers")
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
    return launches


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


def _train_model(attn_impl=None):
    """The trainer's 43M LM (TRAIN_CONFIG) on the card."""
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)

    return TransformerLM(TransformerConfig(**TRAIN_CONFIG),
                         attn_impl=attn_impl)


def phase_train_model():
    """One fp32 loss-and-grad step of the full-width LM through the
    flash kernels against the same step through the plain versions,
    from the same params and batch (FULL_PRECISION, TF32 off)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.models.convert import (tree_leaves,
                                                tree_leaves_with_path,
                                                tree_map)
    from bigdl_tpu_torch.nn import ChunkedSoftmaxCE
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.losses import build_train_loss
    from bigdl_tpu_torch.utils.precision import FULL_PRECISION

    batch = synthetic_next_token(TRAIN_BATCH, VOCAB, TRAIN_SEQ, seed=3)
    x = torch.as_tensor(np.stack([b.feature for b in batch])).cuda()
    y = torch.as_tensor(np.stack([b.label for b in batch])).cuda()
    params = None
    out = {}
    for impl in ("cuda", "torch"):
        model = _train_model(impl)
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
    check(math.isfinite(out["cuda"][0]), "train-model loss not finite")
    check(dloss <= TRAIN_LOSS_TOL, f"train-model |dloss| {dloss}")
    check(rel <= TRAIN_GRAD_TOL, f"train-model grad rel diff {rel}")
    layers = TRAIN_CONFIG["num_layers"]
    check(out["cuda"][2:] == (layers, layers * fa.BWD_LAUNCHES),
          f"train-model cuda step launched {out['cuda'][2:]} kernels")
    check(out["torch"][2:] == (0, 0), "the plain step launched kernels")
    emit("train_model", loss_cuda=out["cuda"][0], loss_torch=out["torch"][0],
         loss_abs_diff=dloss, grad_max_rel_diff=rel,
         tolerance={"loss": TRAIN_LOSS_TOL, "grad_rel": TRAIN_GRAD_TOL},
         grad_rel_diff_by_leaf=rels, grad_floor=TRAIN_GRAD_FLOOR,
         launches={"fwd": out["cuda"][2], "bwd": out["cuda"][3]},
         params=int(sum(t.numel() for t in tree_leaves(params))))


def _trainer(steps: int, watch):
    """The main path: Optimizer(...).optimize() on the bench
    configuration for `steps` steps (Trigger.max_iteration);
    `watch(train_state)` sees the state before every step and at the
    end."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.text import synthetic_next_token
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    model = _train_model()
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
    import torch

    from bigdl_tpu_torch.models.transformer import (
        TransformerConfig, lm_train_matmul_flops_per_token)
    from bigdl_tpu_torch.ops import flash_attention as fa

    losses, marks = [], {}

    def on_step(state):
        if state["loss"] is not None:
            losses.append(state["loss"])
        n = state["neval"]
        if n == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.fwd_launches = fa.bwd_launches = 0  # main path starts here
            marks["t0"] = time.perf_counter()
        elif n == TRAIN_WARMUP + TRAIN_STEPS:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            marks["launches"] = (fa.fwd_launches,  # main path ends here
                                 fa.bwd_launches)

    _trainer(TRAIN_WARMUP + TRAIN_STEPS, on_step)
    losses = [float(v) for v in losses]
    dt = marks["t1"] - marks["t0"]
    fwd, bwd = marks["launches"]
    layers = TRAIN_CONFIG["num_layers"]
    check(len(losses) == TRAIN_WARMUP + TRAIN_STEPS
          and all(math.isfinite(v) for v in losses),
          f"trainer losses not all finite: {losses}")
    check(losses[-1] < losses[0], f"trainer loss did not fall: {losses}")
    check(fwd == TRAIN_STEPS * layers,
          f"forward launches {fwd} != {TRAIN_STEPS} steps x {layers}")
    check(bwd == TRAIN_STEPS * layers * fa.BWD_LAUNCHES,
          f"backward launches {bwd} != {TRAIN_STEPS} x {layers} x "
          f"{fa.BWD_LAUNCHES}")
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    flops = lm_train_matmul_flops_per_token(
        TransformerConfig(**TRAIN_CONFIG)) * tokens
    emit("trainer", steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, seconds=dt,
         step_ms=dt / TRAIN_STEPS * 1e3, tokens_per_sec=tokens / dt,
         model_flops_share=flops / dt / BF16_FLOPS_PER_S,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches={"fwd": fwd, "bwd": bwd}, losses=losses)
    return fwd, bwd


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
    flash_ms = sum(r[0] for r in rows if any(
        n in r[2] for n in ("fa_fwd_kernel", "fa_dkdv_kernel",
                            "fa_dq_kernel"))) / 1e3 / 2
    emit("train_profile", steps=2,
         profiled_wall_ms_per_step=(marks["t1"] - marks["t0"]) / 2 * 1e3,
         device_ms_per_step=dev_ms, flash_ms_per_step=flash_ms,
         flash_share_of_device=flash_ms / dev_ms,
         kernels_per_step=sum(r[1] for r in rows) / 2,
         top=[{"name": k[:80], "calls_per_step": c / 2,
               "ms_per_step": us / 1e3 / 2} for us, c, k in rows[:12]])


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
    launches = phase_engine(model, params)
    if "--profile" in sys.argv[1:]:
        phase_profile(model, params)
    del model, params
    torch.cuda.empty_cache()
    phase_train_model()
    torch.cuda.empty_cache()
    fwd_launches, bwd_launches = phase_trainer()
    if "--profile" in sys.argv[1:]:
        torch.cuda.empty_cache()
        phase_train_profile()
    fp32 = kern["fp32"]
    # the flash rows: the trainer's shape in its compute dtype (bf16)
    row = flash["train/bf16"]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "bigdl_tpu/ops/paged_decode.py:95",
        "launches": launches,
        "max_abs_err": max(kern["fp32"]["max_abs_err"],
                           kern["bf16"]["max_abs_err"]),
        "ms": fp32["kernel_ms"], "plain_ms": fp32["torch_ms"],
        "bound_ms": fp32["bound_ms"], "bound_by": fp32["bound_by"],
        "library_ms": fp32["library_ms"],
    }, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:118",
        "launches": fwd_launches,
        "max_abs_err": row["out_max_abs_err"],
        "ms": row["fwd_ms"], "plain_ms": row["plain_fwd_ms"],
        "bound_ms": row["fwd"]["bound_ms"],
        "bound_by": row["fwd"]["bound_by"],
        "library_ms": row["sdpa_fwd_ms"],
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:450 :341 :374",
        "launches": bwd_launches,
        "max_abs_err": row["grad_max_abs_err"],
        "ms": row["bwd_ms"], "plain_ms": row["plain_bwd_ms"],
        "bound_ms": row["bwd"]["bound_ms"],
        "bound_by": row["bwd"]["bound_by"],
        "library_ms": row["sdpa_bwd_ms"],
    }]
    for k in kernels:
        check(all(isinstance(v, str) or math.isfinite(v)
                  for v in k.values()), f"{k['name']}: non-finite field")
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
