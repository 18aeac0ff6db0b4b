#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --profile  # also: where a decode step's time goes

It drives `bigdl_tpu_torch` only (never JAX or the JAX package):

1. device — the card's name and `nvidia-smi` name/power limit;
2. build  — compiles every CUDA kernel of the path from the sources in
   the checkout (`bigdl_tpu_torch/ops/_build.py`, nvcc for sm_90a);
3. kernel — the paged-decode kernel against its plain PyTorch version
   at the engine's shape (B=8, H=8, 37 blocks of 16, D=64) with
   shuffled tables, ragged clocks including 0 and S-1 and a NaN
   scratch block 0, for fp32 and bf16 pools (max abs err <= 2e-5);
   each row of a B=8 launch must be BITWISE the same row launched
   alone; times with CUDA events, L2 flushed before each launch;
4. model  — the 43M Transformer-LM at full width: `decode_step_paged`
   through the kernel against the plain version on the same pools and
   tokens for 8 steps (logits max abs diff <= 1e-4);
5. engine — the main path: `InferenceEngine.run` serves a warm-up wave
   and then a timed wave of 16 ragged greedy requests (prompts of
   512/253/495/170 tokens, 64 new tokens each, 8 slots, prefill buckets
   256/512 — the repository's serving benchmark configuration). The
   kernel's launch count is set to 0 just before the timed wave and
   read just after; it must equal decode steps x layers. Reported, not
   gated: token agreement with a plain-attention engine and whether a
   warm (prefix-cache) admission decodes bitwise like a cold one;
6. kernels — one JSON line per the port's kernel table.

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
    _build.build(["paged_decode"])
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("paged_decode",
                                                       "").splitlines()
             if "registers" in ln or "spill" in ln]
    RESULTS["build_log"] = _build.BUILD_LOG
    emit("build", seconds=seconds, kernels=["paged_decode"],
         ptxas_lines=len(ptxas), ptxas_sample=ptxas[:4])


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
    del flush
    model, params = _model()
    phase_model(model, params)
    launches = phase_engine(model, params)
    if "--profile" in sys.argv[1:]:
        phase_profile(model, params)
    fp32 = kern["fp32"]
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
