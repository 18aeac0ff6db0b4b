"""Compare this tree's recurrent, paged-decode and flash-attention CUDA
kernels with their earlier designs on one CUDA card, and show where the
new kernels' time goes. A measuring tool: nothing in the port uses it, and it has
no JAX counterpart.

    mkdir -p .cmp/old                # any directory; .cmp/ is git-ignored
    git show <rev>:bigdl_tpu_torch/ops/csrc/fused_rnn.cu > .cmp/old/fused_rnn.cu
    git show <rev>:bigdl_tpu_torch/ops/csrc/paged_decode.cu > .cmp/old/paged_decode.cu
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old \
        --parts k9,k10,layouts,phases              # repository root
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old --parts k8,k8_phases
    git show <rev>:bigdl_tpu_torch/ops/csrc/flash_attention.cu > .cmp/old/flash_attention.cu
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old --parts flash_f32
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old \
        --parts k1_wide,flash_bf16_wide      # <rev> 5f8b0cf: both sources
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old \
        --parts flash_bf16_wide_bwd          # <rev> 96b28fd: flash_attention.cu

`--parts` picks what runs (default k9,k10,layouts,phases), each part
printing one JSON line; old and new always run in turns (old, new, new,
old; `chip_smoke.cuda_ms`, L2 flushed):

* `k9` (old: the LSTM backward of commit c2553f2 or earlier, one launch
  writing per-tile dW (tiles, H, 4H) from W transposed): old and new at
  the BiLSTM trainer's shape (`train_bi`, N = T = H = 128, two
  directions) and the LSTM LM's (`lm_uni`, N = 32, T = 64, one), bf16
  and fp32, the old also with its caller's tile sum, the new call's
  sweep and dW kernels' profiler times, and at `lm_uni` in bf16 the dW
  split by stages (the wrapper's) against one of at least 512 pairs a
  cluster rank; and `k9_old_split`: the old kernel whole, its sweep
  alone (the dW tail removed) and its dW tail alone (the sweep run zero
  times);
* `k10` (old: the GRU forward of commit c2553f2 or earlier): old and new
  at the GRU trainer's shape (N = T = H = 128), bf16 and fp32, training
  and inference variants, the new kernels' profiler times, and the fp32
  variants' ptxas reports and SASS instruction counts, old and new;
* `layouts`: this tree's bf16 LSTM backward (W's 32 k-steps a warp in
  registers) against copies with other layouts of the resident sweep
  (`_layout_sources`, from the patches in ops/study/: W's K in two
  parts of 8 warps, summed through shared memory; 4, 8 or 16 of W's 32
  k-steps read from shared memory; the residuals read before the
  product), at `train_bi`, with each build's ptxas report;
* `phases`: clock cycles a step in each phase of this tree's bf16 LSTM
  backward sweep (`k9_phases`, `train_bi`) and bf16 GRU forward
  (`k10_phases`, training variant), `clock64` written into a copy of
  csrc/fused_rnn.cu, warps 0, 3 and 7 of CTA 0;
* `k1_k11` (old: the paged-decode and GRU-backward sources of commit
  1c76577, before their redesign): K1 at the engine shape and K11 at
  the GRU trainer's, with `k11_old_split`;
* `k11_phases`: clock cycles a step in each phase of this tree's bf16
  GRU backward sweep (`clock64` written into a copy of
  csrc/fused_rnn.cu), warps 0, 3 and 7 of CTA 0;
* `k8` (old: the LSTM forward of commit d5456b1 or earlier, its first
  design): old and new K8 at `train_bi` and K6 at `lm_uni`, bf16 and
  fp32, training and inference variants, the new kernels' profiler
  times; the unkept layouts of ops/study/lstm_fwd_*.diff
  (`_fwd_layout_sources`) each in turns with the shipped kernel, and
  whether they give its bits: in fp32 one CTA a tile with W from L2
  (`one_cta`) and a cluster barrier a step for the h exchange
  (`cluster_barrier`), in bf16 2 or 4 of each gate tile's k-steps from
  shared memory and the four-entry epilogue; cuDNN's fp32
  `torch.nn.LSTM` at each shape (training and no-grad forward); the
  forward kernels' ptxas reports, new, unkept layouts and old (the bf16
  loop reading a step's zx ahead, `inputs_first`, is timed as a layout
  too);
* `e2e` (`--old-tree DIR`: a checkout of the earlier commit, e.g. from
  `git archive`): the BiLSTM trainer's main path, chip_smoke's
  rnn_trainer phase warmed once and then timed over E2E_STEPS steps
  (step, predict pass a batch, LSTM LM step) and its profiled step
  (device work, busy share), one process a run from each checkout, in
  turns (old, new, new, old), E2E_PAIRS pairs;
* `k8_phases`: clock cycles a step in each phase of this tree's LSTM
  forward, training variant, as `phases`: bf16 at `train_bi`
  (`k8_phases`), fp32 at `lm_uni` (`k8_fp32_phases`, cluster rank 0 of
  tile 0);
* `flash_f32` (old: the flash-attention source of commit 0fe951a or
  earlier, whose fp32 kernels are the 16 x 16 SIMT tiles and, above D =
  256, the column-split ones): old and new fp32 forward and backward
  (both backward launches) through the libraries' C entry points, on
  the same padded operands, at chip_smoke's fp32 FLASH_TIMED cases
  (prefill_d64 among them), in turns; their outputs' largest
  difference; and each fp32 kernel's ptxas report (registers, spills)
  and SASS counts (FFMA, LDS, LDS.128), old and new;
* `k1_wide` (old: the paged-decode source of commit 5f8b0cf or earlier,
  whose row-split kernel above D = 1024 is one CTA a (row, head) with a
  global score row): old and new through their C entry points, on the
  same pools, at chip_smoke's d1100 case (4 slots, H = 2, 96 keys) in
  fp32 and bf16, in turns, and at D = 2049 (4- and 2-byte rows), their
  outputs' largest difference; each row-split kernel's ptxas report and
  SASS counts, old and new;
* `flash_bf16_wide` (old: the flash-attention source of commit 5f8b0cf
  or earlier, whose bf16 forward above D = 256 is one CTA a 128-column
  slice, each recomputing S): old and new bf16 forward through the C
  entry points on the same padded operands, in turns, at chip_smoke's
  ragged_d320 and train_h1, and untimed at masked_d512, wide_d1000,
  wide_d2000 and D = 4096 (a non-portable cluster of 16), their
  outputs' and lse's largest difference; the forward kernels' ptxas
  reports and SASS counts (HGMMA, UTMALDG: TMA loads), old and new;
* `flash_bf16_wide_bwd` (old: the flash-attention source of commit
  96b28fd or earlier, whose bf16 backward above D = 256 is one CTA a
  128-column slice, each recomputing S and dP over the full D): old and
  new bf16 backward (both launches) through the C entry points on the
  same padded operands and the same forward's (o, lse), in turns, at
  chip_smoke's ragged_d320, train_h1, masked_d512, wide_d1000 and
  wide_d2000, and untimed at D = 4096; their gradients' largest
  difference, the new one's bf16 ulps and mismatch share against
  `flash_backward_tiled` (chip_smoke's `_ulp_stats` with each element's
  largest term), whether two new calls give the same bits; the
  backward kernels' ptxas reports and SASS counts (HGMMA, UTMALDG,
  the SYNCS and st.async / bulk-copy opcodes: every opcode of the new
  cluster kernels is listed), old and new; and, from a copy of this
  tree's source with `clock64` counters (`_exchange_clock_source`), the
  cluster kernels' cycles a tile at train_h1 and ragged_d320 (bh 0,
  warp 0 of each warpgroup of each rank): the whole tile, and in the
  exchange the wait for the partner's release, the push, the wait for
  the partner's partial and the sum.

Builds go to <old>/build (.cmp/build without --old). Every JSON line
is also appended to chiprun_out/kernel_study.jsonl.
"""

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VOID = ctypes.c_void_p


def _emit(obj: dict) -> None:
    """Print one JSON line, and append it to chiprun_out/kernel_study.jsonl
    (the long lines outgrow a terminal's tail)."""
    line = json.dumps(obj)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_study.jsonl", "a") as f:
        f.write(line + "\n")


def _nvcc(src: Path, out: Path, include: Path = None) -> subprocess.Popen:
    from bigdl_tpu_torch.ops import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    if include is not None:
        cmd[1:1] = ["-I", str(include)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: dict) -> dict:
    """Each build's nvcc report (ptxas lines included); raises on a
    failed build."""
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"expected one {old!r} in the source")
    return text.replace(old, new)


def _apply_diff(text: str, diff: str) -> str:
    """`text` with each hunk of a unified diff applied: the hunk's
    context and removed lines, found once, become its context and added
    lines."""
    body = diff[diff.index("\n+++ ") + 1:].split("\n", 1)[1]
    for hunk in re.split(r"^@@[^\n]*\n", body, flags=re.M)[1:]:
        old, new = [], []
        for ln in hunk.splitlines(True):
            if ln[:1] in " -":
                old.append(ln[1:])
            if ln[:1] in " +":
                new.append(ln[1:])
        text = _replace_once(text, "".join(old), "".join(new))
    return text


def _gru_old_variants(old_rnn: str) -> dict:
    """The old GRU backward whole, with its dW tail removed, and with
    its sweep run zero times."""
    tail = old_rnn[old_rnn.index("  gru_tile_dw<T, false>"):
                   old_rnn.index("}\n\nsize_t gru_fwd_smem")]
    loop = "  for (int s = 0; s < nt; ++s) {\n    const int t = nt - 1 - s;"
    return {"whole": old_rnn,
            "sweep": _replace_once(old_rnn, tail, ""),
            "tail": _replace_once(old_rnn, loop,
                                  loop.replace("s < nt", "s < 0"))}


def _phase_source(src: str) -> str:
    """csrc/fused_rnn.cu with clock64 deltas summed per phase of the
    resident bf16 sweep, on lane 0 of each warp of CTA 0, readable
    through an added `kernel_study_clocks`."""
    mark = ("    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) {{ long long "
            "c_ = clock64() + (long long){dep} * 0; clk_[{i}] += c_ - c0_; "
            "c0_ = c_; }}\n")
    s = _replace_once(src, "namespace {\n\nconstexpr int kThreads = 512;",
                      "__device__ long long kernel_study_clk[64];\n"
                      "namespace {\n\nconstexpr int kThreads = 512;")
    s = _replace_once(
        s, "  sm90::cp_async_wait<1>();\n  __syncthreads();  // step nt - 1's",
        "  long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long c0_ = clock64();\n"
        "  sm90::cp_async_wait<1>();\n  __syncthreads();  // step nt - 1's")
    for anchor, before, i, dep in (
            ("    __syncthreads();  // op1 holds step t's dcand_pre\n",
             False, 0, "0"),
            ("    copy_out(std::integral_constant<bool, false>(), t);",
             True, 1, "acc[0][0]"),
            ("    stage(t - 2);\n", True, 2, "dhp[0][0]"),
            ("    sm90::cp_async_wait<1>();  // step t - 1's stage\n",
             True, 3, "0"),
            ("    sm90::cp_async_wait<1>();  // step t - 1's stage\n",
             False, 4, "0"),
            ("    __syncthreads();           // op2 holds", False, 5, "0"),
            ("    if (t > 0) first(t - 1);\n  }\n", True, 6, "carry[0][0]")):
        line = mark.format(dep=dep, i=i)
        if before:
            s = _replace_once(s, anchor, line + anchor)
        else:
            end = s.index(anchor) + len(anchor)
            end = s.index("\n", end - 1) + 1
            s = s[:end] + line + s[end:]
    s = _replace_once(
        s, "    if (t > 0) first(t - 1);\n  }\n}\n",
        "    if (t > 0) first(t - 1);\n" + mark.format(dep="0", i=7)
        + "  }\n  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 && kMT == 1)\n"
        "    for (int i = 0; i < 8; ++i)\n"
        "      kernel_study_clk[(threadIdx.x >> 5) * 8 + i] = clk_[i];\n}\n")
    return s + ('\nextern "C" int kernel_study_clocks(long long* h) {\n'
                "  return (int)cudaMemcpyFromSymbol(h, kernel_study_clk,\n"
                "                                   sizeof(kernel_study_clk));"
                "\n}\n")


# clock64 phases of this tree's bf16 LSTM backward sweep (k9_phases) and
# GRU forward (k10_phases): (symbol, the line before which the counters
# start, the kernel's last lines, the guard of the instantiation read,
# and per phase: name, anchor line, mark after (True) or before it, the
# register the mark waits for)
_PHASES = {
    "k9_phases": (
        "kernel_study_lstm_clk",
        "  sm90::cp_async_wait<1>();\n  __syncthreads();  // step 0's stage "
        "and the zeroed tiles\n  for (int s = 0; s < nt; ++s) {\n",
        "    if (s + 1 < nt) product(o);\n  }\n}\n", "kMT == 1",
        (("load residuals", "    load_res(s);\n", True, "vy[0][0]"),
         ("epilogue", "    epilogue(o);\n", True, "dc[0][0]"),
         ("staging", "    stage(s + 2);\n", True, "0.f"),
         ("wait", "    sm90::cp_async_wait<1>();  // step s + 1's stage\n",
          True, "0.f"),
         ("barrier", "    __syncthreads();           // o holds step s's "
          "dz; the stage landed\n", True, "0.f"),
         ("copy out", "    copy_out(o, time_of(s));\n", True, "0.f"),
         ("product", "    if (s + 1 < nt) product(o);\n", True,
          "acc[0][0]"))),
    "k10_phases": (
        "kernel_study_gru_clk",
        "  sm90::cp_async_wait<1>();\n  __syncthreads();  // step 0's stage "
        "and the zeroed tiles\n  load_in(0);\n",
        "    if (t + 1 < nt) load_in(t + 1);\n  }\n}\n", "kMT == 1 && SAVE",
        (("product 1", "    product1();\n", True, "acc1[0][0][0]"),
         ("epilogue 1", "    __syncthreads();  // op2 holds r h; zro step t's"
          " zr\n", False, "z[0][0]"),
         ("barrier A", "    __syncthreads();  // op2 holds r h; zro step t's"
          " zr\n", True, "0.f"),
         ("copy zr", "    if (SAVE) copy_out(out_zr, zro, a.zr, H2, H2, t);\n",
          True, "0.f"),
         ("product 2", "    product2();\n", True, "acc2[0][0]"),
         ("epilogue 2", "    stage(t + 2);\n", False, "h[0][0]"),
         ("staging", "    stage(t + 2);\n", True, "0.f"),
         ("wait", "    sm90::cp_async_wait<1>();  // step t + 1's stage\n",
          True, "0.f"),
         ("barrier B", "    __syncthreads();           // op1 holds h; cno "
          "step t's cand\n", True, "0.f"),
         ("copy ys, cand", "    if (t + 1 < nt) load_in(t + 1);\n", False,
          "0.f"),
         ("load inputs", "    if (t + 1 < nt) load_in(t + 1);\n", True,
          "xz[0][0]"))),
    "k8_phases": (
        "kernel_study_lstm_fwd_clk",
        "  sm90::cp_async_wait<1>();\n  __syncthreads();  // step 0's stage "
        "and the zeroed h tiles\n  for (int s = 0; s < nt; ++s) {\n",
        "    copy_out(s, time_of(s));\n  }\n}\n", "kMT == 1 && SAVE",
        (("product", "    product(hop + (s & 1) * kTileRows * ld);\n", True,
          "acc[0][3][3]"),
         ("input reads", "    load_in(s);\n", True, "xgo[0][3]"),
         ("epilogue", "    epilogue(s);\n", True, "cc[0][3]"),
         ("staging", "    stage(s + 2);              // zx of step s + 2\n",
          True, "0.f"),
         ("wait", "    sm90::cp_async_wait<1>();  // zx of step s + 1\n",
          True, "0.f"),
         ("barrier", "    __syncthreads();           // step s's h, c and "
          "gates in their tiles\n", True, "0.f"),
         ("copy out", "    copy_out(s, time_of(s));\n", True, "0.f"))),
    "k8_fp32_phases": (
        "kernel_study_lstm_fwd32_clk",
        "  float cv = 0.f;\n  for (int s = 0; s < nt; ++s) {\n",
        "    __syncthreads();           // ... for every thread; stage s % 3 "
        "free\n  }\n  cluster.sync();  // no CTA leaves while a peer may still"
        " signal it\n}\n", "kWS && SAVE",
        (("h wait", "      if (tid == 0) sm90::mbarrier_arrive_expect_tx(mb0 + "
          "8 * (s & 1), 16 * H);\n    }\n", True, "0.f"),
         ("product", "    // reduce-scatter over the unit's 4 lanes", False,
          "acc[3][3]"),
         ("reduce", "    const float* x = stages + (s % 3) * se + 4 * p * lus"
          " + ul;\n", False, "z[3]"),
         ("gate math", "    if (own && s + 1 < nt) {\n", False, "h"),
         ("h to the cluster", "    if (own) {\n      if (p < nr) {", False,
          "0.f"),
         ("stores", "    stage(s + 2);              // zx of step s + 2, the "
          "slice's\n", False, "0.f"),
         ("staging", "    stage(s + 2);              // zx of step s + 2, the "
          "slice's\n", True, "0.f"),
         ("stage wait", "    sm90::cp_async_wait<1>();  // zx of step s + 1, "
          "the slice's\n", True, "0.f"),
         ("barrier", "    __syncthreads();           // ... for every thread; "
          "stage s % 3 free\n", True, "0.f"))),
}


def _clock_source(src: str) -> str:
    """csrc/fused_rnn.cu with clock64 deltas summed per phase of the
    _PHASES sweeps, on lane 0 of each warp of CTA 0 (the mark waits for
    the phase's result register), readable through an added
    `kernel_study_read(which, out)` (which: the sweep's index in _PHASES;
    8 warps x 16 phases)."""
    on = ("blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0")
    mark = ("    if (" + on + ") {{ asm volatile(\"\" :: \"f\"("
            "(float)({dep}))); long long c_ = clock64(); clk_[{i}] += c_ -"
            " c0_; c0_ = c_; }}\n")
    head = ""
    for sym, decl, end, guard, marks in _PHASES.values():
        head += f"__device__ long long {sym}[128];\n"
        src = _replace_once(src, decl, "  long long clk_[16] = {};\n"
                            "  long long c0_ = clock64();\n" + decl)
        src = _replace_once(src, end, end[:-2] + (
            f"  if ({on} && {guard})\n    for (int i = 0; i < 16; ++i)\n"
            f"      {sym}[(threadIdx.x >> 5) * 16 + i] = clk_[i];\n}}\n"))
        for i, (_, anchor, after, dep) in enumerate(marks):
            line = mark.format(dep=dep, i=i)
            src = _replace_once(src, anchor, anchor + line if after
                                else line + anchor)
    src = _replace_once(src, "namespace {\n\nconstexpr int kThreads = 512;",
                        head + "namespace {\n\nconstexpr int kThreads = 512;")
    read = "".join(f"  if (which == {i}) return (int)cudaMemcpyFromSymbol("
                   f"h, {v[0]}, sizeof({v[0]}));\n"
                   for i, v in enumerate(_PHASES.values()))
    return src + ('\nextern "C" int kernel_study_read(int which, '
                  'long long* h) {\n' + read + "  return -1;\n}\n")


def _profile(torch, fn, flush, reps: int, match) -> dict:
    """Mean device time a call of each kernel whose name holds `match`
    (a string or a tuple of them), over `reps` calls after an L2 flush
    each."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if any(m in e.key for m in ((match,) if isinstance(match, str)
                                    else match)) \
                and e.self_device_time_total > 0:
            name = re.search(r"\w+_kernel", e.key)
            out[name.group(0) if name else e.key[:40]] = \
                e.self_device_time_total / reps
    return out


def _turns(cs, calls: dict, flush, **reps) -> dict:
    out = {k: [] for k in calls}
    for who in ("old", "new", "new", "old"):
        out[who].append(cs.cuda_ms(calls[who], flush, **reps) * 1e3)
    return out


def _wide_rank_call(fr, call, per_rank: int):
    """`call` with the wrapper's dW split replaced, for that call alone,
    by one giving each cluster rank at least `per_rank` (t, row) pairs
    (the rule the GRU backward's split followed before dw_split_plan)."""
    def run():
        shipped = fr._dw_split
        fr._dw_split = lambda lib, pairs, bf16, device: fr.dw_split_plan(
            pairs, min(shipped(lib, pairs, bf16, device)[0],
                       -(-pairs // per_rank)))
        try:
            call()
        finally:
            fr._dw_split = shipped
    return run


def _lstm_old_variants(old_rnn: str) -> dict:
    """The old LSTM backward whole, with its per-tile dW tail removed, and
    with its sweep run zero times."""
    tail = old_rnn[old_rnn.index("  // this tile's dW = sum over (t, row)"):
                   old_rnn.index("}\n\nsize_t fwd_smem")]
    loop = ("  for (int s = 0; s < nt; ++s) {\n    // forward direction: "
            "t = T-1-s")
    return {"whole": old_rnn,
            "sweep": _replace_once(old_rnn, tail, ""),
            "tail": _replace_once(old_rnn, loop,
                                  loop.replace("s < nt", "s < 0"))}


def _ptxas_lines(log: str, match: str) -> list:
    """The ptxas report lines (registers, stack frame, spills) of the
    kernels whose mangled names hold `match`."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = match in ln
            if on:
                out.append(ln.split("'")[1])
        elif on and ("registers" in ln or "spill" in ln
                     or "stack frame" in ln):
            out.append(ln.strip())
    return out


def _sass_counts(so: Path, match: str) -> dict:
    """Per kernel whose mangled name holds `match`: SASS instructions in
    all, and of a few kinds (global and shared loads and stores,
    barriers, fp32 FMAs, MUFU)."""
    from bigdl_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    kinds = ("LDG", "STG", "LDS", "LDS.128", "STS", "BAR", "FFMA", "MUFU",
             "BRA", "HGMMA", "UTMALDG", "STAS", "UBLKCP", "SYNCS")
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out[name] = {"all": 0, **{k: 0 for k in kinds}}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            out[name]["all"] += 1
            op = ln.split("*/", 1)[1].strip().split(" ")[0]
            if op.startswith("@"):
                op = ln.split("*/", 1)[1].strip().split(" ")[1]
            for k in kinds:
                if op.startswith(k):
                    out[name][k] += 1
    return out


def _ptrs(xs):
    p = [x.data_ptr() for x in xs]
    return p + [p[0]] * (2 - len(p))


def part_k9(torch, cs, fr, build: Path, flush, stream) -> None:
    bwd = {}
    for name in ("whole", "sweep", "tail"):
        fn = ctypes.CDLL(str(build / f"old_lstm_{name}.so")).bigdl_lstm_bwd
        fn.argtypes = [VOID] * 14 + [ctypes.c_int] * 7 + [VOID]
        bwd[name] = fn
    k9, split = {}, {}
    reps = dict(reps=10, warmup=2)
    for case, n, t, h, ndir in (("train_bi", 128, 128, 128, 2),
                                ("lm_uni", 32, 64, 128, 1)):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            zxs, ws, dys, revs = cs._rnn_inputs(n, t, h, ndir, dtype, 1)
            res = fr.lstm_fwd_cuda(zxs, ws, revs, True)
            wts = [w.t().contiguous() for w in ws]
            dzx = [torch.empty_like(r[2]) for r in res]
            tiles = (n + fr.BLOCK_N - 1) // fr.BLOCK_N
            dws = [torch.empty(tiles, h, 4 * h, device="cuda")
                   for _ in range(ndir)]

            def call(which="whole"):
                err = bwd[which](
                    *_ptrs(wts), *_ptrs([r[0] for r in res]),
                    *_ptrs([r[1] for r in res]), *_ptrs([r[2] for r in res]),
                    *_ptrs(dys), *_ptrs(dzx), *_ptrs(dws),
                    *([int(r) for r in revs] + [0] * (2 - ndir)), ndir, n, t,
                    h, int(dtype == torch.bfloat16), stream)
                if err:
                    raise RuntimeError(f"old LSTM backward: cudaError {err}")

            calls = {"old": call,
                     "new": lambda: fr.lstm_bwd_cuda(ws, res, dys, revs)}
            key = f"{case}/{name}"
            k9[key] = {
                "us": _turns(cs, calls, flush, **reps),
                "old_with_tile_sum_us": cs.cuda_ms(
                    lambda: (call(), [d.sum(0) for d in dws]), flush,
                    **reps) * 1e3,
                "new_device_us": _profile(torch, calls["new"], flush, 10,
                                          ("lstm_bwd", "rnn_dw"))}
            if key == "lm_uni/bf16":   # the dW split: by stages, or wide
                wide = {"old": _wide_rank_call(fr, calls["new"], 512),
                        "new": calls["new"]}
                most = fr._MAX_SPLITS[(torch.cuda.current_device(), True)]
                k9[key]["dw_split"] = {
                    "plans": {"by_stages": fr.dw_split_plan(n * t, most),
                              "512_pairs_a_rank": fr.dw_split_plan(
                                  n * t, min(most, -(-n * t // 512)))},
                    "us": {"512_pairs_a_rank" if k == "old" else
                           "by_stages": v for k, v in
                           _turns(cs, wide, flush, **reps).items()},
                    "dw_device_us": {
                        k: _profile(torch, c, flush, 10, "rnn_dw")
                        for k, c in (("512_pairs_a_rank", wide["old"]),
                                     ("by_stages", wide["new"]))}}
            if case == "train_bi":
                split[key] = {w: [cs.cuda_ms(lambda: call(w), flush,
                                             **reps) * 1e3
                                  for _ in range(3)] for w in bwd}
    _emit({"k9": k9})
    _emit({"k9_old_split": split})


def part_k10(torch, cs, fr, build: Path, logs, flush, stream) -> None:
    from bigdl_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(build / "old_lstm_whole.so")).bigdl_gru_fwd
    fn.argtypes = [VOID] * 7 + [ctypes.c_int] * 5 + [VOID]
    k10 = {}
    reps = dict(reps=10, warmup=2)
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        zg, zc, wg, wc, _ = cs._gru_inputs(128, 128, 128, dtype, 1)
        ys, zr, cand = (torch.empty_like(x) for x in (zc, zg, zc))
        for save in (True, False):
            def old_call(save=save):
                err = fn(zg.data_ptr(), zc.data_ptr(), wg.data_ptr(),
                         wc.data_ptr(), ys.data_ptr(), zr.data_ptr(),
                         cand.data_ptr(), 128, 128, 128, int(save),
                         int(dtype == torch.bfloat16), stream)
                if err:
                    raise RuntimeError(f"old GRU forward: cudaError {err}")

            calls = {"old": old_call,
                     "new": lambda save=save: fr.gru_fwd_cuda(zg, zc, wg, wc,
                                                              save)}
            k10[f"{name}/{'train' if save else 'infer'}"] = {
                "us": _turns(cs, calls, flush, **reps),
                "new_device_us": _profile(torch, calls["new"], flush, 10,
                                          "gru_fwd")}
    new_so = _build.library_path("fused_rnn")
    k10["fp32_variants"] = {
        "old_ptxas": _ptxas_lines(logs["old_lstm_whole"], "gru_fwd_kernel"),
        "new_ptxas": _ptxas_lines(_build.BUILD_LOG["fused_rnn"],
                                  "gru_fwd_simt_kernel"),
        "old_sass": _sass_counts(build / "old_lstm_whole.so",
                                 "gru_fwd_kernelIf"),
        "new_sass": _sass_counts(new_so, "gru_fwd_simt_kernelIf")}
    _emit({"k10": k10})


_RES_AFTER = ("  for (int s = 0; s < nt; ++s) {\n"
              "    unsigned short* o = op + (s & 1) * kTileRows * ld;\n"
              "    load_res(s);\n    epilogue(o);",
              "    if (s + 1 < nt) product(o);\n  }\n}")
_RES_BEFORE = ("  load_res(0);\n  for (int s = 0; s < nt; ++s) {\n"
               "    unsigned short* o = op + (s & 1) * kTileRows * ld;\n"
               "    epilogue(o);",
               "    if (s + 1 < nt) {\n      load_res(s + 1);\n"
               "      product(o);\n    }\n  }\n}")


def _layout_sources(src: str) -> dict:
    """This tree's LSTM backward with other layouts of the resident bf16
    sweep, from the patches in ops/study/: W's K in two parts (16
    warps); 4, 8 or 16 of W's 32 k-steps read from shared memory; and
    the step's residuals read before the product (overlapping it)
    instead of after."""
    study = Path(__file__).parent / "study"
    out = {"two_parts": _apply_diff(
        src, (study / "lstm_bwd_two_parts.diff").read_text())}
    shared = _apply_diff(
        src, (study / "lstm_bwd_shared_ksteps.diff").read_text())
    for k in (4, 8, 16):
        out[f"shared_{k}"] = _replace_once(
            shared, "constexpr int kLstmSharedKSteps = 4;",
            f"constexpr int kLstmSharedKSteps = {k};")
    s = _replace_once(src, _RES_AFTER[0], _RES_BEFORE[0])
    out["residuals_first"] = _replace_once(s, _RES_AFTER[1], _RES_BEFORE[1])
    return out


def part_layouts(torch, cs, fr, build: Path, logs, flush, stream) -> None:
    from bigdl_tpu_torch.ops import _build

    zxs, ws, dys, revs = cs._rnn_inputs(128, 128, 128, 2, torch.bfloat16, 1)
    res = fr.lstm_fwd_cuda(zxs, ws, revs, True)
    fr.lstm_bwd_cuda(ws, res, dys, revs)   # the wrapper's dW split
    split = fr.dw_split_plan(128 * 128, fr._MAX_SPLITS[
        (torch.cuda.current_device(), True)])
    calls = {"this_tree": lambda: fr.lstm_bwd_cuda(ws, res, dys, revs)}
    report = {"this_tree": {"ptxas": _ptxas_lines(
        _build.BUILD_LOG["fused_rnn"], "lstm_bwd_mma_kernelILi1E")}}
    for name in (k[7:] for k in logs if k.startswith("layout_")):
        fn = ctypes.CDLL(str(build / f"layout_{name}.so")).bigdl_lstm_bwd
        fn.argtypes = [VOID] * 14 + [ctypes.c_int] * 9 + [VOID]
        dzx = [torch.empty_like(r[2]) for r in res]
        dws = [torch.empty(128, 512, device="cuda") for _ in range(2)]

        def call(fn=fn, dzx=dzx, dws=dws):
            err = fn(*_ptrs(ws), *_ptrs([r[0] for r in res]),
                     *_ptrs([r[1] for r in res]),
                     *_ptrs([r[2] for r in res]), *_ptrs(dys), *_ptrs(dzx),
                     *_ptrs(dws), 0, 1, 2, 128, 128, 128, *split, 1, stream)
            if err:
                raise RuntimeError(f"LSTM backward {name}: cudaError {err}")

        calls[name] = call
        report[name] = {"ptxas": _ptxas_lines(logs[f"layout_{name}"],
                                              "lstm_bwd_mma_kernelILi1E")}
    names = list(calls)
    for order in (names, names[::-1]):      # in turns, there and back
        for name in order:
            report[name].setdefault("us", []).append(
                cs.cuda_ms(calls[name], flush, reps=10, warmup=2) * 1e3)
    _emit({"layouts": report})


def part_k1_k11(torch, cs, fr, build: Path, flush, stream) -> None:
    from bigdl_tpu_torch.ops import paged_decode as pd

    variants = ("whole", "sweep", "tail")
    old_pd = ctypes.CDLL(str(build / "old_pd.so")).bigdl_paged_decode
    old_pd.argtypes = [VOID] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, VOID]
    k1 = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, table, pos = cs._decode_case(dtype, flush.device)
        out = torch.empty_like(q)
        b, h, _, d = q.shape
        calls = {
            "old": lambda: old_pd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), b, h, table.shape[1],
                k.shape[2], d, d ** -0.5, int(dtype == torch.bfloat16),
                stream),
            "new": lambda: pd.paged_decode_attention(q, k, v, table, pos,
                                                     impl="cuda")}
        one = cs._decode_case(dtype, flush.device, B=1, nb=1, clocks=(0,))
        k1[name] = {"us": _turns(cs, calls, flush),
                    "new_device_us": _profile(torch, calls["new"], flush, 10,
                                              "paged"),
                    "one_key_device_us": _profile(
                        torch, lambda: pd.paged_decode_attention(
                            *one, impl="cuda"), flush, 10, "paged")}
    _emit({"k1": k1})

    bwd = {}
    for name in variants:
        fn = ctypes.CDLL(str(build / f"old_rnn_{name}.so")).bigdl_gru_bwd
        fn.argtypes = [VOID] * 10 + [ctypes.c_int] * 4 + [VOID]
        bwd[name] = fn
    k11, split = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        zg, zc, wg, wc, dy = cs._gru_inputs(128, 128, 128, dtype, 1)
        ys, zr, cand = fr.gru_fwd_cuda(zg, zc, wg, wc, True)
        wgt, wct = wg.t().contiguous(), wc.t().contiguous()
        dzg, dzc = torch.empty_like(zr), torch.empty_like(cand)
        dwg = torch.empty(32, 128, 256, device="cuda")
        dwc = torch.empty(32, 128, 128, device="cuda")

        def old_call(which="whole"):
            return bwd[which](
                wgt.data_ptr(), wct.data_ptr(), ys.data_ptr(), zr.data_ptr(),
                cand.data_ptr(), dy.data_ptr(), dzg.data_ptr(),
                dzc.data_ptr(), dwg.data_ptr(), dwc.data_ptr(), 128, 128,
                128, int(dtype == torch.bfloat16), stream)

        calls = {"old": old_call,
                 "new": lambda: fr.gru_bwd_cuda(wg, wc, ys, zr, cand, dy)}
        reps = dict(reps=10, warmup=2)
        k11[name] = {
            "us": _turns(cs, calls, flush, **reps),
            "old_with_sums_us": cs.cuda_ms(
                lambda: (old_call(), dwg.sum(0), dwc.sum(0)), flush,
                **reps) * 1e3,
            "new_device_us": _profile(torch, calls["new"], flush, 10,
                                      "_kernel")}
        split[name] = {w: [cs.cuda_ms(lambda: old_call(w), flush, **reps)
                           * 1e3 for _ in range(3)] for w in variants}
    _emit({"k11": k11})
    _emit({"k11_old_split": split})


def part_k11_phases(torch, cs, fr, build: Path, stream) -> None:
    lib = ctypes.CDLL(str(build / "phases.so"))
    fn = lib.bigdl_gru_bwd
    fn.argtypes = [VOID] * 10 + [ctypes.c_int] * 4 + [VOID]
    zg, zc, wg, wc, dy = cs._gru_inputs(128, 128, 128, torch.bfloat16, 1)
    ys, zr, cand = fr.gru_fwd_cuda(zg, zc, wg, wc, True)
    dzg, dzc = torch.empty_like(zr), torch.empty_like(cand)
    dwg = torch.empty(128, 256, device="cuda")
    dwc = torch.empty(128, 128, device="cuda")
    for _ in range(3):
        err = fn(wg.data_ptr(), wc.data_ptr(), ys.data_ptr(), zr.data_ptr(),
                 cand.data_ptr(), dy.data_ptr(), dzg.data_ptr(),
                 dzc.data_ptr(), dwg.data_ptr(), dwc.data_ptr(), 128, 128,
                 128, 1, stream)
        if err:
            raise RuntimeError(f"instrumented GRU backward: cudaError {err}")
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * 64)()
    if lib.kernel_study_clocks(clocks):
        raise RuntimeError("could not read the phase clocks")
    names = ("barrier 1", "product 1", "second phase", "staging",
             "wait", "barrier 2", "product 2", "first phase")
    _emit({"k11_phases": {
        f"warp {w}": {n: clocks[8 * w + i] / 128 for i, n in
                      enumerate(names)} for w in (0, 3, 7)}})


def part_phases(torch, cs, fr, build: Path, stream,
                keys=("k9_phases", "k10_phases")) -> None:
    """The `clock64` phases of the _PHASES sweeps named by `keys`, after
    three runs of each instrumented kernel at its trainer's shape."""
    lib = ctypes.CDLL(str(build / "clocks.so"))
    lib.bigdl_lstm_fwd.argtypes = [VOID] * 10 + [ctypes.c_int] * 8 + [VOID]
    lib.bigdl_lstm_bwd.argtypes = [VOID] * 14 + [ctypes.c_int] * 9 + [VOID]
    lib.bigdl_gru_fwd.argtypes = [VOID] * 7 + [ctypes.c_int] * 5 + [VOID]
    zxs, ws, dys, revs = cs._rnn_inputs(128, 128, 128, 2, torch.bfloat16, 1)
    res = fr.lstm_fwd_cuda(zxs, ws, revs, True)
    fwd_out = [tuple(torch.empty_like(x) for x in r) for r in res]
    dzx = [torch.empty_like(r[2]) for r in res]
    dws = [torch.empty(128, 512, device="cuda") for _ in range(2)]
    zg, zc, wg, wc, _ = cs._gru_inputs(128, 128, 128, torch.bfloat16, 1)
    ys, zr, cand = (torch.empty_like(x) for x in (zc, zg, zc))
    f32 = cs._rnn_inputs(32, 64, 128, 1, torch.float32, 1)
    f32_out = [torch.empty(32, 64, 128, device="cuda"),
               torch.empty(32, 64, 128, device="cuda"),
               torch.empty(32, 64, 512, device="cuda")]
    for _ in range(3):
        err = lib.bigdl_lstm_fwd(
            *_ptrs(f32[0]), *_ptrs(f32[1]), *_ptrs(f32_out[:1]),
            *_ptrs(f32_out[1:2]), *_ptrs(f32_out[2:]), 0, 0, 1, 32, 64, 128,
            1, 0, stream)
        if err:
            raise RuntimeError(f"instrumented fp32 forward: cudaError {err}")
    for _ in range(3):
        err = lib.bigdl_lstm_bwd(
            *_ptrs(ws), *_ptrs([r[0] for r in res]),
            *_ptrs([r[1] for r in res]), *_ptrs([r[2] for r in res]),
            *_ptrs(dys), *_ptrs(dzx), *_ptrs(dws), 0, 1, 2, 128, 128, 128,
            *fr.dw_split_plan(128 * 128, 8), 1, stream)
        err = err or lib.bigdl_gru_fwd(
            zg.data_ptr(), zc.data_ptr(), wg.data_ptr(), wc.data_ptr(),
            ys.data_ptr(), zr.data_ptr(), cand.data_ptr(), 128, 128, 128, 1,
            1, stream)
        err = err or lib.bigdl_lstm_fwd(
            *_ptrs(zxs), *_ptrs(ws), *_ptrs([o[0] for o in fwd_out]),
            *_ptrs([o[1] for o in fwd_out]), *_ptrs([o[2] for o in fwd_out]),
            0, 1, 2, 128, 128, 128, 1, 1, stream)
        if err:
            raise RuntimeError(f"instrumented kernels: cudaError {err}")
    torch.cuda.synchronize()
    for which, (key, spec) in enumerate(_PHASES.items()):
        if key not in keys:
            continue
        clocks = (ctypes.c_longlong * 128)()
        if lib.kernel_study_read(which, clocks):
            raise RuntimeError("could not read the phase clocks")
        names = [m[0] for m in spec[4]]
        steps = 64 if key == "k8_fp32_phases" else 128
        _emit({key: {
            f"warp {w}": {n: clocks[16 * w + i] / steps for i, n in
                          enumerate(names)} for w in (0, 3, 7)
            if any(clocks[16 * w:16 * w + 16])}})


# the bf16 forward's loop with a step's zx read after its product
# (shipped), and read ahead, right after the previous step's copy-out
_IN_AFTER = ("  for (int s = 0; s < nt; ++s) {\n"
             "    product(hop + (s & 1) * kTileRows * ld);\n"
             "    load_in(s);\n",
             "    copy_out(s, time_of(s));\n  }\n}\n")
_IN_FIRST = ("  load_in(0);\n  for (int s = 0; s < nt; ++s) {\n"
             "    product(hop + (s & 1) * kTileRows * ld);\n",
             "    copy_out(s, time_of(s));\n    if (s + 1 < nt) "
             "load_in(s + 1);\n  }\n}\n")


def _fwd_layout_sources(src: str) -> dict:
    """This tree's LSTM forward with the layouts that were measured and
    not kept, from the patches in ops/study/: in fp32, one CTA a tile
    with W's columns read from L2 every step (`one_cta`), and h exchanged
    by plain stores and a cluster barrier a step (`cluster_barrier`); in
    bf16, 2 or 4 of each gate tile's 8 k-steps read from shared memory
    (`shared_ksteps_2`, `shared_ksteps_4`), every lane running its four
    accumulator entries, those of B's zero rows included
    (`four_entries`), and a step's zx read ahead (`inputs_first`, from
    _IN_FIRST)."""
    study = Path(__file__).parent / "study"

    def patch(name):
        return _apply_diff(src, (study / f"lstm_fwd_{name}.diff").read_text())

    out = {k: patch(k) for k in ("one_cta", "cluster_barrier",
                                 "four_entries")}
    out["inputs_first"] = _replace_once(
        _replace_once(src, _IN_AFTER[0], _IN_FIRST[0]), _IN_AFTER[1],
        _IN_FIRST[1])
    shared = patch("shared_ksteps")
    for k in (2, 4):
        out[f"shared_ksteps_{k}"] = _replace_once(
            shared, "constexpr int kFwdSharedKSteps = 2;",
            f"constexpr int kFwdSharedKSteps = {k};")
    return out


# the unkept forward layouts part_k8 times beside the shipped one, and
# the dtype whose kernel each changes
_FWD_LAYOUTS = {"one_cta": "fp32", "cluster_barrier": "fp32",
                "shared_ksteps_2": "bf16", "shared_ksteps_4": "bf16",
                "four_entries": "bf16", "inputs_first": "bf16"}


def part_k8(torch, cs, fr, build: Path, logs, flush, stream) -> None:
    from bigdl_tpu_torch.ops import _build

    fns = {}
    for name in ("old_rnn_fwd", *(f"layout_fwd_{k}" for k in _FWD_LAYOUTS)):
        fn = ctypes.CDLL(str(build / f"{name}.so")).bigdl_lstm_fwd
        fn.argtypes = [VOID] * 10 + [ctypes.c_int] * 8 + [VOID]
        fns[name] = fn
    k8 = {}
    reps = dict(reps=10, warmup=2)
    for case, n, t, h, ndir in (("train_bi", 128, 128, 128, 2),
                                ("lm_uni", 32, 64, 128, 1)):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            zxs, ws, _, revs = cs._rnn_inputs(n, t, h, ndir, dtype, 1)
            out = [(z.new_empty(n, t, h), z.new_empty(n, t, h),
                    torch.empty_like(z)) for z in zxs]
            rv = [int(r) for r in revs] + [0] * (2 - ndir)

            def raw(fn, save):
                def call():
                    err = fn(*_ptrs(zxs), *_ptrs(ws),
                             *(p for i in range(3)
                               for p in _ptrs([o[i] for o in out])),
                             *rv, ndir, n, t, h, int(save),
                             int(dtype == torch.bfloat16), stream)
                    if err:
                        raise RuntimeError(f"LSTM forward: cudaError {err}")
                return call

            for save in (True, False):
                new = (lambda save=save:
                       fr.lstm_fwd_cuda(zxs, ws, revs, save))
                calls = {"old": raw(fns["old_rnn_fwd"], save), "new": new}
                r = {"us": _turns(cs, calls, flush, **reps),
                     "new_device_us": _profile(torch, new, flush, 10,
                                               "lstm_fwd")}
                # the unkept layouts, each in turns with the shipped one
                for lay_name in (k for k, v in _FWD_LAYOUTS.items()
                                 if v == name):
                    other = raw(fns[f"layout_fwd_{lay_name}"], save)
                    lay = _turns(cs, {"old": other, "new": new}, flush,
                                 **reps)
                    got = new()
                    other()
                    torch.cuda.synchronize()
                    r[lay_name] = {
                        "us": lay["old"], "shipped_us": lay["new"],
                        "same_bits": all(
                            torch.equal(a, b) for g, o in zip(got, out)
                            for a, b in zip(g, o) if a is not None)}
                k8[f"{case}/{name}/{'train' if save else 'infer'}"] = r
        # the yardstick: cuDNN's fp32 LSTM (input projection included)
        lstm = torch.nn.LSTM(h, h, batch_first=True,
                             bidirectional=ndir == 2).cuda()
        x = torch.randn(n, t, h, device="cuda", requires_grad=True)

        def infer():
            with torch.no_grad():
                lstm(x)

        k8[f"{case}/cudnn_fp32"] = {
            "train_us": [cs.cuda_ms(lambda: lstm(x), flush, **reps) * 1e3
                         for _ in range(2)],
            "infer_us": [cs.cuda_ms(infer, flush, **reps) * 1e3
                         for _ in range(2)]}
    k8["ptxas"] = {
        "new": _ptxas_lines(_build.BUILD_LOG["fused_rnn"], "lstm_fwd_"),
        **{k: _ptxas_lines(logs[f"layout_fwd_{k}"], "lstm_fwd_")
           for k in _FWD_LAYOUTS},
        "old": _ptxas_lines(logs["old_rnn_fwd"], "lstm_fwd_kernel")}
    _emit({"k8": k8})


# one run of the BiLSTM trainer's main path from the checkout in argv[1]:
# chip_smoke's rnn_trainer phase warmed once and then measured over
# E2E_STEPS steps, and its profiled step
_E2E_RUN = """
import json, os, sys
tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
cs.TRAIN_STEPS = int(sys.argv[2])
cs.phase_rnn_trainer()
cs.phase_rnn_trainer()
t = cs.RESULTS["rnn_trainer"]
cs.phase_rnn_profile()
p = cs.RESULTS.get("rnn_profile", {})
print("E2E " + json.dumps({
    "step_ms": t["step_ms"], "lm_step_ms": t["lm"]["step_ms"],
    "infer_ms_per_batch": t["infer"]["seconds"] / t["infer"]["batches"] * 1e3,
    "device_ms": p.get("device_ms_per_step"),
    "busy": p.get("device_busy_share")}))
"""
E2E_STEPS, E2E_PAIRS = 20, 4


def part_e2e(old_tree: Path) -> None:
    """The BiLSTM trainer's main path (step, predict pass, LSTM LM step,
    profiled device work) from the checkout at `old_tree` and from this
    one, one process a run, in turns (old, new, new, old) E2E_PAIRS
    times."""
    runs = {"old": [], "new": []}
    for _ in range(E2E_PAIRS // 2):
        for who in ("old", "new", "new", "old"):
            tree = old_tree if who == "old" else ROOT
            out = subprocess.run(
                [sys.executable, "-c", _E2E_RUN, str(tree), str(E2E_STEPS)],
                capture_output=True, text=True, timeout=900)
            line = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("E2E ")]
            if out.returncode or not line:
                raise RuntimeError(f"e2e run in {tree} failed:\n"
                                   f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
            runs[who].append(json.loads(line[0][4:]))
    _emit({"e2e": {"steps": E2E_STEPS, "order": "old new new old", **runs}})


def _flash_lib(path: Path) -> ctypes.CDLL:
    """A flash-attention library's two entry points, typed as
    ops/flash_attention.py types them."""
    lib = ctypes.CDLL(str(path))
    lib.bigdl_flash_fwd.argtypes = [VOID] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, VOID]
    lib.bigdl_flash_bwd.argtypes = [VOID] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [VOID]
    return lib


def part_flash_f32(torch, cs, build: Path, logs, flush, stream) -> None:
    """Old and new fp32 flash kernels at chip_smoke's timed cases."""
    from bigdl_tpu_torch.ops import _build
    # the module; `bigdl_tpu_torch.ops.flash_attention` is also a function
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    libs = {"old": _flash_lib(build / "old_fa.so"),
            "new": _flash_lib(_build.library_path("flash_attention"))}
    cases = {c[0]: c[1:] for c in cs.FLASH_CASES}
    out = {}
    for name in cs.FLASH_TIMED:
        bh, sq, sk, d, causal, scale = cases[name]
        scale = 1.0 / d ** 0.5 if scale is None else scale
        g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
        q, do = (torch.randn(bh, sq, d, device="cuda", generator=g)
                 for _ in range(2))
        k, v = (torch.randn(bh, sk, d, device="cuda", generator=g)
                for _ in range(2))
        o, lse = fa.attention_reference(q, k, v, causal, scale,
                                        return_lse=True)
        delta = ((do * o).sum(-1) * scale).contiguous()
        qp, kp, vp, dop = fa.pad_head_dim(q, k, v, do)
        dp = qp.shape[-1]
        # the old forward wrote one lse row a 128-column slice above 256
        rows = dp // 128 if dp > 256 else 1
        res = {}
        for who, lib in libs.items():
            fo = torch.empty_like(qp)
            fl = torch.empty(rows, bh, sq, device="cuda")
            dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))

            def fwd(lib=lib, fo=fo, fl=fl):
                err = lib.bigdl_flash_fwd(
                    qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    fo.data_ptr(), fl.data_ptr(), bh, sq, sk, dp, scale,
                    int(causal), 0, stream)
                if err:
                    raise RuntimeError(f"{who} forward: cudaError {err}")

            def bwd(lib=lib, dq=dq, dk=dk, dv=dv):
                err = lib.bigdl_flash_bwd(
                    qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    dop.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk,
                    dp, scale, scale, 1.0 / scale, 0, int(causal), 0,
                    stream)
                if err:
                    raise RuntimeError(f"{who} backward: cudaError {err}")

            fwd()
            bwd()
            torch.cuda.synchronize()
            res[who] = {"fwd": fwd, "bwd": bwd,
                        "outs": (fo[..., :d], fl[0], dq[..., :d],
                                 dk[..., :d], dv[..., :d])}
        reps = dict(reps=10, warmup=2)
        out[name] = {
            "shape": {"BH": bh, "Sq": sq, "Sk": sk, "D": d, "kernel_D": dp,
                      "causal": causal},
            "fwd_us": _turns(cs, {w: res[w]["fwd"] for w in libs}, flush,
                             **reps),
            "bwd_us": _turns(cs, {w: res[w]["bwd"] for w in libs}, flush,
                             **reps),
            "max_abs_diff": {n: float((a - b).abs().max()) for n, a, b in zip(
                ("out", "lse", "dq", "dk", "dv"), res["old"]["outs"],
                res["new"]["outs"])},
        }
        for kind in ("fwd", "bwd"):
            us = out[name][f"{kind}_us"]
            out[name][f"{kind}_speedup"] = (
                min(us["old"]) / max(min(us["new"]), 1e-9))
        del q, k, v, do, o, lse, delta, qp, kp, vp, dop, res
        torch.cuda.empty_cache()
    _emit({"flash_f32": out})
    names = {"old": [f"fa_{k}_{w}kernel" for k in ("fwd", "dkdv", "dq")
                     for w in ("", "wide_")],
             "new": ["_f32_kernel", "_f32_pp_kernel"]}
    build_out = {}
    for who, log, so in (("old", logs["old_fa"], build / "old_fa.so"),
                         ("new", _build.BUILD_LOG["flash_attention"],
                          _build.library_path("flash_attention"))):
        build_out[who] = {
            "ptxas": [ln for m in names[who] for ln in _ptxas_lines(log, m)],
            "sass": {k: c for m in names[who]
                     for k, c in _sass_counts(so, m).items()}}
    _emit({"flash_f32_build": build_out})


def _build_report(so: Path, log: str, match: str) -> dict:
    return {"ptxas": _ptxas_lines(log, match),
            "sass": _sass_counts(so, match)}


def part_k1_wide(torch, cs, build: Path, logs, flush, stream) -> None:
    """Old and new K1 row-split kernels (above D = 1024) at d1100."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import paged_decode as pd

    old = ctypes.CDLL(str(build / "old_pd_wide.so")).bigdl_paged_decode_wide
    old.argtypes = [VOID] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, VOID]
    new = pd._lib().bigdl_paged_decode_wide
    out = {}
    for D, timed in ((1100, True), (2049, False)):
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v, table, pos = cs._decode_case(
                dtype, flush.device, B=4, H=2, nb=96 // cs.BLOCK,
                bs=cs.BLOCK, D=D)
            b, h, _, d = q.shape
            nb, bs = table.shape[1], k.shape[2]
            bf16 = int(dtype == torch.bfloat16)
            plan = pd.wide_plan(nb, bs, d, k.element_size())
            copy = pd.wide_copy_bytes(d, k.element_size(), k, v)
            outs = {w: torch.empty_like(q) for w in ("old", "new")}
            scratch = torch.empty(b * h * nb * bs, device=q.device)

            def run_old():
                err = old(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          table.data_ptr(), pos.data_ptr(),
                          outs["old"].data_ptr(), scratch.data_ptr(), b, h,
                          nb, bs, d, d ** -0.5, bf16, stream)
                if err:
                    raise RuntimeError(f"old K1 wide: cudaError {err}")

            def run_new():
                err = new(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          table.data_ptr(), pos.data_ptr(),
                          outs["new"].data_ptr(), b, h, nb, bs, d,
                          plan["splits"], plan["span"], plan["chunks"], copy,
                          d ** -0.5, bf16, stream)
                if err:
                    raise RuntimeError(f"new K1 wide: cudaError {err}")

            run_old()
            run_new()
            torch.cuda.synchronize()
            ref = pd.paged_decode_attention(q, k, v, table, pos,
                                            impl="torch")
            res = {"plan": plan, "copy_bytes": copy,
                   "max_abs_diff": float((outs["old"] - outs["new"]).abs()
                                         .max()),
                   "new_vs_plain": float((outs["new"] - ref).abs().max())}
            if timed:
                res["us"] = _turns(cs, {"old": run_old, "new": run_new},
                                   flush)
                res["speedup"] = min(res["us"]["old"]) / max(
                    min(res["us"]["new"]), 1e-9)
            out[f"d{D}/{name}"] = res
    _emit({"k1_wide": out})
    so = _build.library_path("paged_decode")
    _emit({"k1_wide_build": {
        "old": _build_report(build / "old_pd_wide.so", logs["old_pd_wide"],
                             "paged_decode_wide"),
        "new": _build_report(so, _build.BUILD_LOG["paged_decode"],
                             "paged_decode_wide")}})


def part_flash_bf16_wide(torch, cs, build: Path, logs, flush,
                         stream) -> None:
    """Old and new bf16 flash forward above D = 256."""
    from bigdl_tpu_torch.ops import _build
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    libs = {"old": _flash_lib(build / "old_fa_wide.so"),
            "new": _flash_lib(_build.library_path("flash_attention"))}
    cases = {c[0]: c[1:] for c in cs.FLASH_CASES}
    cases["d4096"] = (1, 100, 140, 4096, True, None)
    out = {}
    for name in ("ragged_d320", "train_h1", "masked_d512", "wide_d1000",
                 "wide_d2000", "d4096"):
        bh, sq, sk, d, causal, scale = cases[name]
        scale = 1.0 / d ** 0.5 if scale is None else scale
        g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
        q = torch.randn(bh, sq, d, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(bh, sk, d, device="cuda", generator=g,
                            dtype=torch.bfloat16) for _ in range(2))
        qp, kp, vp = fa.pad_head_dim(q, k, v)
        dp = qp.shape[-1]
        res = {}
        for who, lib in libs.items():
            fo = torch.empty_like(qp)
            # the old forward wrote one lse row a 128-column slice
            fl = torch.empty(dp // 128, bh, sq, device="cuda")

            def fwd(lib=lib, fo=fo, fl=fl, who=who):
                err = lib.bigdl_flash_fwd(
                    qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    fo.data_ptr(), fl.data_ptr(), bh, sq, sk, dp, scale,
                    int(causal), 1, stream)
                if err:
                    raise RuntimeError(f"{who} forward: cudaError {err}")

            fwd()
            torch.cuda.synchronize()
            res[who] = {"fwd": fwd, "outs": (fo[..., :d], fl[0])}
        ro, rlse = fa.attention_reference(q, k, v, causal, scale,
                                          return_lse=True)
        out[name] = {
            "shape": {"BH": bh, "Sq": sq, "Sk": sk, "D": d, "kernel_D": dp,
                      "causal": causal},
            "plan": fa.wide_fwd_plan(dp),
            "max_abs_diff": {n: float((a.float() - b.float()).abs().max())
                             for n, a, b in zip(("out", "lse"),
                                                res["old"]["outs"],
                                                res["new"]["outs"])},
            "new_vs_plain": {
                "out": float((res["new"]["outs"][0].float() - ro.float())
                             .abs().max()),
                "lse": float((res["new"]["outs"][1] - rlse).abs().max())},
        }
        if name in cs.FLASH_TIMED:
            us = _turns(cs, {w: res[w]["fwd"] for w in libs}, flush,
                        reps=10, warmup=2)
            out[name]["fwd_us"] = us
            out[name]["fwd_speedup"] = min(us["old"]) / max(min(us["new"]),
                                                            1e-9)
        del q, k, v, qp, kp, vp, res, ro, rlse
        torch.cuda.empty_cache()
    _emit({"flash_bf16_wide": out})
    _emit({"flash_bf16_wide_build": {
        "old": _build_report(build / "old_fa_wide.so", logs["old_fa_wide"],
                             "fwd_bf16_wide"),
        "new": _build_report(_build.library_path("flash_attention"),
                             _build.BUILD_LOG["flash_attention"],
                             "fwd_bf16_wide")}})


def _sass_opcodes(so: Path, match: str) -> dict:
    """Per kernel whose mangled name holds `match`: the count of every
    SASS opcode (predicates dropped, modifiers kept)."""
    from bigdl_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out[name] = {}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            ops = ln.split("*/", 1)[1].strip().rstrip(" ;").split(" ")
            op = ops[1] if ops[0].startswith("@") and len(ops) > 1 else ops[0]
            out[name][op] = out[name].get(op, 0) + 1
    return out


# clock64 counters in the cluster backward kernels: (anchor, text put
# after it, or before it when the anchor starts with the text's place)
_EXCHANGE_FIELDS = ("free_wait", "push", "partner_wait", "sum", "tiles",
                    "tile_cycles")


def _exchange_clock_source(src: str) -> str:
    """csrc/flash_attention.cu with clock64 deltas of the cluster
    backward's exchange (`push_partial`: the wait for the partner's
    release, the push; `add_partial`: the wait for the partner's
    partial, the sum) and of each tile, summed over the CTAs of bh 0 by
    warp 0 of each warpgroup into ks_clk[((kind * 2 + rank) * 2 +
    warpgroup) * 6 + field] (kind 0 dk/dv, 1 dq; fields
    _EXCHANGE_FIELDS), read and zeroed through added
    `kernel_study_clk(out)` / `kernel_study_clk_zero()`."""
    on = "(blockIdx.y == 0 && (threadIdx.x & 127) == 0)"
    slot = "((kind_ * 2 + (blockIdx.x & 1)) * 2 + threadIdx.x / 128) * 6"
    push = "    uint32_t free_bar, int tile) {\n"
    src = _replace_once(src, push, push[:-4] + (
        ", long long& c0_, long long& cf_) {\n  c0_ = clock64();\n"))
    wait_free = ("  if (tile > 0) sm90::mbarrier_wait_cluster(free_bar, "
                 "(tile - 1) & 1);\n")
    src = _replace_once(src, wait_free, wait_free + "  cf_ = clock64();\n")
    add = ("    int rank) {\n  const int wt = threadIdx.x % kWGThreads;\n"
           "  sm90::mbarrier_wait_cluster(bar, tile & 1);\n")
    src = _replace_once(src, add, add.replace(
        "int rank) {", "int rank, long long& cw_) {") + "  cw_ = clock64();\n")
    src = _replace_once(src, "__device__ __forceinline__ void push_partial(",
                        "__device__ unsigned long long ks_clk[48];\n"
                        "__device__ __forceinline__ void push_partial(")
    record = (
        "    asm volatile(\"\" ::\"f\"(x[31]));\n"
        f"    if {on} {{\n      const int s_ = {slot};\n"
        "      atomicAdd(&ks_clk[s_ + 0], (unsigned long long)(cf_ - c0_));\n"
        "      atomicAdd(&ks_clk[s_ + 1], (unsigned long long)(cp_ - cf_));\n"
        "      atomicAdd(&ks_clk[s_ + 2], (unsigned long long)(cw_ - ca_));\n"
        "      atomicAdd(&ks_clk[s_ + 3], (unsigned long long)(clock64() - "
        "cw_));\n      atomicAdd(&ks_clk[s_ + 4], 1ull);\n    }\n")
    for kind, var, loop, tail in (
            (0, "i", "  for (int i = 0; i < n; ++i) {\n    const int q_start",
             "    if (tid < 32 && i + 2 < n) load(i + 2);\n"),
            (1, "t", "  for (int t = 0; t < n; ++t) {\n    const int k_start "
             "= t * kBK;\n    const uint32_t kst",
             "      if (tid < kWGThreads + 32 && t + 2 < n) load(t + 2);\n"
             "    }\n")):
        call = ("                 sm90::mapa(my_bar, rank ^ 1), bar_free, "
                f"{var});\n")
        src = _replace_once(src, call, call.replace(
            f"{var});", f"{var}, c0_, cf_);") + "    const long long cp_ = "
            "clock64();\n")
        call = f"    add_partial(x, buf, my_bar, {var}, rank);\n"
        src = _replace_once(src, call, (
            "    const long long ca_ = clock64();\n"
            + call.replace("rank);", "rank, cw_);") + record))
        first = loop.split("\n", 1)
        src = _replace_once(src, loop, first[0] + "\n    const long long it0_"
                            " = clock64();\n    const int kind_ = "
                            f"{kind};\n    long long c0_, cf_, cw_;\n"
                            + first[1])
        src = _replace_once(src, tail, tail + (
            f"    if {on}\n      atomicAdd(&ks_clk[{slot} + 5], "
            "(unsigned long long)(clock64() - it0_));\n"))
    return src + (
        '\nextern "C" int kernel_study_clk(unsigned long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, ks_clk, sizeof(ks_clk));\n}\n"
        'extern "C" int kernel_study_clk_zero() {\n'
        "  static const unsigned long long z[48] = {};\n"
        "  return (int)cudaMemcpyToSymbol(ks_clk, z, sizeof(z));\n}\n")


def part_flash_bf16_wide_bwd(torch, cs, build: Path, logs, flush,
                             stream) -> None:
    """Old and new bf16 flash backward above D = 256; the cluster
    kernels' exchange cycles from a clock64 copy."""
    from bigdl_tpu_torch.ops import _build
    fa = importlib.import_module("bigdl_tpu_torch.ops.flash_attention")

    libs = {"old": _flash_lib(build / "old_fa_bwd.so"),
            "new": _flash_lib(_build.library_path("flash_attention")),
            "clock": _flash_lib(build / "fa_clock.so")}
    clk = ctypes.CDLL(str(build / "fa_clock.so"))
    clk.kernel_study_clk.argtypes = [VOID]
    cases = {c[0]: c[1:] for c in cs.FLASH_CASES}
    cases["d4096"] = (1, 100, 140, 4096, True, None)
    out, clocks = {}, {}
    for name in ("ragged_d320", "train_h1", "masked_d512", "wide_d1000",
                 "wide_d2000", "d4096"):
        bh, sq, sk, d, causal, scale = cases[name]
        scale = 1.0 / d ** 0.5 if scale is None else scale
        g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
        q, do = (torch.randn(bh, sq, d, device="cuda", generator=g,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(bh, sk, d, device="cuda", generator=g,
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        delta = ((do.float() * o.float()).sum(-1) * scale).contiguous()
        qp, kp, vp, dop = fa.pad_head_dim(q, k, v, do)
        dp = qp.shape[-1]
        res = {}
        for who, lib in libs.items():
            grads = [torch.empty_like(t) for t in (qp, kp, vp)]

            def bwd(lib=lib, grads=grads, who=who):
                err = lib.bigdl_flash_bwd(
                    qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    dop.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    *(t.data_ptr() for t in grads), bh, sq, sk, dp, scale,
                    scale, 1.0 / scale, 0, int(causal), 1, stream)
                if err:
                    raise RuntimeError(f"{who} backward: cudaError {err}")

            if who == "clock":
                if name not in ("train_h1", "ragged_d320"):
                    continue
                buf = (ctypes.c_ulonglong * 48)()
                clk.kernel_study_clk_zero()
                bwd()
                torch.cuda.synchronize()
                clk.kernel_study_clk(buf)
                per = {}
                for kind, kname in enumerate(("dkdv", "dq")):
                    for rank in range(2):
                        for wg in range(2):
                            b = ((kind * 2 + rank) * 2 + wg) * 6
                            f = dict(zip(_EXCHANGE_FIELDS, buf[b:b + 6]))
                            tiles = max(f.pop("tiles"), 1)
                            per[f"{kname}/rank{rank}/wg{wg}"] = {
                                key: val / tiles for key, val in f.items()}
                            per[f"{kname}/rank{rank}/wg{wg}"]["tiles"] = tiles
                clocks[name] = per
                continue
            bwd()
            torch.cuda.synchronize()
            res[who] = {"bwd": bwd, "grads": [t[..., :d] for t in grads]}
        again = [torch.empty_like(t) for t in (qp, kp, vp)]
        err = libs["new"].bigdl_flash_bwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in again),
            bh, sq, sk, dp, scale, scale, 1.0 / scale, 0, int(causal), 1,
            stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"new backward: cudaError {err}")
        fg = fa.flash_backward_tiled(q, k, v, o, lse, do, causal, scale)
        terms = cs._largest_terms(fa, q, k, v, o, lse, do, causal, scale)
        names = ("dq", "dk", "dv")
        out[name] = {
            "shape": {"BH": bh, "Sq": sq, "Sk": sk, "D": d, "kernel_D": dp,
                      "causal": causal},
            "plan": fa.wide_bwd_plan(dp),
            "max_abs_diff": {n: float((a.float() - b.float()).abs().max())
                             for n, a, b in zip(names, res["old"]["grads"],
                                                res["new"]["grads"])},
            "new_vs_tiled": {n: cs._ulp_stats(a.contiguous(), b, t)
                             for n, a, b, t in zip(
                                 names, res["new"]["grads"], fg, terms[1:])},
            "old_vs_tiled": {n: cs._ulp_stats(a.contiguous(), b, t)
                             for n, a, b, t in zip(
                                 names, res["old"]["grads"], fg, terms[1:])},
            "new_bitwise_run_to_run": all(
                torch.equal(a[..., :d], b)
                for a, b in zip(again, res["new"]["grads"])),
        }
        if name != "d4096":
            us = _turns(cs, {w: res[w]["bwd"] for w in ("old", "new")},
                        flush, reps=10, warmup=2)
            out[name]["bwd_us"] = us
            out[name]["bwd_speedup"] = min(us["old"]) / max(min(us["new"]),
                                                            1e-9)
        del q, k, v, do, o, lse, delta, qp, kp, vp, dop, res, again, fg
        del terms
        torch.cuda.empty_cache()
    _emit({"flash_bf16_wide_bwd": out})
    _emit({"flash_bf16_wide_bwd_clocks": {
        "note": "cycles a tile, means over the tiles of bh 0's CTAs, "
                "warp 0 of each warpgroup", **clocks}})
    so = _build.library_path("flash_attention")
    log = _build.BUILD_LOG["flash_attention"]
    _emit({"flash_bf16_wide_bwd_build": {
        "old": {m: _build_report(build / "old_fa_bwd.so", logs["old_fa_bwd"],
                                 m)
                for m in ("dkdv_bf16_wide", "dq_bf16_wide")},
        "new": {m: _build_report(so, log, m)
                for m in ("bf16_cluster", "dkdv_bf16_wide", "dq_bf16_wide")},
        "new_cluster_opcodes": _sass_opcodes(so, "bf16_cluster")}})


PARTS = ("k9", "k10", "layouts", "phases", "k1_k11", "k11_phases", "k8",
         "k8_phases", "e2e", "flash_f32", "k1_wide", "flash_bf16_wide",
         "flash_bf16_wide_bwd")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="directory of the earlier fused_rnn.cu (and "
                         "paged_decode.cu for k1_k11 and k1_wide, "
                         "flash_attention.cu for flash_f32, "
                         "flash_bf16_wide and flash_bf16_wide_bwd)")
    ap.add_argument("--parts", default="k9,k10,layouts,phases",
                    help=f"comma-separated, of {','.join(PARTS)}")
    ap.add_argument("--old-tree", type=Path,
                    help="a checkout of the earlier commit, for e2e")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    for p in parts:
        if p not in PARTS:
            ap.error(f"unknown part {p!r}")
    needs_old = {"k9", "k10", "k1_k11", "k8", "flash_f32", "k1_wide",
                 "flash_bf16_wide", "flash_bf16_wide_bwd"}
    if args.old is None and set(parts) & needs_old:
        ap.error(f"--old is needed for {', '.join(sorted(needs_old))}")
    if args.old_tree is None and "e2e" in parts:
        ap.error("--old-tree is needed for e2e")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import fused_rnn as fr

    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    base = (args.old or ROOT / ".cmp").resolve()
    old, build = base, base / "build"
    build.mkdir(parents=True, exist_ok=True)
    # every build the parts need, started together with the tree's own
    procs = {}
    rnn = (_build.CSRC / "fused_rnn.cu").read_text()
    if {"k9", "k10"} & set(parts):
        for name, text in _lstm_old_variants(
                (old / "fused_rnn.cu").read_text()).items():
            (build / f"old_lstm_{name}.cu").write_text(text)
            procs[f"old_lstm_{name}"] = _nvcc(build / f"old_lstm_{name}.cu",
                                              build / f"old_lstm_{name}.so",
                                              include=_build.CSRC)
    if "layouts" in parts:
        for name, text in _layout_sources(rnn).items():
            (build / f"layout_{name}.cu").write_text(text)
            procs[f"layout_{name}"] = _nvcc(build / f"layout_{name}.cu",
                                            build / f"layout_{name}.so",
                                            include=_build.CSRC)
    if "k1_k11" in parts:
        procs["old_pd"] = _nvcc(old / "paged_decode.cu", build / "old_pd.so")
        for name, text in _gru_old_variants(
                (old / "fused_rnn.cu").read_text()).items():
            (build / f"old_rnn_{name}.cu").write_text(text)
            procs[f"old_rnn_{name}"] = _nvcc(build / f"old_rnn_{name}.cu",
                                             build / f"old_rnn_{name}.so",
                                             include=_build.CSRC)
    if "k8" in parts:
        (build / "old_rnn_fwd.cu").write_text(
            (old / "fused_rnn.cu").read_text())
        procs["old_rnn_fwd"] = _nvcc(build / "old_rnn_fwd.cu",
                                     build / "old_rnn_fwd.so",
                                     include=_build.CSRC)
        for name, text in _fwd_layout_sources(rnn).items():
            (build / f"layout_fwd_{name}.cu").write_text(text)
            procs[f"layout_fwd_{name}"] = _nvcc(
                build / f"layout_fwd_{name}.cu",
                build / f"layout_fwd_{name}.so", include=_build.CSRC)
    if {"phases", "k8_phases"} & set(parts):
        (build / "clocks.cu").write_text(_clock_source(rnn))
        procs["clocks"] = _nvcc(build / "clocks.cu", build / "clocks.so",
                                include=_build.CSRC)
    if "k11_phases" in parts:
        (build / "phases.cu").write_text(_phase_source(rnn))
        procs["phases"] = _nvcc(build / "phases.cu", build / "phases.so",
                                include=_build.CSRC)
    if "flash_f32" in parts:
        procs["old_fa"] = _nvcc(old / "flash_attention.cu",
                                build / "old_fa.so", include=_build.CSRC)
    if "k1_wide" in parts:
        procs["old_pd_wide"] = _nvcc(old / "paged_decode.cu",
                                     build / "old_pd_wide.so",
                                     include=_build.CSRC)
    if "flash_bf16_wide" in parts:
        procs["old_fa_wide"] = _nvcc(old / "flash_attention.cu",
                                     build / "old_fa_wide.so",
                                     include=_build.CSRC)
    if "flash_bf16_wide_bwd" in parts:
        procs["old_fa_bwd"] = _nvcc(old / "flash_attention.cu",
                                    build / "old_fa_bwd.so",
                                    include=_build.CSRC)
        (build / "fa_clock.cu").write_text(_exchange_clock_source(
            (_build.CSRC / "flash_attention.cu").read_text()))
        procs["fa_clock"] = _nvcc(build / "fa_clock.cu", build / "fa_clock.so",
                                  include=_build.CSRC)
    _build.build(["paged_decode", "fused_rnn"]
                 + (["flash_attention"] if {"flash_f32", "flash_bf16_wide",
                                            "flash_bf16_wide_bwd"}
                    & set(parts) else []))
    logs = _wait(procs)
    _emit({"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()})
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for p in parts:
        if p == "k9":
            part_k9(torch, cs, fr, build, flush, stream)
        elif p == "k10":
            part_k10(torch, cs, fr, build, logs, flush, stream)
        elif p == "layouts":
            part_layouts(torch, cs, fr, build, logs, flush, stream)
        elif p == "phases":
            part_phases(torch, cs, fr, build, stream)
        elif p == "k8":
            part_k8(torch, cs, fr, build, logs, flush, stream)
        elif p == "k8_phases":
            part_phases(torch, cs, fr, build, stream,
                        keys=("k8_phases", "k8_fp32_phases"))
        elif p == "e2e":
            part_e2e(args.old_tree.resolve())
        elif p == "k1_k11":
            part_k1_k11(torch, cs, fr, build, flush, stream)
        elif p == "flash_f32":
            part_flash_f32(torch, cs, build, logs, flush, stream)
        elif p == "k1_wide":
            part_k1_wide(torch, cs, build, logs, flush, stream)
        elif p == "flash_bf16_wide":
            part_flash_bf16_wide(torch, cs, build, logs, flush, stream)
        elif p == "flash_bf16_wide_bwd":
            part_flash_bf16_wide_bwd(torch, cs, build, logs, flush, stream)
        else:
            part_k11_phases(torch, cs, fr, build, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
