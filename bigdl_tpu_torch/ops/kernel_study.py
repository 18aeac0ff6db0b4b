"""Compare this tree's paged-decode (K1) and GRU-backward (K11) CUDA
kernels with their earlier designs on one CUDA card, and show where the
new kernels' time goes. A measuring tool: nothing in the port uses it.

    mkdir -p .cmp/old                # any directory; .cmp/ is git-ignored
    git show <rev>:bigdl_tpu_torch/ops/csrc/paged_decode.cu > .cmp/old/paged_decode.cu
    git show <rev>:bigdl_tpu_torch/ops/csrc/fused_rnn.cu > .cmp/old/fused_rnn.cu
    python3 -m bigdl_tpu_torch.ops.kernel_study --old .cmp/old   # repository root

The old sources carry the entry points of the designs before the Hopper
redesign: `bigdl_paged_decode` without a split plan, and
`bigdl_gru_bwd` taking W transposed and writing dW as (tiles, H, 3H)
fp32 partials. Prints one JSON line each:

* `k1`: old and new in turns (old, new, new, old; `chip_smoke.cuda_ms`)
  at the engine shape, fp32 and bf16 pools, and the new kernel's
  torch.profiler device time there and on one key;
* `k11`: old and new in turns at the trainer shape (N = T = H = 128),
  bf16 and fp32, the old also with the two tile sums its caller ran, and
  the new call's sweep and dW kernels' profiler times;
* `k11_old_split`: the old kernel whole, its sweep alone (the dW tail's
  calls removed) and its dW tail alone (the sweep run zero times);
* `k11_phases`: clock cycles a step in each phase of the new bf16 sweep
  (`clock64` written into a copy of csrc/fused_rnn.cu), warps 0, 3 and
  7 of CTA 0.

Builds go to <old>/build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VOID = ctypes.c_void_p


def _nvcc(src: Path, out: Path, include: Path = None) -> subprocess.Popen:
    from bigdl_tpu_torch.ops import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    if include is not None:
        cmd[1:1] = ["-I", str(include)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: dict) -> None:
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"expected one {old!r} in the source")
    return text.replace(old, new)


def _old_variants(old_rnn: str) -> dict:
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


def _profile(torch, fn, flush, reps: int, match: str) -> dict:
    """Mean device time a call of each kernel whose name holds `match`,
    over `reps` calls after an L2 flush each."""
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
        if match in e.key and e.self_device_time_total > 0:
            name = re.search(r"\w+_kernel", e.key)
            out[name.group(0) if name else e.key[:40]] = \
                e.self_device_time_total / reps
    return out


def _turns(cs, calls: dict, flush, **reps) -> dict:
    out = {k: [] for k in calls}
    for who in ("old", "new", "new", "old"):
        out[who].append(cs.cuda_ms(calls[who], flush, **reps) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory of the earlier paged_decode.cu and "
                         "fused_rnn.cu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import fused_rnn as fr
    from bigdl_tpu_torch.ops import paged_decode as pd

    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    old, build = args.old.resolve(), args.old.resolve() / "build"
    build.mkdir(parents=True, exist_ok=True)
    variants = _old_variants((old / "fused_rnn.cu").read_text())
    procs = {"old_pd": _nvcc(old / "paged_decode.cu", build / "old_pd.so")}
    for name, text in variants.items():
        (build / f"old_rnn_{name}.cu").write_text(text)
        procs[f"old_rnn_{name}"] = _nvcc(build / f"old_rnn_{name}.cu",
                                         build / f"old_rnn_{name}.so")
    (build / "phases.cu").write_text(
        _phase_source((_build.CSRC / "fused_rnn.cu").read_text()))
    procs["phases"] = _nvcc(build / "phases.cu", build / "phases.so",
                            include=_build.CSRC)
    _build.build(["paged_decode", "fused_rnn"])
    _wait(procs)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

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
    print(json.dumps({"k1": k1}), flush=True)

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

        def old(which="whole"):
            return bwd[which](
                wgt.data_ptr(), wct.data_ptr(), ys.data_ptr(), zr.data_ptr(),
                cand.data_ptr(), dy.data_ptr(), dzg.data_ptr(),
                dzc.data_ptr(), dwg.data_ptr(), dwc.data_ptr(), 128, 128,
                128, int(dtype == torch.bfloat16), stream)

        calls = {"old": old,
                 "new": lambda: fr.gru_bwd_cuda(wg, wc, ys, zr, cand, dy)}
        reps = dict(reps=10, warmup=2)
        k11[name] = {
            "us": _turns(cs, calls, flush, **reps),
            "old_with_sums_us": cs.cuda_ms(
                lambda: (old(), dwg.sum(0), dwc.sum(0)), flush,
                **reps) * 1e3,
            "new_device_us": _profile(torch, calls["new"], flush, 10,
                                      "gru_")}
        split[name] = {w: [cs.cuda_ms(lambda: old(w), flush, **reps) * 1e3
                           for _ in range(3)] for w in variants}
    print(json.dumps({"k11": k11}), flush=True)
    print(json.dumps({"k11_old_split": split}), flush=True)

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
    print(json.dumps({"k11_phases": {
        f"warp {w}": {n: clocks[8 * w + i] / 128 for i, n in
                      enumerate(names)} for w in (0, 3, 7)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
