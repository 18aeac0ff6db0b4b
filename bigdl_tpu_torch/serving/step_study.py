"""Compare the serving engine's decode step across trees and variants on
one CUDA card: host and device milliseconds a step at the 43M LM's
widths (chip_smoke.py's engine shape). A measuring tool: nothing in the
port uses it.

    mkdir -p .cmp/parent             # any directory; .cmp/ is git-ignored
    git archive <rev> | tar -x -C .cmp/parent
    python3 -m bigdl_tpu_torch.serving.step_study --old-tree .cmp/parent

Each variant runs in a process of its own (`--worker`), started one after
another (each builds its tree's paged-decode kernel on its first step)
and warmed up; then the variants take turns, forward and backward, for
`--runs` rounds, so every variant sees the host in the same states:

* `parent`: the tree at `--old-tree`, as it is;
* `tree`: this tree, as it is;
* `caller_stream`: this tree with the engine on the caller's stream
  rather than a stream of its own;
* `obs_off`: this tree with `BIGDL_OBS=off` (no registry series, events
  or spans).

A round of a variant, all on one engine (8 slots, chip_smoke's
`ENGINE_KNOBS`): one serving wave of 16 requests (`_wave`, 64 new tokens
each; host ms a decode step = the wave's wall time over its decode
steps, prefills included, as the engine phase reports it); a window of
32 steady steps with all 8 slots decoding, on the host clock; the same
window under torch.profiler (device ms a step = the kernels' and copies'
self device time over 32; K1's share and its time a launch); and a
speculative verify-shaped call, 8 x (3 + 1) = 32 rows through the
engine's model into its scratch block, on the host clock (each call
fetches its argmax, as a round does) and under torch.profiler, with
the engine's row tile where the tree's decode step takes one
(`row_tile`: four 8-row tiles) and as one 32-row call where it does
not. Every variant's wave takes the same seeds in a round, so their
tokens are compared too. One JSON object is printed and written to `--out`.

`calibration(cs, eng, runs)` is the fleet simulator's card reading
(serving/sim.py, `CostModel.from_card_reading`): over `runs` rounds, the
host ms of a steady decode step with every slot decoding (one token a
slot: the decode ms a token) and the ms a prompt token of prefilling
`eng.slots` distinct prompts of `cs.CONTEXT` tokens (one token each, so
no decode step), both fenced by a synchronise; their medians, and the
decode readings' spread (half their range over their median).
chip_smoke.py's sim_calibration phase takes it.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
VARIANTS = ("parent", "tree", "caller_stream", "obs_off")
STEADY_STEPS = 32
VERIFY_CALLS = 30


def _smoke():
    """This tree's chip_smoke.py, loaded by path: its model, wave and
    engine knobs are the workload for every tree. Its helpers import
    `bigdl_tpu_torch` from sys.path, i.e. from the worker's tree."""
    spec = importlib.util.spec_from_file_location(
        "_step_study_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(cs, eng, seed, prof=None) -> float:
    """Seconds of STEADY_STEPS decode steps with every slot decoding
    (the wave's 8 first admissions land in the first of 4 lead steps);
    the rest of the wave is drained after."""
    import torch

    from bigdl_tpu_torch.serving import Request

    for r in cs._wave(seed):
        eng.submit(Request(**r))
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if prof is None:
        for _ in range(STEADY_STEPS):
            eng.step()
        torch.cuda.synchronize()
    else:
        with prof:
            for _ in range(STEADY_STEPS):
                eng.step()
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.run()
    return dt


def _device_rows(prof):
    """(self device us, count, name) of the profiler's device rows (a
    CPU op's row repeats the time of the kernels it launched)."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def _verify(cs, eng) -> dict:
    """Host and device ms of a verify-shaped call (see the docstring)."""
    import inspect

    import torch
    from torch.profiler import ProfilerActivity, profile

    k1 = cs.SPEC_K + 1
    n = eng.slots * k1
    dev = eng.device
    tok = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev) % k1
    table = torch.zeros((n, eng._table.shape[1]), dtype=torch.int32,
                        device=dev)
    step = eng.model.decode_step_paged
    kw = ({"row_tile": eng.slots}
          if "row_tile" in inspect.signature(step).parameters else {})

    def calls():
        with torch.no_grad():
            for _ in range(VERIFY_CALLS):
                logits, _ = step(eng._params, tok, pos, eng.pool, table,
                                 attn_impl=eng.attn_impl, **kw)
                logits.argmax(-1).cpu()

    calls()                                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    host = time.perf_counter() - t0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        calls()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    return {"verify_rows": n, "verify_row_tile": kw.get("row_tile", n),
            "verify_ms_per_call": host / VERIFY_CALLS * 1e3,
            "verify_device_ms_per_call": (
                sum(r[0] for r in rows) / 1e3 / VERIFY_CALLS
                if rows else "not measured"),
            "verify_kernels_per_call": sum(r[1] for r in rows)
            / VERIFY_CALLS}


def _measure(cs, eng, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    res, dt, steps, launches = cs._timed_run(eng, cs._wave(seed))
    tokens = json.dumps([r.tokens for r in res]).encode()
    steady = _window(cs, eng, seed + 1)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    profiled = _window(cs, eng, seed + 2, prof)
    rows = _device_rows(prof)
    k1 = [(us, n) for us, n, key in rows if "paged_decode" in key]
    k1_us, k1_n = sum(r[0] for r in k1), sum(r[1] for r in k1)
    n = STEADY_STEPS
    return {
        "wave_ms_per_step": dt / steps * 1e3, "wave_steps": steps,
        "wave_launches": launches,
        "tokens_sha1": hashlib.sha1(tokens).hexdigest()[:12],
        "steady_ms_per_step": steady / n * 1e3,
        "profiled_ms_per_step": profiled / n * 1e3,
        "device_ms_per_step": (sum(r[0] for r in rows) / 1e3 / n
                               if rows else "not measured"),
        "kernels_per_step": sum(r[1] for r in rows) / n,
        "k1_ms_per_step": k1_us / 1e3 / n,
        "k1_launches_per_step": k1_n / n,
        "k1_us_per_launch": k1_us / k1_n if k1_n else "not measured",
        "device_busy_share": (sum(r[0] for r in rows) / 1e3
                              / (steady * 1e3) if rows else "not measured"),
        **_verify(cs, eng),
    }


def _prefill_ms_per_token(cs, eng, seed: int) -> float:
    """ms a prompt token of admitting `eng.slots` distinct prompts of
    cs.CONTEXT tokens, each asking for one token (the prefill emits it,
    so the round runs no decode step)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    reqs = [Request(prompt=[int(t) for t in rng.randint(1, cs.VOCAB,
                                                        cs.CONTEXT)],
                    max_new_tokens=1) for _ in range(eng.slots)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (eng.slots * cs.CONTEXT)


def calibration(cs, eng, runs: int = 3, seed: int = 3000) -> dict:
    """The simulator's card reading (see the module docstring): one
    untimed round, then `runs` timed ones."""
    _window(cs, eng, seed)
    _prefill_ms_per_token(cs, eng, seed)
    decode, prefill = [], []
    for i in range(runs):
        decode.append(_window(cs, eng, seed + 10 * (i + 1))
                      / STEADY_STEPS * 1e3)
        prefill.append(_prefill_ms_per_token(cs, eng, seed + 10 * i + 5))
    med = statistics.median(decode)
    return {"decode_ms_per_token": med,
            "prefill_ms_per_token": statistics.median(prefill),
            "spread_frac": (max(decode) - min(decode)) / 2.0 / med,
            "context_bucket": cs.CONTEXT,
            "decode_ms_runs": decode, "prefill_ms_runs": prefill,
            "engine": {"slots": eng.slots, "layers": cs.LAYERS,
                       "dim": cs.DIM, "vocab": cs.VOCAB,
                       "steady_steps": STEADY_STEPS}}


def _worker(root: Path, variant: str) -> None:
    """Serve `{"seed": s}` lines on stdin with one JSON line each on the
    original stdout; all else the run prints goes to stderr."""
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.path[0] = str(root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    from bigdl_tpu_torch.serving import InferenceEngine, Request

    model, params = cs._model()
    eng = InferenceEngine(model, params, **cs.ENGINE_KNOBS)
    if variant == "caller_stream":
        eng._stream = None
    eng.run([Request(**r) for r in cs._wave(0)])          # warm-up
    proto.write(json.dumps({"ready": variant}) + "\n")
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("quit"):
            break
        out = _measure(cs, eng, cmd["seed"])
        proto.write(json.dumps(dict(out, variant=variant)) + "\n")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _summary(runs):
    out = {}
    for key, v in runs[0].items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            vals = [r[key] for r in runs]
            out[key] = {"median": statistics.median(vals),
                        "min": min(vals), "max": max(vals), "runs": vals}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-tree", type=Path,
                    help="a checkout of the earlier tree (the parent "
                         "variant runs only with it)")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "step_study.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        _worker(a.root.resolve(), a.variant)
        return 0
    variants = [v for v in a.variants.split(",")
                if v != "parent" or a.old_tree is not None]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    card = _card()
    workers = {}
    results = {v: [] for v in variants}
    t0 = time.perf_counter()
    try:
        for v in variants:
            root = (a.old_tree if v == "parent" else REPO).resolve()
            env = dict(os.environ)
            if v == "obs_off":
                env["BIGDL_OBS"] = "off"
            w = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 "--root", str(root), "--variant", v],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                cwd=str(root), env=env)
            workers[v] = w
            line = w.stdout.readline()
            if not line:
                raise RuntimeError(f"worker {v} exited {w.wait()}")
        for i in range(a.runs):
            for v in (variants if i % 2 == 0 else variants[::-1]):
                w = workers[v]
                w.stdin.write(json.dumps({"seed": 1000 + 10 * i}) + "\n")
                w.stdin.flush()
                line = w.stdout.readline()
                if not line:
                    raise RuntimeError(f"worker {v} exited {w.wait()}")
                results[v].append(json.loads(line))
    finally:
        for w in workers.values():
            try:
                w.stdin.write(json.dumps({"quit": True}) + "\n")
                w.stdin.close()
                w.wait(timeout=120)
            except (OSError, subprocess.SubprocessError):
                w.kill()
                w.wait()
    same = {v: all(r["tokens_sha1"] == t["tokens_sha1"]
                   for r, t in zip(results[v], results[variants[0]]))
            for v in variants}
    report = {"card": card, "runs": a.runs, "order": variants,
              "seconds": time.perf_counter() - t0,
              "tokens_equal_to_first_variant": same,
              "variants": {v: _summary(results[v]) for v in variants}}
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(report, indent=1))
    brief = {v: {k: (s["median"], s["min"], s["max"])
                 for k, s in report["variants"][v].items()
                 if k in ("wave_ms_per_step", "steady_ms_per_step",
                          "device_ms_per_step", "k1_us_per_launch",
                          "kernels_per_step", "verify_ms_per_call",
                          "verify_device_ms_per_call")}
             for v in variants}
    print(json.dumps({"card": card, "tokens_equal": same, "median_min_max":
                      brief}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
