"""Multi-process smoke and failure-recovery test: launched processes
SIGKILLed mid-training and resumed.

Ports scripts/multihost_smoke.py to bigdl_tpu_torch. The JAX script
runs N real `jax.distributed` processes of M devices each; the port
runs one process a device, so each leg's `processes x devices` becomes
processes only, and the mesh's data axis is the process count. Each
process joins the group through `Engine.init_distributed` from
BIGDL_COORDINATOR / BIGDL_NUM_PROCESSES / BIGDL_PROCESS_ID, the
product's bring-up path: gloo with `--device cpu`, NCCL with `cuda`
(process i on card i; with fewer cards than processes the launcher
raises). Every launch takes a free port of its own.

Each process trains `Linear(8,16)-ReLU-Linear(16,4)-LogSoftMax` with
Adam through `Optimizer(...).set_mesh(make_mesh({"data": world}))` on
its own shard (`DataSet.sharded(..., seed=3)`, global batch 32,
gradient accumulation 2, validation every 3 steps over 33 samples whose
shards differ in batch count), checkpoints every 3 steps, and writes
`proc<pid>.json`: `digest` (sum of |params|), `sha256` of the flat fp32
parameter bytes, `resumed_from` and `corrupt_skipped`.

Legs (process counts are each leg function's `n`):

    smoke         2 processes: 3 steps and a checkpoint, then an
                  in-process resume and 3 more; the digests agree
    kill_resume   4 processes: an uninterrupted 12-step run's sha256;
                  a second run has process 2 SIGKILLed once
                  checkpoint-3 publishes (the others wedge in the
                  collective and are reaped), then every process
                  restarts with --resume: every sha256 equals the
                  uninterrupted run's
    ckpt_corrupt  4 processes: the job is killed once checkpoint-6
                  publishes and that checkpoint's model.npz is
                  truncated to half; every process skips it, resumes
                  from checkpoint-3 and ends bit-identical
    zero2_resume  2 processes, ZeRO-2 with sharded asynchronous saves:
                  process 1 is SIGKILLed after the first sharded
                  checkpoint's MANIFEST publishes; the restart ends
                  bit-identical. The first checkpoint holds one shard
                  unit a process (the JAX script's, one a device)

With one process (chip_smoke runs the kill legs so on one card) the
sole process is the one killed. A run that is killed is paced
(`--pace` seconds a step, a sleep while reading its data, which does
not touch the numbers) so that the kill lands mid-training; a leg
whose kill did not land reports `ok: false` with its stage.

    python -m bigdl_tpu_torch.scripts.multihost_smoke \\
        [--legs smoke,kill_resume,ckpt_corrupt,zero2_resume] \\
        [--device cuda|cpu] [--out PATH]

The artefact goes to `--out` (default: a fresh temporary directory)
and is printed as the last line; the exit code is 0 only when every
leg passed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

# each leg and its process count (the JAX script's processes x devices)
LEGS = {"smoke": 2, "kill_resume": 4, "ckpt_corrupt": 4, "zero2_resume": 2}
GLOBAL_BATCH = 32
END_ITER = 12
PACE = 0.1            # seconds a step of a run that is to be killed
KILL_GRACE = 5.0      # the survivors' time to wedge before the reap
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ------------------------------------------------------------------ child
class _Pace(Transformer):
    """Sleeps `seconds_per_row` before each element it passes on (a
    paced data stream; the rows are untouched)."""

    def __init__(self, seconds_per_row: float):
        self.seconds_per_row = seconds_per_row

    def apply(self, it):
        for x in it:
            time.sleep(self.seconds_per_row)
            yield x


def _load_init(model, path: str, device) -> None:
    """Install the parameters stored in `path` (an npz whose keys are
    the param tree's '/'-joined paths) in `model`."""
    import torch

    with np.load(path) as z:
        flat = dict(z)

    def fill(tree, prefix):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else torch.as_tensor(flat["/".join(prefix + (k,))]).to(
                    device) for k, v in tree.items()}

    model.variables = {"params": fill(model.variables["params"], ()),
                       "state": model.variables["state"]}


def child(args) -> None:
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.optim import Adam, Loss, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.engine import Engine

    if args.device == "cuda":
        if torch.cuda.device_count() < args.num_processes:
            raise RuntimeError(f"{args.num_processes} processes need one "
                               f"card each; torch sees "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(args.process_id)
        device = torch.device("cuda", args.process_id)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    # the product bring-up path: what a pod launcher exports
    os.environ["BIGDL_COORDINATOR"] = f"localhost:{args.port}"
    os.environ["BIGDL_NUM_PROCESSES"] = str(args.num_processes)
    os.environ["BIGDL_PROCESS_ID"] = str(args.process_id)
    Engine.init_distributed(
        backend="nccl" if device.type == "cuda" else "gloo")
    world = dist.get_world_size()
    assert world == args.num_processes, world

    rng = np.random.RandomState(0)  # same data everywhere, sharded below
    x = (rng.randn(128, 8).astype(np.float32)
         + np.repeat(np.eye(4, 8) * 3, 32, 0).astype(np.float32))
    y = np.repeat(np.arange(4), 32)
    elements = [Sample(x[i], int(y[i])) for i in range(128)]
    dataset = DataSet.sharded(elements, seed=3)        # per-process shard
    if args.pace:
        dataset = dataset.transform(_Pace(args.pace * world / GLOBAL_BATCH))
    # 33 samples: shards whose validation batch counts differ
    val = DataSet.sharded(elements[:33], seed=3)

    def build():
        model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                              nn.LogSoftMax()).build(
            torch.Generator().manual_seed(0), device=device)
        if args.init:
            _load_init(model, args.init, device)
        return model

    mesh = make_mesh({"data": world}, device=device)
    ckpt = os.path.join(args.workdir, "ckpt")

    def train(end_iter, resume):
        opt = (Optimizer(build(), dataset, nn.ClassNLLCriterion(),
                         batch_size=GLOBAL_BATCH)          # GLOBAL batch
               .set_optim_method(Adam(learningrate=1e-2))
               .set_gradient_accumulation(2)
               .set_end_when(Trigger.max_iteration(end_iter))
               .set_validation(Trigger.several_iteration(3), val,
                               [Loss(nn.ClassNLLCriterion())], GLOBAL_BATCH)
               .set_checkpoint(ckpt, Trigger.several_iteration(3),
                               sharded=args.zero2, async_save=args.zero2)
               .set_mesh(mesh, zero=2 if args.zero2 else 1))
        if resume:
            opt.resume_from_checkpoint()
        return opt.optimize(), opt

    if args.leg == "smoke":
        train(3, resume=False)           # 3 steps + checkpoint
        model, opt = train(6, resume=True)
    else:
        model, opt = train(args.end_iter, resume=args.resume)
    flat = np.concatenate([t.detach().float().cpu().numpy().ravel()
                           for _, t in model.parameters()])
    assert np.isfinite(flat).all(), "non-finite parameters"
    digest = float(np.sum(np.abs(flat)))
    sha = hashlib.sha256(flat.tobytes()).hexdigest()
    out = {"process_id": args.process_id, "digest": digest, "sha256": sha,
           "processes": world, "device": str(device),
           "checkpoint_resumed": args.leg == "smoke" or args.resume,
           "resumed_from": os.path.basename(
               opt.checkpoint._last_loaded or "") if args.resume else None,
           "corrupt_skipped": [os.path.basename(d) for d
                               in opt.checkpoint.corrupt_skipped]}
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(args.workdir, f"proc{args.process_id}.json"),
              "w") as f:
        json.dump(out, f)
    print(f"[proc {args.process_id}] OK digest={digest:.6f} sha={sha[:12]}")


# --------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_group(leg: str, n: int, workdir: str, device: str,
                 end_iter: int = 6, resume: bool = False,
                 zero2: bool = False, pace: float = 0.0,
                 init: Optional[str] = None) -> List[subprocess.Popen]:
    """Start the `n` processes of one job on a free port; each one's
    output goes to workdir/proc<pid>.log."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs = []
    for pid in range(n):
        cmd = [sys.executable, "-m", "bigdl_tpu_torch.scripts.multihost_smoke",
               "--process-id", str(pid), "--num-processes", str(n),
               "--port", str(port), "--workdir", workdir, "--leg", leg,
               "--end-iter", str(end_iter), "--device", device,
               "--pace", str(pace)]
        if resume:
            cmd.append("--resume")
        if zero2:
            cmd.append("--zero2")
        if init:
            cmd += ["--init", init]
        log = open(os.path.join(workdir, f"proc{pid}.log"), "ab")
        try:
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
        finally:
            log.close()
    return procs


def _reap(procs, timeout: float) -> List[int]:
    """Wait for a job (killing it at `timeout`); its exit codes."""
    deadline = time.time() + timeout
    for p in procs:
        try:
            p.wait(max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    return [p.returncode for p in procs]


def _failed(stage: str, codes: List[int], workdir: str) -> Dict:
    """A failed stage's result, with each failed process's log tail."""
    tails = {}
    for pid, c in enumerate(codes):
        if c != 0:
            with open(os.path.join(workdir, f"proc{pid}.log"),
                      errors="replace") as f:
                tails[pid] = f.read()[-2000:]
    return {"ok": False, "stage": stage, "return_codes": codes,
            "log_tails": tails}


def _collect(workdir: str, n: int) -> List[Dict]:
    out = []
    for pid in range(n):
        with open(os.path.join(workdir, f"proc{pid}.json")) as f:
            out.append(json.load(f))
    return out


def _published(ckdir: str, need_manifest: bool = False) -> List[str]:
    """The published checkpoint dirs, oldest first."""
    names = [d for d in os.listdir(ckdir)
             if re.fullmatch(r"checkpoint-(\d+)", d)
             and (not need_manifest or os.path.exists(
                 os.path.join(ckdir, d, "MANIFEST.json")))]
    return sorted(names, key=lambda d: int(d.split("-")[1]))


def _wait_for(path: str, procs, timeout: float) -> bool:
    """Poll for `path` while every process of the job runs."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        if any(p.poll() is not None for p in procs):
            return False
        time.sleep(0.02)
    return False


def _uninterrupted(n, device, root, timeout, init, zero2=False):
    wd = tempfile.mkdtemp(prefix="multihost_ref_", dir=root)
    codes = _reap(_spawn_group("kill_resume", n, wd, device,
                               end_iter=END_ITER, zero2=zero2, init=init),
                  timeout)
    if any(codes):
        return None, _failed("reference", codes, wd)
    return _collect(wd, n), None


def leg_smoke(device: str = "cuda", n: int = 2, root=None,
              timeout: float = 300, init=None) -> Dict:
    wd = tempfile.mkdtemp(prefix="multihost_smoke_", dir=root)
    codes = _reap(_spawn_group("smoke", n, wd, device, init=init), timeout)
    if any(codes):
        return _failed("smoke", codes, wd)
    digests = [d["digest"] for d in _collect(wd, n)]
    return {"ok": len(set(digests)) == 1, "processes": n,
            "return_codes": codes, "digests": digests, "steps": 6,
            "grad_accum": 2, "checkpoint_resume": True}


def _kill_run(n, device, wd, marker, victim, timeout, init, zero2=False,
              whole_job=False):
    """A paced 12-step job, `victim` SIGKILLed once `marker` exists
    (with `whole_job`, every process at once); the survivors wedge in
    the collective and are reaped. Whether the kill landed while every
    process still trained, and the newest published checkpoint then."""
    procs = _spawn_group("kill_resume", n, wd, device, end_iter=END_ITER,
                         zero2=zero2, pace=PACE, init=init)
    ckdir = os.path.join(wd, "ckpt")
    landed, latest = False, None
    if _wait_for(marker, procs, timeout) \
            and all(p.poll() is None for p in procs):
        for p in (procs if whole_job else [procs[victim]]):
            p.send_signal(signal.SIGKILL)
        landed = True
        latest = _published(ckdir, need_manifest=zero2)[-1]
    # the survivors fail on the closed connection (gloo) or wedge in the
    # collective (NCCL, until its watchdog fires): reap them after a few
    # seconds; a killed job's exit codes do not count
    _reap(procs, KILL_GRACE)
    return landed, latest


def _resume(n, device, wd, timeout, init, zero2=False):
    codes = _reap(_spawn_group("kill_resume", n, wd, device,
                               end_iter=END_ITER, resume=True, zero2=zero2,
                               init=init), timeout)
    if any(codes):
        return None, _failed("resume", codes, wd)
    return _collect(wd, n), None


def _bitwise(ref, res) -> bool:
    shas = {d["sha256"] for d in ref} | {d["sha256"] for d in res}
    return len(shas) == 1


def leg_kill_resume(device: str = "cuda", n: int = 4, root=None,
                    timeout: float = 300, init=None) -> Dict:
    ref, err = _uninterrupted(n, device, root, timeout, init)
    if err:
        return err
    wd = tempfile.mkdtemp(prefix="multihost_kill_", dir=root)
    victim = min(2, n - 1)
    t0 = time.perf_counter()
    landed, latest = _kill_run(
        n, device, wd, os.path.join(wd, "ckpt", "checkpoint-3"), victim,
        timeout, init)
    if not landed:
        return {"ok": False, "stage": "kill",
                "detail": "training finished (or a process exited) before "
                          "the kill could land after checkpoint-3 - no "
                          "mid-training recovery was exercised"}
    res, err = _resume(n, device, wd, timeout, init)
    if err:
        return err
    ok = _bitwise(ref, res)
    return {"ok": ok, "processes": n, "steps": END_ITER,
            "killed_process": victim, "latest_checkpoint_at_kill": latest,
            "resumed_from": res[0]["resumed_from"],
            "digest_uninterrupted": ref[0]["digest"],
            "sha256_uninterrupted": ref[0]["sha256"][:16],
            "sha256_resumed": res[0]["sha256"][:16],
            "bit_identical": ok,
            "interrupted_and_resumed_s": time.perf_counter() - t0}


def leg_ckpt_corrupt(device: str = "cuda", n: int = 4, root=None,
                     timeout: float = 300, init=None) -> Dict:
    ref, err = _uninterrupted(n, device, root, timeout, init)
    if err:
        return err
    wd = tempfile.mkdtemp(prefix="multihost_ckcorrupt_", dir=root)
    ckdir = os.path.join(wd, "ckpt")
    landed, _ = _kill_run(n, device, wd,
                          os.path.join(ckdir, "checkpoint-6"), 0, timeout,
                          init, whole_job=True)
    if not landed:
        return {"ok": False, "stage": "kill",
                "detail": "checkpoint-6 never appeared (or a process "
                          "exited first) - nothing to corrupt"}
    published = _published(ckdir)
    newest, expect_fallback = published[-1], published[-2]
    npz = os.path.join(ckdir, newest, "model.npz")
    with open(npz, "r+b") as f:
        f.truncate(max(os.path.getsize(npz) // 2, 1))
    res, err = _resume(n, device, wd, timeout, init)
    if err:
        return err
    fell_back = all(d["resumed_from"] == expect_fallback
                    and newest in d["corrupt_skipped"] for d in res)
    same = _bitwise(ref, res)
    return {"ok": fell_back and same, "processes": n, "steps": END_ITER,
            "corrupted": newest, "resumed_from": res[0]["resumed_from"],
            "fell_back_on_every_process": fell_back,
            "sha256_uninterrupted": ref[0]["sha256"][:16],
            "sha256_resumed": res[0]["sha256"][:16],
            "bit_identical": same}


def leg_zero2_resume(device: str = "cuda", n: int = 2, root=None,
                     timeout: float = 300, init=None) -> Dict:
    ref, err = _uninterrupted(n, device, root, timeout, init, zero2=True)
    if err:
        return err
    wd = tempfile.mkdtemp(prefix="multihost_z2kill_", dir=root)
    ckdir = os.path.join(wd, "ckpt")
    victim = min(1, n - 1)
    t0 = time.perf_counter()
    # a sharded checkpoint exists once its MANIFEST lands (the
    # manifest-last publish); the dir alone is a torn save
    landed, _ = _kill_run(
        n, device, wd, os.path.join(ckdir, "checkpoint-3", "MANIFEST.json"),
        victim, timeout, init, zero2=True)
    if not landed:
        return {"ok": False, "stage": "kill",
                "detail": "no published sharded checkpoint before the "
                          "job ended - nothing to resume from"}
    published = _published(ckdir, need_manifest=True)
    units = [f for f in os.listdir(os.path.join(ckdir, "checkpoint-3"))
             if f.startswith("optim-shard") and f.endswith(".npz")]
    res, err = _resume(n, device, wd, timeout, init, zero2=True)
    if err:
        return err
    same = _bitwise(ref, res)
    ok = same and len(units) == n
    return {"ok": ok, "processes": n, "steps": END_ITER, "zero": 2,
            "killed_process": victim,
            "sharded_checkpoints_at_kill": published,
            "shard_units_in_first_ckpt": len(units),
            "resumed_from": res[0]["resumed_from"],
            "digest_uninterrupted": ref[0]["digest"],
            "sha256_uninterrupted": ref[0]["sha256"][:16],
            "sha256_resumed": res[0]["sha256"][:16],
            "bit_identical": same,
            "interrupted_and_resumed_s": time.perf_counter() - t0}


LEG_FNS = {"smoke": leg_smoke, "kill_resume": leg_kill_resume,
           "ckpt_corrupt": leg_ckpt_corrupt, "zero2_resume": leg_zero2_resume}


def run_legs(legs, device: str = "cuda", root: Optional[str] = None,
             processes: Optional[int] = None, timeout: float = 300,
             init: Optional[str] = None) -> Dict:
    """Run `legs` (each at its own process count, or at `processes`);
    the artefact: each leg's result under its name, `ok` over all. Each
    leg works in a directory of its own under `root` (by default the
    system's temporary directory), removed once the leg passed; a
    failed leg's is kept, its path under `workdir`."""
    if device == "cuda":
        import torch

        need = processes or max(LEGS[leg] for leg in legs)
        if torch.cuda.device_count() < need:
            raise RuntimeError(f"one card a process: {need} processes, "
                               f"torch sees {torch.cuda.device_count()}")
    result = {}
    for leg in legs:
        t0 = time.perf_counter()
        wd = tempfile.mkdtemp(prefix=f"multihost_{leg}_", dir=root)
        result[leg] = LEG_FNS[leg](device, processes or LEGS[leg],
                                   root=wd, timeout=timeout, init=init)
        result[leg]["seconds"] = time.perf_counter() - t0
        if result[leg]["ok"]:
            shutil.rmtree(wd, ignore_errors=True)
        else:
            result[leg]["workdir"] = wd
    result["ok"] = all(result[leg]["ok"] for leg in legs)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma subset of " + ",".join(LEGS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default: NCCL, one card a process; raises "
                         "with fewer cards) or cpu (gloo)")
    ap.add_argument("--out", default=None,
                    help="where the JSON artefact goes (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--processes", type=int, default=None,
                    help="run every leg at this process count")
    ap.add_argument("--init", default=None,
                    help="npz of initial parameters ('/'-joined tree paths)")
    # child mode
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--leg", default="smoke",
                    choices=["smoke", "kill_resume"])
    ap.add_argument("--end-iter", type=int, default=6)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--zero2", action="store_true")
    ap.add_argument("--pace", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.process_id is not None:
        child(args)
        return 0
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = set(legs) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}")
    result = run_legs(legs, args.device, processes=args.processes,
                      init=args.init)
    out = args.out or os.path.join(tempfile.mkdtemp(prefix="multihost_"),
                                   "multihost.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
